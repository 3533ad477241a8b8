// rmsnorm — row RMSNorm with a float32 reduction
//
//   out[r, :] = cast(x[r, :] * (1 / sqrt(mean(x[r, :]^2) + eps)) * w')
//   w' = 1 + f32(w) when zero-centred (gemma), else f32(w)
//
// x (rows, d) float32 or bfloat16, w (d,) float32 or bfloat16, out (rows,
// d) in x's type; all contiguous. Everything between the loads and the
// final cast is float32.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm (Pallas
// body _rmsnorm_kernel), which tiled (256, d) rows into VMEM and reduced
// in float32 lanes.
//
// What bounds it on this card: bytes. Each row is read once and written
// once; the weight is read once per row but stays in L1/L2. At the
// serving path's widest shape, 4608 rows of gemma2-2b's d = 2304 in
// bfloat16, that is 42.5 MB, about 12.7 us at 3.35 TB/s. Three flops per
// element are nothing beside it.
//
// What the design does about it.
//  * One block of 256 threads per row: neighbouring threads read
//    neighbouring elements, so every pass over the row is coalesced.
//  * The sum of squares is reduced by warp shuffles, then across the
//    eight warps through shared memory; no atomics, so the result does
//    not depend on scheduling.
//  * The second pass reads the row again; at d = 2304 it is 4.6 KB and
//    comes from L1, so device memory sees each byte once.
//  * 1 / sqrtf (both IEEE-rounded without --use_fast_math), not rsqrtf,
//    and (x * r) * w in the reference's order.
//  * bfloat16 is converted only with the intrinsics (__bfloat162float,
//    and __float2bfloat16, round to nearest even).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ out, int d, float eps, int zero_centered) {
  __shared__ float partial[kThreads / 32];
  __shared__ float inv_rms;
  const long long row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* orow = out + row * d;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kThreads / 32 ? partial[threadIdx.x] : 0.0f;
    t = warp_sum(t);
    if (threadIdx.x == 0) inv_rms = 1.0f / sqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();

  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float wi = to_f32(w[i]);
    if (zero_centered) wi = 1.0f + wi;
    orow[i] = from_f32<TX>((to_f32(xr[i]) * r) * wi);
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, long long rows, int d,
            float eps, int zero_centered, cudaStream_t stream) {
  rmsnorm_kernel<TX, TW><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(out), d, eps, zero_centered);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Launch on `stream`; returns
// cudaGetLastError() after the launch (0 = ok). The caller has checked
// shapes, types and contiguity, and that rows and d are non-zero.
extern "C" int rmsnorm(const void* x, const void* w, void* out,
                       long long rows, int d, float eps, int zero_centered,
                       int x_dtype, int w_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    launch<float, float>(x, w, out, rows, d, eps, zero_centered, s);
  else if (x_dtype == 0 && w_dtype == 1)
    launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, zero_centered, s);
  else if (x_dtype == 1 && w_dtype == 0)
    launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, zero_centered, s);
  else if (x_dtype == 1 && w_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps,
                                         zero_centered, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
