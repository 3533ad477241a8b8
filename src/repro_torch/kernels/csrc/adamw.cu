// adamw — one AdamW step over every parameter tensor of a training step:
// the gradients' sums of squares for the global-norm clip, and the update.
//
//   sumsq[t] = sum_i g_t[i]^2                         (one per tensor)
//   g = g * clip
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + ((1 - b2) * g) * g
//   p = p - lr * ((m / b1c) / (sqrt(v / b2c) + eps) + wd * p)
//
// p and g bf16 or float32, each tensor's own; m and v float32; every
// operation between the loads and the cast back in float32.
//
// Replaces no TPU kernel. The reference updates its parameters with plain
// jnp (src/repro/optim/adamw.py:apply_updates), which XLA fuses into a
// few passes a tensor. Eager PyTorch ran the same expressions one
// operation at a time, about 24 float32 passes a tensor and one launch
// each, for every parameter tensor of the step (kernels/adamw.py's plain
// versions keep those expressions).
//
// What bounds it on this card. Bytes: the update reads p, g, m and v and
// writes p, m and v once, 22 B a bf16 parameter (30 B a float32 one); the
// sums of squares read g once more, 2 B. At 3.42 B parameters that is
// 75 GB, 22.5 ms at 3.35 TB/s. The arithmetic, three divisions and a
// square root an element, is far below the bytes.
//
// What the design does about it.
//  * One table for all tensors: a record a tensor (the four addresses,
//    its length, its dtypes and alignment, its first chunk and chunk
//    count) and a chunk table of (tensor, 64-bit element offset) pairs,
//    chunks of kChunk elements (a multiple of 8). Built on the host from
//    shapes and addresses (kernels/adamw.py:chunk_table), copied to the
//    card asynchronously from pinned memory before the launch.
//  * A persistent grid, as many blocks as fit on the card at once, walks
//    the chunks with a grid stride, so the number of launches does not
//    grow with the number of tensors: the update is one launch, the sums
//    of squares two (per-chunk partials, then a per-tensor finish).
//  * 16-byte loads and stores: a thread moves 8 elements at a time (one
//    16-byte load of bf16, two of float32) where the tensor's four
//    addresses are 16-byte aligned; a tensor's last ragged elements, and
//    every element of a misaligned tensor, go one at a time. Loads and
//    stores are streaming (evict-first): each byte is touched once.
//  * The dtypes are template parameters; each chunk takes the
//    instantiation its tensor's flags name, so one launch serves bf16
//    and float32 tensors together.
//
// Exactness. Each operation is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn: never contracted into an FMA, IEEE
// division and square root) in the plain version's order, the constants
// the Python floats rounded to float32 as PyTorch rounds a scalar, and
// clip, lr, b1c and b2c read from the device. So the update is bit for
// bit the plain version's on the card, given the same scalars. The sums
// of squares accumulate in float64 (each square exact in float64) in a
// fixed order: each thread over its own elements, a fixed tree over a
// block, the chunks of a tensor in order; no atomics, so two runs give
// the same bits. They differ from torch.sum's float32 reduction only by
// that sum's own rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                  // elements a vector
// elements a chunk: a multiple of kVec (kernels/adamw.py:CHUNK)
constexpr long long kChunk = 1 << 16;

// flags of a tensor record (kernels/adamw.py keeps the same numbers)
constexpr long long kPBf16 = 1;          // p is bf16 (else float32)
constexpr long long kGBf16 = 2;          // g is bf16 (else float32)
constexpr long long kGVec = 4;           // g 16-byte aligned
constexpr long long kAllVec = 8;         // p, g, m, v 16-byte aligned

struct TensorRec {                       // 8 int64 words
  long long p, g, m, v;                  // addresses (0 where unused)
  long long numel, flags, first_chunk, n_chunks;
};

struct ChunkRec {                        // 2 int64 words
  long long tensor, offset;
};

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float& out, float x) { out = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& out, float x) {
  out = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load8(const float* src, float (&x)[kVec]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(src));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(src) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&x)[kVec]) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[kVec]) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(x[0], x[1], x[2], x[3]));
  __stcs(reinterpret_cast<float4*>(dst) + 1,
         make_float4(x[4], x[5], x[6], x[7]));
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(dst), u);
}

// The plain version's expressions for one element, each operation rounded
// on its own, in its order.
__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v,
                                      float clip, float lr, float b1c,
                                      float b2c, const Consts& c) {
  g = __fmul_rn(g, clip);
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, b2c)), c.eps);
  const float delta = __fadd_rn(__fdiv_rn(__fdiv_rn(m, b1c), den),
                                __fmul_rn(c.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, delta));
}

template <typename P, typename G>
__device__ __forceinline__ void update_chunk(const TensorRec& t,
                                             long long off, int len,
                                             float clip, float lr, float b1c,
                                             float b2c, const Consts& c) {
  P* p = reinterpret_cast<P*>(t.p) + off;
  const G* g = reinterpret_cast<const G*>(t.g) + off;
  float* m = reinterpret_cast<float*>(t.m) + off;
  float* v = reinterpret_cast<float*>(t.v) + off;
  int done = 0;
  if (t.flags & kAllVec) {
    const int nv = len / kVec;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const int e = i * kVec;
      float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
      load8(p + e, pv);
      load8(g + e, gv);
      load8(m + e, mv);
      load8(v + e, vv);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        adam1(pv[j], gv[j], mv[j], vv[j], clip, lr, b1c, b2c, c);
      store8(m + e, mv);
      store8(v + e, vv);
      store8(p + e, pv);
    }
    done = nv * kVec;
  }
  for (int e = done + threadIdx.x; e < len; e += kThreads) {
    float pf = to_f(p[e]), mf = m[e], vf = v[e];
    adam1(pf, to_f(g[e]), mf, vf, clip, lr, b1c, b2c, c);
    m[e] = mf;
    v[e] = vf;
    from_f(p[e], pf);
  }
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const TensorRec* __restrict__ tensors,
              const ChunkRec* __restrict__ chunks, long long n_chunks,
              const float* clip_p, const float* lr_p,
              const float* b1c_p, const float* b2c_p, Consts c) {
  const float clip = *clip_p, lr = *lr_p, b1c = *b1c_p, b2c = *b2c_p;
  for (long long ci = blockIdx.x; ci < n_chunks; ci += gridDim.x) {
    const ChunkRec k = chunks[ci];
    const TensorRec t = tensors[k.tensor];
    const long long rest = t.numel - k.offset;
    const int len = static_cast<int>(rest < kChunk ? rest : kChunk);
    switch (t.flags & (kPBf16 | kGBf16)) {
      case kPBf16 | kGBf16:
        update_chunk<__nv_bfloat16, __nv_bfloat16>(t, k.offset, len, clip, lr,
                                                   b1c, b2c, c);
        break;
      case kPBf16:
        update_chunk<__nv_bfloat16, float>(t, k.offset, len, clip, lr, b1c,
                                           b2c, c);
        break;
      case kGBf16:
        update_chunk<float, __nv_bfloat16>(t, k.offset, len, clip, lr, b1c,
                                           b2c, c);
        break;
      default:
        update_chunk<float, float>(t, k.offset, len, clip, lr, b1c, b2c, c);
    }
  }
}

// Sum of a block's values in a fixed order: a shuffle tree in each warp,
// then the warps' sums in order by thread 0. Returns the sum on thread 0.
__device__ __forceinline__ double block_sum(double x, double* warp_sums) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, w);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  __syncthreads();                       // warp_sums free for the next use
  return s;
}

template <typename G>
__device__ __forceinline__ double sumsq_chunk(const TensorRec& t,
                                              long long off, int len) {
  const G* g = reinterpret_cast<const G*>(t.g) + off;
  double acc = 0.0;
  int done = 0;
  if (t.flags & kGVec) {
    const int nv = len / kVec;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      float gv[kVec];
      load8(g + i * kVec, gv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const double d = gv[j];
        acc += d * d;
      }
    }
    done = nv * kVec;
  }
  for (int e = done + threadIdx.x; e < len; e += kThreads) {
    const double d = to_f(g[e]);
    acc += d * d;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const TensorRec* __restrict__ tensors,
             const ChunkRec* __restrict__ chunks, long long n_chunks,
             double* __restrict__ partial) {
  __shared__ double warp_sums[kThreads / 32];
  for (long long ci = blockIdx.x; ci < n_chunks; ci += gridDim.x) {
    const ChunkRec k = chunks[ci];
    const TensorRec t = tensors[k.tensor];
    const long long rest = t.numel - k.offset;
    const int len = static_cast<int>(rest < kChunk ? rest : kChunk);
    const double acc = (t.flags & kGBf16)
                           ? sumsq_chunk<__nv_bfloat16>(t, k.offset, len)
                           : sumsq_chunk<float>(t, k.offset, len);
    const double s = block_sum(acc, warp_sums);
    if (threadIdx.x == 0) partial[ci] = s;
  }
}

// One block a tensor: the tensor's chunk partials summed in a fixed order.
__global__ void __launch_bounds__(kThreads)
sumsq_finish_kernel(const TensorRec* __restrict__ tensors,
                    long long n_tensors, const double* __restrict__ partial,
                    float* __restrict__ out) {
  __shared__ double warp_sums[kThreads / 32];
  for (long long ti = blockIdx.x; ti < n_tensors; ti += gridDim.x) {
    const TensorRec t = tensors[ti];
    double acc = 0.0;
    for (long long i = threadIdx.x; i < t.n_chunks; i += kThreads)
      acc += partial[t.first_chunk + i];
    const double s = block_sum(acc, warp_sums);
    if (threadIdx.x == 0) out[ti] = static_cast<float>(s);
  }
}

// Blocks of `kernel` that fit on the current device at once, at least 1.
template <typename K>
int persistent_blocks(K kernel, int* err) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  *err = static_cast<int>(e);
  const int n = sms * per_sm;
  return n > 0 ? n : 1;
}

int grid_for(long long n, int blocks) {
  return static_cast<int>(n < blocks ? n : blocks);
}

}  // namespace

// The table: n_tensors records of 8 int64 words, then n_chunks records of
// 2 (kernels/adamw.py:table_words), on the device. Every launch below is
// on `stream` and returns cudaGetLastError() after it (0 = ok); the
// caller has checked dtypes, lengths, contiguity and alignment flags, and
// that n_tensors and n_chunks are non-zero.

// Sums of squares of the g of each tensor: `partial` (n_chunks float64
// scratch) then `out` (n_tensors float32).
extern "C" int adamw_grad_sumsq(const void* table, long long n_tensors,
                                long long n_chunks, void* partial, void* out,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* tensors = static_cast<const TensorRec*>(table);
  const auto* chunks = reinterpret_cast<const ChunkRec*>(tensors + n_tensors);
  auto* part = static_cast<double*>(partial);
  int err = 0;
  const int blocks = persistent_blocks(sumsq_kernel, &err);
  if (err) return err;
  sumsq_kernel<<<grid_for(n_chunks, blocks), kThreads, 0, s>>>(
      tensors, chunks, n_chunks, part);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  sumsq_finish_kernel<<<grid_for(n_tensors, 65535), kThreads, 0, s>>>(
      tensors, n_tensors, part, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The update of p, m and v of every tensor, in place. clip, lr, b1c and
// b2c are float32 scalars on the device; the rest are the Python floats
// rounded to float32 (omb1 = 1 - b1 and omb2 = 1 - b2 rounded from their
// float64 values).
extern "C" int adamw_update(const void* table, long long n_tensors,
                            long long n_chunks, const void* clip,
                            const void* lr, const void* b1c, const void* b2c,
                            float b1, float omb1, float b2, float omb2,
                            float eps, float wd, void* stream) {
  const auto* tensors = static_cast<const TensorRec*>(table);
  const auto* chunks = reinterpret_cast<const ChunkRec*>(tensors + n_tensors);
  int err = 0;
  const int blocks = persistent_blocks(update_kernel, &err);
  if (err) return err;
  update_kernel<<<grid_for(n_chunks, blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      tensors, chunks, n_chunks, static_cast<const float*>(clip),
      static_cast<const float*>(lr), static_cast<const float*>(b1c),
      static_cast<const float*>(b2c), Consts{b1, omb1, b2, omb2, eps, wd});
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
