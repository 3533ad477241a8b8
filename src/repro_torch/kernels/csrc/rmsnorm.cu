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
//  * 16-byte loads and stores: a thread moves 8 bfloat16 or 4 float32
//    elements of x, w and out at once, so a warp's load is 512 bytes.
//  * One read: a thread keeps its slice of the row in registers (at most
//    4 vectors, 32 bf16 or 16 float32 elements) from the sum of squares
//    to the scaled write, so device memory sees each byte of x once.
//  * Threads per row sized by d: the fewest of 32, 64, ..., 1024 that
//    hold the row in 4 vectors each (bf16: a warp up to d = 1024, 64
//    threads at 1536, 128 at 2304, 3072 and 3584, 256 at 7168), and
//    128-thread blocks hold 128 / that many rows (wider rows take a block
//    each), so a 4,000-row prefill fills the card in small blocks and a
//    1-4-row decode call is one short launch. Of 128, 256 and 512 threads
//    per block and 2, 4 and 8 vectors per thread, 128 and 4 were the
//    fastest pair at the serving path's widths on an H100.
//  * The sum of squares is reduced by warp shuffles, then across the
//    row's warps through shared memory, in a fixed order; no atomics, so
//    the result does not depend on scheduling.
//  * A scalar path (one 128-thread block per row, two passes, the second
//    from L1) takes what the vector path cannot: d not a multiple of the
//    vector, a pointer not 16-byte aligned, or a row longer than 1024
//    threads x 4 vectors.
//  * 1 / sqrtf (both IEEE-rounded without --use_fast_math), not rsqrtf,
//    and (x * r) * w' in the reference's order, on both paths.
//  * bfloat16 is converted only with the intrinsics (__bfloat162float,
//    and __float2bfloat16, round to nearest even).

#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // threads per block (both paths)
constexpr int kMaxVecs = 4;        // 16-byte vectors a thread holds
constexpr int kMaxRowThreads = 1024;
constexpr int kMaxBwdWidth = 56000;  // the backward's scalar path: d float32

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

// ---------------------------------------------------------------------------
// vector path
// ---------------------------------------------------------------------------

// n elements of T at p (n * sizeof(T) is 8, 16 or 32 bytes, p aligned to
// it or to 16) as float32
template <typename T, int n>
__device__ __forceinline__ void load_f32(const T* p, float (&f)[n]) {
  constexpr int kBytes = n * static_cast<int>(sizeof(T));
  T tmp[n];
  if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    memcpy(tmp, &raw, 8);
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
      memcpy(reinterpret_cast<char*>(tmp) + 16 * i, &raw, 16);
    }
  }
#pragma unroll
  for (int i = 0; i < n; ++i) f[i] = to_f32(tmp[i]);
}

// kTpr threads per row, kThreads / kTpr rows per block (one row per block
// when kTpr > kThreads); V elements of x per 16-byte vector.
template <typename TX, typename TW, int kTpr>
__global__ void __launch_bounds__(kTpr > kThreads ? kTpr : kThreads)
rmsnorm_vec_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TX* __restrict__ out, long long rows, int d, float eps,
                   int zero_centered) {
  constexpr int V = 16 / static_cast<int>(sizeof(TX));
  constexpr int kBlock = kTpr > kThreads ? kTpr : kThreads;
  constexpr int kRows = kBlock / kTpr;
  constexpr int kWarps = kTpr / 32;
  __shared__ float partial[kRows][kWarps];
  const int group = threadIdx.x / kTpr;
  const int lane = threadIdx.x % kTpr;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + group;
  const bool live = row < rows;
  const int nv = d / V;
  const TX* xr = x + row * d;

  float xv[kMaxVecs][V];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int vi = lane + i * kTpr;
    if (live && vi < nv) {
      load_f32<TX, V>(xr + vi * V, xv[i]);
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(xv[i][e], xv[i][e], ss);
    }
  }
  ss = warp_sum(ss);
  if constexpr (kWarps > 1) {
    if (threadIdx.x % 32 == 0) partial[group][lane / 32] = ss;
    __syncthreads();
    ss = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) ss += partial[group][i];
  }
  if (!live) return;
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

  TX* orow = out + row * d;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int vi = lane + i * kTpr;
    if (vi < nv) {
      float wv[V];
      load_f32<TW, V>(w + vi * V, wv);
      TX o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float wi = zero_centered ? 1.0f + wv[e] : wv[e];
        o[e] = from_f32<TX>((xv[i][e] * r) * wi);
      }
      uint4 raw;
      memcpy(&raw, o, 16);
      *reinterpret_cast<uint4*>(orow + vi * V) = raw;
    }
  }
}

// ---------------------------------------------------------------------------
// scalar path
// ---------------------------------------------------------------------------

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_scalar_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      TX* __restrict__ out, int d, float eps,
                      int zero_centered) {
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
    if (threadIdx.x == 0)
      inv_rms = 1.0f / sqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();

  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float wi = to_f32(w[i]);
    if (zero_centered) wi = 1.0f + wi;
    orow[i] = from_f32<TX>((to_f32(xr[i]) * r) * wi);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Threads per row of the vector path for a row of d elements of TX, or 0
// when only the scalar path can take it.
template <typename TX> int row_threads(int d) {
  constexpr int V = 16 / static_cast<int>(sizeof(TX));
  if (d % V) return 0;
  const int nv = d / V;
  for (int tpr = 32; tpr <= kMaxRowThreads; tpr *= 2)
    if (nv <= tpr * kMaxVecs) return tpr;
  return 0;
}

template <typename TX, typename TW, int kTpr>
void launch_vec(const void* x, const void* w, void* out, long long rows,
                int d, float eps, int zero_centered, cudaStream_t stream) {
  constexpr int kBlock = kTpr > kThreads ? kTpr : kThreads;
  constexpr int kRows = kBlock / kTpr;
  const long long blocks = (rows + kRows - 1) / kRows;
  rmsnorm_vec_kernel<TX, TW, kTpr>
      <<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<TX*>(out), rows, d, eps, zero_centered);
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, long long rows, int d,
            float eps, int zero_centered, cudaStream_t stream) {
  const int tpr = aligned16(x) && aligned16(w) && aligned16(out)
                      ? row_threads<TX>(d) : 0;
  switch (tpr) {
    case 32:
      return launch_vec<TX, TW, 32>(x, w, out, rows, d, eps, zero_centered,
                                    stream);
    case 64:
      return launch_vec<TX, TW, 64>(x, w, out, rows, d, eps, zero_centered,
                                    stream);
    case 128:
      return launch_vec<TX, TW, 128>(x, w, out, rows, d, eps, zero_centered,
                                     stream);
    case 256:
      return launch_vec<TX, TW, 256>(x, w, out, rows, d, eps, zero_centered,
                                     stream);
    case 512:
      return launch_vec<TX, TW, 512>(x, w, out, rows, d, eps, zero_centered,
                                     stream);
    case 1024:
      return launch_vec<TX, TW, 1024>(x, w, out, rows, d, eps,
                                      zero_centered, stream);
    default:
      rmsnorm_scalar_kernel<TX, TW>
          <<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
              static_cast<const TX*>(x), static_cast<const TW*>(w),
              static_cast<TX*>(out), d, eps, zero_centered);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
//
//   x^ = x r,  r = 1 / sqrt(mean(x^2) + eps)
//   dx = (w' dy - x^ mean(x^ w' dy)) r          (one pass per row)
//   dw = sum over rows of dy x^                 (two launches)
//
// This is what the reference gets from autodiff of layers.rms_norm; there
// is no Pallas backward kernel. Bytes bound it, as the forward: x and dy
// read once, dx written once (at gemma2-2b's training shape, 2 x 1024 rows
// of 2304 bf16, 28.3 MB: 0.0085 ms at 3.35 TB/s), w read and dw written
// once; the partials of dw (one row of d float32 per block, 264 rows at
// the path's widths) stay in the 50 MB L2.
//
// Vector path (rmsnorm_bwd_vec_kernel, the forward's layout):
//  * Threads per row by width, as the forward's row_threads: the fewest of
//    32, ..., 512 that hold the row in 4 vectors of 16 bytes each, so x
//    and dy are read once, with 16-byte loads, and kept in registers from
//    the row sums to dx (bf16: 64 threads at 1280-2048, 128 at 2304-4096,
//    256 at 7168; float32 twice as many).
//  * w' (1 + w when zero-centred) loaded once per block: a thread keeps
//    the same columns for every row of its block, so its dw sums stay in
//    registers too.
//  * 256-thread blocks (one or more rows each), as many as fill the card
//    (the occupancy calculator's blocks per SM x SMs: two an SM at the
//    path's widths, or fewer when the rows run out); each takes rows
//    blockIdx, blockIdx + grid, ... of its row group. One __syncthreads
//    per row (the two row sums through a double-buffered shared array),
//    none when a warp holds the row.
//  * At the end the block folds its row groups' dw sums in order and
//    writes one partial row, 16 bytes a store.
//  * rmsnorm_bwd_cols_kernel: 32 columns x 16 slices of the partials a
//    block, each slice summed in a fixed order (four running sums), then
//    the 16 in order, cast to w's type: parallel over columns and over
//    the partials. (One cooperative launch with a grid-wide sync before
//    the column sums measured 0.0202-0.0203 ms at gemma2's shape against
//    the two launches' 0.0193: not kept.)
// Scalar path (what the vector path cannot take: d not a multiple of the
// vector, a pointer not 16-byte aligned, rows wider than 512 threads x 4
// vectors): one 256-thread block per partial, 256 at most, rows p, p + P,
// ... each, the row read twice (sums, then dx) and dw summed in shared
// memory (d float32), then the same column kernel.
//  * No atomics on either path: two launches give equal bits.
//  * The shared-memory attribute of the scalar path is set once per
//    instantiation and device; the occupancy of the vector path is asked
//    once likewise.

constexpr int kBwdThreads = 256;             // scalar path
constexpr int kBwdMaxBlocks = 256;            // scalar path
constexpr int kBwdVecThreads = 256;           // vector path, a block
constexpr int kBwdMaxRowThreads = 512;        // vector path, a row
constexpr int kColSlices = 16;

// threads of a vector-path block at kTpr threads per row: 256, or one
// row when that is wider
template <int kTpr> __host__ __device__ constexpr int bwd_block() {
  return kTpr > kBwdVecThreads ? kTpr : kBwdVecThreads;
}
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float2* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 t = lane < kBwdThreads / 32 ? scratch[lane] : make_float2(0, 0);
    t.x = warp_sum(t.x);
    t.y = warp_sum(t.y);
    if (lane == 0) scratch[kBwdThreads / 32] = t;
  }
  __syncthreads();
  const float2 out = scratch[kBwdThreads / 32];
  __syncthreads();                   // scratch is reused by the next row
  return out;
}

// dw[c] for the 32 columns c0 = 32 blockIdx .. c0 + 31: the sum of the
// n_parts partials of each column in a fixed order, by 32 x kColSlices
// threads: slice y sums partials y, y + S, ... (four running sums, so
// four loads are in flight, added in order), then the S slices are summed
// in order.
template <typename TW>
__global__ void __launch_bounds__(32 * kColSlices)
rmsnorm_bwd_cols_kernel(const float* __restrict__ partials,
                        TW* __restrict__ dw, int n_parts, int d) {
  constexpr int S = kColSlices;
  __shared__ float part[S * 33];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (c < d) {
    int p = slice;
    for (; p + 3 * S < n_parts; p += 4 * S)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] += partials[static_cast<long long>(p + u * S) * d + c];
    for (; p < n_parts; p += S)
      acc[0] += partials[static_cast<long long>(p) * d + c];
  }
  part[slice * 33 + lane] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  __syncthreads();
  if (slice == 0 && c < d) {
    float t = 0.0f;
    for (int i = 0; i < S; ++i) t += part[i * 33 + lane];
    dw[c] = from_f32<TW>(t);
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_rows_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        const TX* __restrict__ dy, TX* __restrict__ dx,
                        float* __restrict__ partials, long long rows, int d,
                        float eps, int zero_centered) {
  extern __shared__ float dw_acc[];            // d column sums
  __shared__ float2 scratch[kBwdThreads / 32 + 1];
  for (int c = threadIdx.x; c < d; c += kBwdThreads) dw_acc[c] = 0.0f;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const TX* xr = x + row * d;
    const TX* gr = dy + row * d;
    float ss = 0.0f, g = 0.0f;
    for (int c = threadIdx.x; c < d; c += kBwdThreads) {
      const float xv = to_f32(xr[c]);
      float wv = to_f32(w[c]);
      if (zero_centered) wv = 1.0f + wv;
      ss = fmaf(xv, xv, ss);
      g = fmaf(xv * wv, to_f32(gr[c]), g);
    }
    const float2 sums = block_sum2(ss, g, scratch);
    const float r = 1.0f / sqrtf(sums.x / static_cast<float>(d) + eps);
    const float mean = sums.y * r / static_cast<float>(d);   // of x^ w' dy
    TX* dxr = dx + row * d;
    for (int c = threadIdx.x; c < d; c += kBwdThreads) {
      const float xh = to_f32(xr[c]) * r;
      float wv = to_f32(w[c]);
      if (zero_centered) wv = 1.0f + wv;
      const float gv = to_f32(gr[c]);
      dxr[c] = from_f32<TX>((wv * gv - xh * mean) * r);
      dw_acc[c] = fmaf(gv, xh, dw_acc[c]);
    }
  }
  float* out = partials + static_cast<long long>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += kBwdThreads) out[c] = dw_acc[c];
}

// the V = 16 / sizeof(T) elements of one 16-byte vector as float32
template <typename T, int n>
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[n]) {
  T tmp[n];
  memcpy(tmp, &raw, 16);
#pragma unroll
  for (int i = 0; i < n; ++i) f[i] = to_f32(tmp[i]);
}

// kTpr threads per row, bwd_block / kTpr row groups a block; V elements of
// x per 16-byte vector, thread `lane` of a row holding vectors lane,
// lane + kTpr, ... (at most kMaxVecs).
template <typename TX, typename TW, int kTpr>
__global__ void __launch_bounds__(bwd_block<kTpr>())
rmsnorm_bwd_vec_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                       const TX* __restrict__ dy, TX* __restrict__ dx,
                       float* __restrict__ partials, long long rows, int d,
                       float eps, int zero_centered) {
  constexpr int V = 16 / static_cast<int>(sizeof(TX));
  constexpr int kRows = bwd_block<kTpr>() / kTpr;
  constexpr int kWarps = kTpr / 32;
  __shared__ float2 sums[2][kRows][kWarps];
  __shared__ __align__(16) float stage[kRows > 1 ? kTpr * kMaxVecs * V : 4];
  const int group = threadIdx.x / kTpr;
  const int lane = threadIdx.x % kTpr;
  const int nv = d / V;

  float wv[kMaxVecs][V], acc[kMaxVecs][V];
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int vi = lane + i * kTpr;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.0f;
    if (vi < nv) {
      load_f32<TW, V>(w + vi * V, wv[i]);
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (zero_centered) wv[i][e] += 1.0f;
    }
  }

  int parity = 0;
  for (long long base = static_cast<long long>(blockIdx.x) * kRows;
       base < rows; base += static_cast<long long>(gridDim.x) * kRows) {
    const long long row = base + group;
    const bool live = row < rows;
    const TX* xr = x + row * d;
    const TX* gr = dy + row * d;
    uint4 xraw[kMaxVecs], graw[kMaxVecs];    // the row's slice, as loaded
    float ss = 0.0f, g = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i) {
      const int vi = lane + i * kTpr;
      if (live && vi < nv) {
        xraw[i] = *reinterpret_cast<const uint4*>(xr + vi * V);
        graw[i] = *reinterpret_cast<const uint4*>(gr + vi * V);
        float xv[V], gv[V];
        unpack<TX>(xraw[i], xv);
        unpack<TX>(graw[i], gv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          ss = fmaf(xv[e], xv[e], ss);
          g = fmaf(xv[e] * wv[i][e], gv[e], g);
        }
      }
    }
    ss = warp_sum(ss);
    g = warp_sum(g);
    if constexpr (kWarps > 1) {
      if (threadIdx.x % 32 == 0)
        sums[parity][group][lane / 32] = make_float2(ss, g);
      __syncthreads();
      ss = 0.0f;
      g = 0.0f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        ss += sums[parity][group][i].x;
        g += sums[parity][group][i].y;
      }
      parity ^= 1;
    }
    if (!live) continue;
    const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
    const float mean = g * r / static_cast<float>(d);        // of x^ w' dy
    TX* dxr = dx + row * d;
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i) {
      const int vi = lane + i * kTpr;
      if (vi < nv) {
        float xv[V], gv[V];
        unpack<TX>(xraw[i], xv);
        unpack<TX>(graw[i], gv);
        TX o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = xv[e] * r;
          o[e] = from_f32<TX>((wv[i][e] * gv[e] - xh * mean) * r);
          acc[i][e] = fmaf(gv[e], xh, acc[i][e]);
        }
        uint4 raw;
        memcpy(&raw, o, 16);
        *reinterpret_cast<uint4*>(dxr + vi * V) = raw;
      }
    }
  }

  // fold the row groups' sums into group 0's, in group order
  for (int src = 1; src < kRows; ++src) {
    __syncthreads();
    if (group == src) {
#pragma unroll
      for (int i = 0; i < kMaxVecs; ++i) {
        const int vi = lane + i * kTpr;
        if (vi < nv)
#pragma unroll
          for (int e = 0; e < V; ++e) stage[vi * V + e] = acc[i][e];
      }
    }
    __syncthreads();
    if (group == 0) {
#pragma unroll
      for (int i = 0; i < kMaxVecs; ++i) {
        const int vi = lane + i * kTpr;
        if (vi < nv)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[i][e] += stage[vi * V + e];
      }
    }
  }
  if (group != 0) return;
  float* out = partials + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int vi = lane + i * kTpr;
    if (vi < nv)
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(out + vi * V + e) =
            make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2],
                        acc[i][e + 3]);
  }
}

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev < kMaxDevices ? dev : kMaxDevices - 1;
}

int sm_count() {
  static int sms[kMaxDevices] = {};
  const int dev = current_device();
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 1;
}

// Threads per row of the backward's vector path (0: the scalar path)
template <typename TX> int bwd_row_threads(int d) {
  const int tpr = row_threads<TX>(d);
  return tpr <= kBwdMaxRowThreads ? tpr : 0;
}

// Blocks of the vector path at kTpr: what fills the card, or one per row
// group when the rows run out.
template <typename TX, typename TW, int kTpr>
int vec_blocks(long long rows) {
  constexpr int kRows = bwd_block<kTpr>() / kTpr;
  static int per_sm[kMaxDevices] = {};
  const int dev = current_device();
  if (per_sm[dev] == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rmsnorm_bwd_vec_kernel<TX, TW, kTpr>, bwd_block<kTpr>(), 0);
    per_sm[dev] = n > 0 ? n : 1;
  }
  const long long full = static_cast<long long>(per_sm[dev]) * sm_count();
  const long long groups = (rows + kRows - 1) / kRows;
  return static_cast<int>(groups < full ? groups : full);
}

template <typename TX, typename TW>
int bwd_parts(long long rows, int d, bool aligned) {
  switch (aligned ? bwd_row_threads<TX>(d) : 0) {
    case 32: return vec_blocks<TX, TW, 32>(rows);
    case 64: return vec_blocks<TX, TW, 64>(rows);
    case 128: return vec_blocks<TX, TW, 128>(rows);
    case 256: return vec_blocks<TX, TW, 256>(rows);
    case 512: return vec_blocks<TX, TW, 512>(rows);
    default:
      return static_cast<int>(rows < kBwdMaxBlocks ? rows : kBwdMaxBlocks);
  }
}

template <typename TX, typename TW, int kTpr>
void launch_bwd_vec(const void* x, const void* w, const void* dy, void* dx,
                    float* partials, int parts, long long rows, int d,
                    float eps, int zero_centered, cudaStream_t stream) {
  rmsnorm_bwd_vec_kernel<TX, TW, kTpr>
      <<<parts, bwd_block<kTpr>(), 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<const TX*>(dy), static_cast<TX*>(dx), partials, rows,
          d, eps, zero_centered);
}

// the scalar path's shared memory, allowed once per instantiation and
// device up to the widest row it takes
template <typename TX, typename TW>
cudaError_t allow_bwd_rows_shared() {
  static bool done[kMaxDevices] = {};
  const int dev = current_device();
  if (done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_bwd_rows_kernel<TX, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * kMaxBwdWidth));
  done[dev] = err == cudaSuccess;
  return err;
}

template <typename TX, typename TW>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               void* dw, float* partials, int parts, long long rows, int d,
               float eps, int zero_centered, cudaStream_t stream) {
  const bool aligned = aligned16(x) && aligned16(w) && aligned16(dy) &&
                       aligned16(dx) && aligned16(partials);
  if (parts != bwd_parts<TX, TW>(rows, d, aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (aligned ? bwd_row_threads<TX>(d) : 0) {
    case 32:
      launch_bwd_vec<TX, TW, 32>(x, w, dy, dx, partials, parts, rows, d, eps,
                                 zero_centered, stream);
      break;
    case 64:
      launch_bwd_vec<TX, TW, 64>(x, w, dy, dx, partials, parts, rows, d, eps,
                                 zero_centered, stream);
      break;
    case 128:
      launch_bwd_vec<TX, TW, 128>(x, w, dy, dx, partials, parts, rows, d,
                                  eps, zero_centered, stream);
      break;
    case 256:
      launch_bwd_vec<TX, TW, 256>(x, w, dy, dx, partials, parts, rows, d,
                                  eps, zero_centered, stream);
      break;
    case 512:
      launch_bwd_vec<TX, TW, 512>(x, w, dy, dx, partials, parts, rows, d,
                                  eps, zero_centered, stream);
      break;
    default: {
      const cudaError_t err = allow_bwd_rows_shared<TX, TW>();
      if (err != cudaSuccess) return static_cast<int>(err);
      rmsnorm_bwd_rows_kernel<TX, TW>
          <<<parts, kBwdThreads, sizeof(float) * static_cast<size_t>(d),
             stream>>>(static_cast<const TX*>(x), static_cast<const TW*>(w),
                       static_cast<const TX*>(dy), static_cast<TX*>(dx),
                       partials, rows, d, eps, zero_centered);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_cols_kernel<TW><<<(d + 31) / 32, 32 * kColSlices, 0,
                                stream>>>(partials, static_cast<TW*>(dw),
                                          parts, d);
  return static_cast<int>(cudaGetLastError());
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

// Threads per row the vector path gives a row of d elements of dtype code
// x_dtype when the pointers are aligned (0: the scalar path).
extern "C" int rmsnorm_row_threads(int d, int x_dtype) {
  return x_dtype == 0 ? row_threads<float>(d) : row_threads<__nv_bfloat16>(d);
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows of dw partials the backward writes for `rows` rows of d elements
// (dtype codes as rmsnorm; aligned: x, w, dy, dx and the partials all
// 16-byte aligned). The wrapper allocates partials of that many rows of
// d float32.
extern "C" int rmsnorm_bwd_blocks(long long rows, int d, int x_dtype,
                                  int w_dtype, int aligned) {
  const bool a = aligned != 0;
  if (x_dtype == 0)
    return w_dtype == 0 ? bwd_parts<float, float>(rows, d, a)
                        : bwd_parts<float, __nv_bfloat16>(rows, d, a);
  return w_dtype == 0 ? bwd_parts<__nv_bfloat16, float>(rows, d, a)
                      : bwd_parts<__nv_bfloat16, __nv_bfloat16>(rows, d, a);
}

// Threads per row of the backward's vector path for a row of d elements
// of dtype code x_dtype with aligned pointers (0: the scalar path).
extern "C" int rmsnorm_bwd_row_threads(int d, int x_dtype) {
  return x_dtype == 0 ? bwd_row_threads<float>(d)
                      : bwd_row_threads<__nv_bfloat16>(d);
}

// The backward: dx (rows, d) in x's type and dw (d,) in w's type from x,
// w and dy (dy in x's type), with `partials` (rmsnorm_bwd_blocks rows of
// d float32, `parts`) as scratch. Two launches on `stream`; returns the
// first CUDA error (0 = ok; cudaErrorInvalidValue when `parts` is not what
// rmsnorm_bwd_blocks gives these pointers). The caller has checked shapes,
// types and contiguity, and that rows and d are non-zero; d at most
// 56,000 (the scalar path's float32 column sums fill a block's shared
// memory).
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, float* partials, int parts,
                           long long rows, int d, float eps,
                           int zero_centered, int x_dtype, int w_dtype,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_bwd<float, float>(x, w, dy, dx, dw, partials, parts, rows,
                                    d, eps, zero_centered, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(x, w, dy, dx, dw, partials,
                                            parts, rows, d, eps,
                                            zero_centered, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(x, w, dy, dx, dw, partials,
                                            parts, rows, d, eps,
                                            zero_centered, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, w, dy, dx, dw, partials, parts, rows, d, eps, zero_centered, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
