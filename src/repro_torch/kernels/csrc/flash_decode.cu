// flash_decode — one new query token against a KV cache, split over the
// cache length (FlashDecoding, arXiv:2311.01282)
//
//   out[b, h] = sum_t p_t v[b, t, h / G] / sum_t p_t over the valid slots,
//   p_t = exp(s_t - max), s_t = cap * tanh((scale * q[b, h]) . k[b, t, h / G] / cap)
//
// q (B, Hq, D), k_cache (B, T, Hkv, D), v_cache (B, T, Hkv, Dv), out (B,
// Hq, Dv), all float32 or all bfloat16 and contiguous; pos (B,) int32;
// G = Hq / Hkv. Slot t is valid iff t < pos[b] + 1 (a linear cache) or
// t < min(pos[b] + 1, T) (a ring buffer: slot order does not matter
// because RoPE was applied at insert). Scores, max, sums and the
// accumulator are float32.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:flash_decode
// (Pallas body _decode_kernel), which walked the cache's KV blocks as the
// sequential minor axis of its grid, carrying (m, l, acc) in VMEM.
//
// What bounds it on this card: bytes. Every valid K and V slot is read
// once and does 4 * D flops per q head sharing it (G = 2 for gemma2-2b, 1
// for zamba2-7b), far below the 295 flops per byte where the tensor cores
// would become the limit. At gemma2-2b's run-B shape (q (1, 8, 256), cache
// (1, 4624, 4, 256), bf16) that is 18.9 MB per call, 5.6 us at 3.35 TB/s.
// Reaching that needs about 25 KB in flight on each of the 132 SMs.
//
// What the design does about it.
//  * A split rule that fills the card (kernels/flash_decode.py:
//    decode_plan, by shape): each (b, kv head) pair's T slots are cut
//    into `splits` contiguous ranges of `chunk` slots, with splits x B x
//    Hkv about the blocks the card holds at once (2 x 132 where two fit
//    an SM), and each range at least one tile. One block of 256 threads
//    takes one range for the kv head's G q heads (at most 4 per block; a
//    larger G is cut into chunks of 4, each its own block), so K and V
//    are read once for the group.
//  * 16-byte loads and a ring of tiles. The block streams its range in
//    tiles of 32 slots through a 3-stage ring in shared memory, copied
//    with cp.async.cg 16 bytes a lane (one warp-wide copy moves a 256-wide
//    bf16 row). All three stages are issued before anything else (a range
//    of the paths' shapes is 2-6 tiles, so most of it is in flight at
//    once); each tile consumed frees its stage for the tile three ahead.
//    A D or Dv that is not a multiple of the 16-byte vector, or an input
//    that is not 16-byte aligned, takes a plain-load copy into the same
//    zero-padded layout (the masked tail).
//  * Each warp owns 4 slots of every tile and runs its own online softmax
//    over them, so a tile costs one block barrier (the ring's). Scoring:
//    each K row is split over 8 lanes, each lane holding its 32 elements
//    of scale * q for every head of the block in registers, so a dot
//    product needs 3 shuffle steps; the tile's max and sum over the
//    warp's slots 2 more. P·V: each lane owns 8 (bf16) or 4 + 4 (float32)
//    contiguous Dv columns, reads them from the V tile with 16-byte loads
//    and accumulates every head in float32 registers. At the end of the
//    range the 8 warps' (max, sum, accumulator) are merged in warp order.
//  * Blocks wholly past pos + 1 exit without reading the cache and write
//    nothing; the combine skips their ranges.
//  * Combine: a second, small launch, one block of 4 warps per (b, q
//    head, 32 columns), rescales the ranges' partials (max, sum,
//    accumulator) to their common max. Warp w sums ranges w, w + 4, ...
//    in order, the four sums are added in warp order and the denominator
//    in a fixed tree, so the result is bitwise the same on every launch;
//    no atomics.
//  * Slot ranges of a cache split over ranks (tensor-parallel decode):
//    with an lse pointer the combine writes its output in float32 (a
//    partial, rounded once only after the ranges are merged) and each
//    row's float32 log-sum-exp of the scaled scores, max + log(sum), from
//    the (max, sum) it already holds, so the caller can merge ranges it
//    ran apart.
//    pos[b] = -1 is a row with no valid slot: every split block exits
//    before reading the cache, the combine gives out 0 and lse -inf.
//    Without the pointer nothing of the launch or its arithmetic changes.
//  * Host work per call: the shared-memory opt-in is set once per process
//    and device; one workspace (the partials) is allocated by the caller.
//  * Scale, softcap and mask are applied in float32 before the exp, with
//    the reference's -2e38 for masked scores; bfloat16 is converted only
//    with the intrinsics; no --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;           // cache slots per tile
constexpr int kSlotsPerWarp = kTile / kWarps;   // 4: one slot per 8 lanes
constexpr int kStages = 3;          // ring depth
constexpr int kMaxD = 256;          // largest head dim
constexpr int kQ = kMaxD / 8;       // q floats per lane per head (8 lanes a row)
constexpr int kCombineThreads = 128;    // 4 warps x 32 columns
constexpr int kCombineWarps = kCombineThreads / 32;
constexpr int kCombineCols = 32;
constexpr int kMaxShared = 232448;  // a block's opt-in on sm_90
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -2.0e38f;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

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

// 16 bytes of shared memory as floats
__device__ __forceinline__ void unpack(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void unpack(const __nv_bfloat16* p,
                                       float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of one split block, in this order: the ring of kStages
// (K tile, V tile) pairs in the cache's type, each row padded to the
// 16-byte vector (after the last tile the same bytes hold the warps'
// float accumulators, whichever is larger), then each warp's running max
// and sum per head (kWarps x gr x 2 floats). Both candidates of the first
// region are multiples of 16 bytes (rows are padded to the vector).
// kernels/flash_decode.py:decode_shared_bytes sizes it the same way; the
// launch refuses a plan whose bytes differ.
__host__ __device__ __forceinline__ long long region0_bytes(int D, int Dv,
                                                            int gr,
                                                            int itemsize) {
  const int vec = 16 / itemsize;
  const int dp = round_up(D, vec), dvp = round_up(Dv, vec);
  const long long ring = 1LL * kStages * kTile * (dp + dvp) * itemsize;
  const long long buf = 4LL * kWarps * gr * dvp;
  return ring > buf ? ring : buf;
}

long long shared_bytes(int D, int Dv, int gr, int itemsize) {
  return region0_bytes(D, Dv, gr, itemsize) + 8LL * kWarps * gr;
}

// Copy slots [0, nt) of a tile: K rows to ks (row stride Dp), V rows to
// vs (stride Dvp). Rows of the cache are kstride / vstride elements
// apart. Aligned: cp.async of 16-byte chunks; else element loads with
// the padding zeroed (q's padding is zero, so a K tail must be finite).
template <typename T, bool kAligned>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kg,
                                          const T* vg, long long kstride,
                                          long long vstride, int nt, int D,
                                          int Dv, int Dp, int Dvp) {
  constexpr int VEC = Vec<T>::n;
  const int tid = threadIdx.x;
  if constexpr (kAligned) {
    const int ck = D / VEC, cv = Dv / VEC;
    for (int i = tid; i < nt * ck; i += kThreads) {
      const int j = i / ck, c = i - j * ck;
      cp_async16(ks + j * Dp + c * VEC, kg + j * kstride + c * VEC);
    }
    for (int i = tid; i < nt * cv; i += kThreads) {
      const int j = i / cv, c = i - j * cv;
      cp_async16(vs + j * Dvp + c * VEC, vg + j * vstride + c * VEC);
    }
  } else {
    for (int i = tid; i < nt * Dp; i += kThreads) {
      const int j = i / Dp, d = i - j * Dp;
      ks[i] = d < D ? kg[j * kstride + d] : from_f32<T>(0.0f);
    }
    for (int i = tid; i < nt * Dvp; i += kThreads) {
      const int j = i / Dvp, d = i - j * Dvp;
      vs[i] = d < Dv ? vg[j * vstride + d] : from_f32<T>(0.0f);
    }
  }
}

// grid: (B * Hkv * gchunks * n_splits); block b, kv head hk, head chunk
// gc, range `split`. Warp w owns slots w*4 .. w*4+3 of every tile and runs
// its own online softmax over them (running max, sum and accumulator per
// head), so a tile needs one block barrier (the ring's). At the end the
// warps' states are merged in warp order into the range's partials:
// ws_acc[(b * Hq + h) * n_splits + split][0, Dv) and ws_ml[...][0, 2) =
// (range max, range sum).
template <typename T, int kGR, bool kAligned>
__global__ void __launch_bounds__(kThreads, kGR <= 2 ? 2 : 1)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ pos,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    int T_len, int Hq, int Hkv, int D, int Dv, int n_splits,
                    int chunk, float scale, float softcap, int ring) {
  constexpr int VEC = Vec<T>::n;
  constexpr int kCh = kQ / VEC;            // 16-byte chunks per lane per row
  constexpr int kCg = kMaxD / VEC / 32;    // V column groups per lane
  extern __shared__ __align__(16) unsigned char smem[];

  const int G = Hq / Hkv;
  const int gchunks = (G + kGR - 1) / kGR;
  const int split = blockIdx.x % n_splits;
  const int pair = blockIdx.x / n_splits;
  const int gc = pair % gchunks, bh = pair / gchunks;
  const int b = bh / Hkv, hk = bh - b * Hkv;
  const int g0 = gc * kGR, ng = min(kGR, G - g0);
  const int p = pos[b];
  const int limit = (ring ? min(p, T_len - 1) : p) + 1;  // no overflow
  const int t0 = split * chunk;
  if (t0 >= limit) return;                 // the whole block: nothing valid
  const int n = min(chunk, limit - t0);
  const int ntiles = (n + kTile - 1) / kTile;

  const int Dp = round_up(D, VEC), Dvp = round_up(Dv, VEC);
  const int stage_elems = kTile * (Dp + Dvp);
  T* ring_s = reinterpret_cast<T*>(smem);
  float* state_s = reinterpret_cast<float*>(
      smem + region0_bytes(D, Dv, kGR, sizeof(T)));   // kWarps x kGR x 2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l8 = lane & 7, grp = lane >> 3;
  const long long kstride = static_cast<long long>(Hkv) * D;
  const long long vstride = static_cast<long long>(Hkv) * Dv;
  const long long slot0 = static_cast<long long>(b) * T_len + t0;
  const T* kg = kc + (slot0 * Hkv + hk) * D;
  const T* vg = vc + (slot0 * Hkv + hk) * Dv;

  // the whole ring is in flight while q is read
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < ntiles)
      load_tile<T, kAligned>(ring_s + st * stage_elems,
                             ring_s + st * stage_elems + kTile * Dp,
                             kg + st * kTile * kstride,
                             vg + st * kTile * vstride, kstride, vstride,
                             min(kTile, n - st * kTile), D, Dv, Dp, Dvp);
    cp_async_commit();
  }

  // scale * q for this lane's 16-byte chunks c = l8 + 8 i of each head
  float qr[kGR][kQ];
  const T* qg = q + (static_cast<long long>(b) * Hq + hk * G + g0) * D;
#pragma unroll
  for (int g = 0; g < kGR; ++g) {
#pragma unroll
    for (int i = 0; i < kCh; ++i) {
      const int d0 = (l8 + 8 * i) * VEC;
      float x[VEC];
      if (kAligned && g < ng && d0 < D) {
        unpack(qg + g * D + d0, x);        // global, 16-byte aligned
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          x[e] = (g < ng && d0 + e < D) ? to_f32(qg[g * D + d0 + e]) : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][i * VEC + e] = x[e] * scale;
    }
  }

  // this warp's online softmax; lane owns V column groups lane + 32 u
  float acc[kGR][kCg * VEC];
  float m_w[kGR], l_w[kGR];
#pragma unroll
  for (int g = 0; g < kGR; ++g) {
    m_w[g] = kNegInf;
    l_w[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < kCg * VEC; ++e) acc[g][e] = 0.0f;
  }
  const int ncg = Dvp / VEC;

  for (int it = 0; it < ntiles; ++it) {
    // tile it is copy group it: the prologue committed kStages groups,
    // each later iteration one
    if (it == 0)
      cp_async_wait<kStages - 1>();
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();                       // tile it landed; it-1 consumed
    {
      const int nx = it + kStages - 1;     // into tile it-1's stage
      if (it > 0) {
        if (nx < ntiles) {
          T* st = ring_s + (nx % kStages) * stage_elems;
          load_tile<T, kAligned>(st, st + kTile * Dp,
                                 kg + nx * kTile * kstride,
                                 vg + nx * kTile * vstride, kstride, vstride,
                                 min(kTile, n - nx * kTile), D, Dv, Dp, Dvp);
        }
        cp_async_commit();
      }
    }
    const T* ks = ring_s + (it % kStages) * stage_elems;
    const T* vs = ks + kTile * Dp;
    const int nt = min(kTile, n - it * kTile);
    const int j0 = warp * kSlotsPerWarp;   // this warp's slots of the tile
    if (j0 >= nt) continue;                // nothing of this warp here

    // scores: 8 lanes per slot, the warp's 4 slots at once
    const int j = j0 + grp;
    const bool valid = j < nt;
    float dot[kGR];
#pragma unroll
    for (int g = 0; g < kGR; ++g) dot[g] = 0.0f;
    if (valid) {
      const T* krow = ks + j * Dp;
#pragma unroll
      for (int i = 0; i < kCh; ++i) {
        const int c = l8 + 8 * i;
        if (c * VEC < Dp) {
          float kv[VEC];
          unpack(krow + c * VEC, kv);
#pragma unroll
          for (int g = 0; g < kGR; ++g)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dot[g] = fmaf(qr[g][i * VEC + e], kv[e], dot[g]);
        }
      }
    }
    float pj[kGR];
#pragma unroll
    for (int g = 0; g < kGR; ++g) {
      float s = dot[g];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
      s = valid ? s : kNegInf;
      // the warp's 4 slots: max over the groups, then the running state
      float mt = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, 8));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
      const float m_new = fmaxf(m_w[g], mt);
      const float a = expf(m_w[g] - m_new);
      pj[g] = valid ? expf(s - m_new) : 0.0f;
      float sum = pj[g] + __shfl_xor_sync(0xffffffffu, pj[g], 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      l_w[g] = fmaf(l_w[g], a, sum);
      m_w[g] = m_new;
#pragma unroll
      for (int e = 0; e < kCg * VEC; ++e) acc[g][e] *= a;
    }

    // P·V over the warp's valid slots
    const int nv = min(kSlotsPerWarp, nt - j0);
#pragma unroll
    for (int r = 0; r < kSlotsPerWarp; ++r) {
      float pr[kGR];
#pragma unroll
      for (int g = 0; g < kGR; ++g)
        pr[g] = __shfl_sync(0xffffffffu, pj[g], r * 8);
      if (r < nv) {
        const T* vrow = vs + (j0 + r) * Dvp;
#pragma unroll
        for (int u = 0; u < kCg; ++u) {
          const int cg = lane + 32 * u;
          if (cg < ncg) {
            float vv[VEC];
            unpack(vrow + cg * VEC, vv);
#pragma unroll
            for (int g = 0; g < kGR; ++g)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[g][u * VEC + e] = fmaf(pr[g], vv[e], acc[g][u * VEC + e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                         // the ring is free: reuse it

  // the warps' states, merged in warp order
  float* buf = reinterpret_cast<float*>(smem);   // kWarps x kGR x Dvp
#pragma unroll
  for (int g = 0; g < kGR; ++g) {
#pragma unroll
    for (int u = 0; u < kCg; ++u) {
      const int cg = lane + 32 * u;
      if (cg < ncg) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          buf[(warp * kGR + g) * Dvp + cg * VEC + e] = acc[g][u * VEC + e];
      }
    }
    if (lane == 0) {
      state_s[(warp * kGR + g) * 2] = m_w[g];
      state_s[(warp * kGR + g) * 2 + 1] = l_w[g];
    }
  }
  __syncthreads();
  const long long row0 = static_cast<long long>(b) * Hq + hk * G + g0;
  for (int i = tid; i < ng * Dv; i += kThreads) {
    const int g = i / Dv, col = i - g * Dv;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, state_s[(w * kGR + g) * 2]);
    float a = 0.0f, l = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(state_s[(w * kGR + g) * 2] - mx);
      a = fmaf(buf[(w * kGR + g) * Dvp + col], f, a);
      l = fmaf(state_s[(w * kGR + g) * 2 + 1], f, l);
    }
    ws_acc[((row0 + g) * n_splits + split) * Dv + col] = a;
    if (col == 0) {
      float* ml = ws_ml + ((row0 + g) * n_splits + split) * 2;
      ml[0] = mx;
      ml[1] = l;
    }
  }
}

// grid: (B * Hq, ceil(Dv / 32)); rescale the valid ranges to their
// common max and divide. Warp w sums ranges w, w + 4, ... of 32 columns
// in range order, then the four sums are added in warp order: a fixed
// order, the same bits on every launch. With lse != nullptr the first
// column block also writes lse[b * Hq + h] = max + log(sum), or -inf for
// a row with no valid slot.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ ws_acc,
                      const float* __restrict__ ws_ml,
                      const int* __restrict__ pos, T* __restrict__ out,
                      float* __restrict__ lse, int T_len, int Hq, int Dv,
                      int n_splits, int chunk, int ring) {
  extern __shared__ float weight[];        // n_splits
  __shared__ float red[kCombineWarps];
  __shared__ float part[kCombineWarps][kCombineCols];
  const int bq = blockIdx.x, b = bq / Hq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[b];
  const int limit = (ring ? min(p, T_len - 1) : p) + 1;
  const int ns = min(n_splits, (limit + chunk - 1) / chunk);
  const float* ml = ws_ml + static_cast<long long>(bq) * n_splits * 2;

  float mx = kNegInf;
  for (int s = tid; s < ns; s += kCombineThreads) mx = fmaxf(mx, ml[2 * s]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kCombineWarps; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();                         // red is written again below

  float l = 0.0f;
  for (int s = tid; s < ns; s += kCombineThreads) {
    const float w = expf(ml[2 * s] - mx);
    weight[s] = w;
    l = fmaf(ml[2 * s + 1], w, l);
  }
  l = warp_sum(l);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  float denom = red[0];
#pragma unroll
  for (int w = 1; w < kCombineWarps; ++w) denom += red[w];
  if (lse != nullptr && blockIdx.y == 0 && tid == 0)
    lse[bq] = ns == 0 ? -INFINITY : mx + logf(denom);
  denom = fmaxf(denom, 1e-30f);

  const int col = blockIdx.y * kCombineCols + lane;
  float a = 0.0f;
  if (col < Dv) {
    const float* acc = ws_acc + static_cast<long long>(bq) * n_splits * Dv
                       + col;
#pragma unroll 8
    for (int s = warp; s < ns; s += kCombineWarps)
      a = fmaf(acc[static_cast<long long>(s) * Dv], weight[s], a);
  }
  part[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && col < Dv) {
    float sum = part[0][lane];
#pragma unroll
    for (int w = 1; w < kCombineWarps; ++w) sum += part[w][lane];
    out[static_cast<long long>(bq) * Dv + col] = from_f32<T>(sum / denom);
  }
}

template <typename T, int kGR, bool kAligned>
int launch(const void* q, const void* kc, const void* vc, const void* pos,
           void* out, float* lse, void* ws, int B, int T_len, int Hq,
           int Hkv, int D, int Dv, int n_splits, int chunk, long long smem,
           float scale, float softcap, int ring, cudaStream_t stream) {
  // the shared-memory opt-in, once per process and device
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !opted[dev]) {
    err = cudaFuncSetAttribute(decode_split_kernel<T, kGR, kAligned>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) opted[dev] = true;
  }
  const int G = Hq / Hkv;
  const int gchunks = (G + kGR - 1) / kGR;
  float* ws_acc = static_cast<float*>(ws);
  float* ws_ml = ws_acc + static_cast<long long>(B) * Hq * n_splits * Dv;
  const unsigned grid =
      static_cast<unsigned>(B) * Hkv * gchunks * n_splits;
  decode_split_kernel<T, kGR, kAligned>
      <<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kc),
          static_cast<const T*>(vc), static_cast<const int*>(pos), ws_acc,
          ws_ml, T_len, Hq, Hkv, D, Dv, n_splits, chunk, scale, softcap,
          ring);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 cgrid(B * Hq, (Dv + kCombineCols - 1) / kCombineCols);
  const size_t csmem = sizeof(float) * n_splits;
  if (lse != nullptr)                      // a float32 partial and its lse
    decode_combine_kernel<float><<<cgrid, kCombineThreads, csmem, stream>>>(
        ws_acc, ws_ml, static_cast<const int*>(pos), static_cast<float*>(out),
        lse, T_len, Hq, Dv, n_splits, chunk, ring);
  else
    decode_combine_kernel<T><<<cgrid, kCombineThreads, csmem, stream>>>(
        ws_acc, ws_ml, static_cast<const int*>(pos), static_cast<T*>(out),
        nullptr, T_len, Hq, Dv, n_splits, chunk, ring);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kGR>
int launch_aligned(int aligned, const void* q, const void* kc,
                   const void* vc, const void* pos, void* out, float* lse,
                   void* ws, int B, int T_len, int Hq, int Hkv, int D, int Dv,
                   int n_splits, int chunk, long long smem, float scale,
                   float softcap, int ring, cudaStream_t s) {
  return aligned
      ? launch<T, kGR, true>(q, kc, vc, pos, out, lse, ws, B, T_len, Hq,
                             Hkv, D, Dv, n_splits, chunk, smem, scale,
                             softcap, ring, s)
      : launch<T, kGR, false>(q, kc, vc, pos, out, lse, ws, B, T_len, Hq,
                              Hkv, D, Dv, n_splits, chunk, smem, scale,
                              softcap, ring, s);
}

template <typename T>
int launch_gr(int gr, int aligned, const void* q, const void* kc,
              const void* vc, const void* pos, void* out, float* lse,
              void* ws, int B, int T_len, int Hq, int Hkv, int D, int Dv,
              int n_splits, int chunk, long long smem, float scale,
              float softcap, int ring, cudaStream_t s) {
  if (gr == 1)
    return launch_aligned<T, 1>(aligned, q, kc, vc, pos, out, lse, ws, B,
                                T_len, Hq, Hkv, D, Dv, n_splits, chunk, smem,
                                scale, softcap, ring, s);
  if (gr == 2)
    return launch_aligned<T, 2>(aligned, q, kc, vc, pos, out, lse, ws, B,
                                T_len, Hq, Hkv, D, Dv, n_splits, chunk, smem,
                                scale, softcap, ring, s);
  return launch_aligned<T, 4>(aligned, q, kc, vc, pos, out, lse, ws, B,
                              T_len, Hq, Hkv, D, Dv, n_splits, chunk, smem,
                              scale, softcap, ring, s);
}

}  // namespace

// Bytes of dynamic shared memory a split block takes (see region0_bytes).
extern "C" long long flash_decode_shared_bytes(int D, int Dv, int gr,
                                               int itemsize) {
  return shared_bytes(D, Dv, gr, itemsize);
}

// dtype code: 0 = float32, 1 = bfloat16; softcap <= 0: none; ring != 0:
// ring buffer; gr (1, 2 or 4) q heads per block; aligned != 0: the caches
// are 16-byte aligned and D, Dv multiples of the 16-byte vector (cp.async
// path). The plan (n_splits ranges of `chunk` slots, smem bytes) is
// kernels/flash_decode.py:decode_plan's. ws holds B*Hq*n_splits*(Dv+2)
// floats. lse: nullptr, or (B, Hq) floats for each row's log-sum-exp;
// out is then (B, Hq, Dv) floats whatever the dtype, and pos[b] may be -1
// (no valid slot). Launches both kernels on
// `stream`; returns the first CUDA error (0 = ok). The caller has checked
// shapes (D, Dv <= 256, Hq a multiple of Hkv), types, contiguity and the
// range of pos, and that B, T and the heads are non-zero.
extern "C" int flash_decode(const void* q, const void* kc, const void* vc,
                            const void* pos, void* out, void* lse, void* ws,
                            int B, int T_len, int Hq, int Hkv, int D, int Dv,
                            int n_splits, int chunk, int gr, long long smem,
                            float scale, float softcap, int ring,
                            int aligned, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int itemsize = dtype == 0 ? 4 : 2;
  if (D > kMaxD || Dv > kMaxD || n_splits < 1 || chunk < 1 ||
      (gr != 1 && gr != 2 && gr != 4) || (dtype != 0 && dtype != 1) ||
      smem != shared_bytes(D, Dv, gr, itemsize) || smem > kMaxShared ||
      static_cast<long long>(n_splits) * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_gr<float>(gr, aligned, q, kc, vc, pos, out,
                            static_cast<float*>(lse), ws, B, T_len, Hq, Hkv,
                            D, Dv, n_splits, chunk, smem, scale, softcap,
                            ring, s);
  return launch_gr<__nv_bfloat16>(gr, aligned, q, kc, vc, pos, out,
                                  static_cast<float*>(lse), ws, B, T_len, Hq,
                                  Hkv, D, Dv, n_splits, chunk, smem, scale,
                                  softcap, ring, s);
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
