// flash_attention_bwd — the gradients of flash_attention.cu's forward
//
//   delta[b, h, i] = sum_d dout[b, i, h, d] out[b, i, h, d]
//   P_ij  = exp(s_ij - lse[b, h, i]) over the visible keys, 0 elsewhere
//   dP_ij = dout[b, i, h] . v[b, j, h / G]
//   dS_ij = P_ij (dP_ij - delta_i) (1 - (s_ij / cap)^2 under a softcap)
//   dq[b, i, h]      = scale sum_j dS_ij k[b, j, h / G]
//   dk[b, j, hk]     = scale sum_{h of hk} sum_i dS_ij q[b, i, h]
//   dv[b, j, hk]     = sum_{h of hk} sum_i P_ij dout[b, i, h]
//
// with s_ij = cap tanh(scale q_i . k_j / cap) (or scale q_i . k_j) and the
// forward's mask: query row i sits at position p_i = q_off + i, and key j
// is visible from it iff j < Sk, when causal j <= p_i or j < prefix[b],
// and p_i - j < window when a window is set. q (B, Sq, Hq, D), k (B, Sk,
// Hkv, D), v (B, Sk, Hkv, Dv), out and dout (B, Sq, Hq, Dv), all float32
// or all bfloat16 and contiguous; lse (B, Hq, Sq) float32 from the
// forward; 0 <= q_off, q_off + Sq <= Sk. dq, dk, dv come out in the
// inputs' type (dq q's shape, dk and dv k's and v's); every product and
// sum is float32. A key that no row sees (causal, j > q_off + Sq - 1, or
// a window that ends before it) still gets its dk and dv written: zeros,
// from a dK/dV block whose range of query tiles is empty. Its partials,
// where the plan splits, are zeros too and are summed in the same fixed
// order as the others.
//
// This is what the reference computes in plain JAX: the custom VJP
// _flash_bwd of src/repro/models/layers.py (its windowed and prefix-LM
// layers go through autodiff of the same function). There is no Pallas
// backward kernel to replace.
//
// What bounds it on this card: operations. Per visible (query, key) pair
// and head the gradients need the recomputed score (2 D flops), dP and dV
// (2 Dv each), dQ and dK (2 D each): 2 (3 D + 2 Dv) flops, against 989
// TFLOP/s in bf16 and 67 in float32. The bytes (q, k, v, out, dout, lse
// read once, dq, dk, dv written once) take far less time at the training
// path's shapes.
//
// Three or four launches: delta, dK/dV, the sum of the dK/dV partials
// (only when the launch plan splits), dQ.
//  * delta: one warp per (b, i, h) row, a shuffle sum.
//  * S and dP are computed twice (once for dK/dV, once for dQ): the cost
//    of writing dQ without atomics. No atomics anywhere: every output
//    element is summed by one thread in a fixed order, so two launches
//    give equal bits.
//
// bfloat16: bwd_tc_kernel, on the tensor cores by mma.sync m16n8k16 (bf16
// operands, float32 sums). One template serves both passes: a block of 8
// warps holds a fixed tile of kF rows (keys with their K and V rows for
// dK/dV; query rows with their Q, dO, lse and delta for dQ) and streams
// 32-row tiles of the other side (Q, dO, lse, delta; or K, V) through a
// 2-stage cp.async ring, 16 bytes a copy. kF is 64, or 32 where a head
// dim is above 96, so that two blocks share an SM at every head dim (128
// registers a thread; 112,128 bytes of shared memory at D = Dv = 256):
// one block of 8 warps an SM left the tensor cores idle through each
// phase's latency (on the H100 at gemma2-2b's training shape, 0.51 ms
// against 0.39 with two). Per streamed tile:
//  1. X = F_a T_a^T and Y = F_b T_b^T (S^T and dP^T for dK/dV, S and dP
//     for dQ), each warp 16 fixed rows by 16 or 8 streamed rows. bf16
//     products are exact, the sums float32.
//  2. On the float32 fragments: the scale (never folded into Q: a bf16
//     q * scale is 19x over the gate at D = 224, see flash_attention.cu),
//     the softcap as cap tanh(s / cap) with the accurate tanhf (1 / cap
//     multiplied in), the mask (only where the tile pair crosses an edge
//     of the visible band), P = 2^((s - lse) log2 e), dS = P (dP - delta)
//     (1 - (s / cap)^2). P and dS are split into bf16 hi = bf16(x) and lo
//     = bf16(x - hi) and staged in shared memory ([fixed row][streamed
//     row], row stride 40).
//  3. acc_a += dS_hi T_a + dS_lo T_a (dK += dS^T Q, or dQ += dS K) and,
//     for dK/dV, acc_b += P_hi T_b + P_lo T_b (dV += P^T dO). Each warp
//     owns 16 fixed rows and every 2nd (kF 64) or 4th (kF 32) 8-column
//     tile of the head dim, interleaved so that a head dim of 80 splits
//     evenly; float32 accumulators in registers, 64 a thread for dK and
//     dV together.
// The split keeps about 16 bits of each float32 P and dS (relative error
// below 2^-17). tests/test_torch_attention_bwd_numerics.py emulates this
// arithmetic within the 2-ulp gate and pins why both are split: one bf16
// rounding (2^-9) of P leaves dV 18-53x over the gate, of dS dQ and dK
// (dQ = sum_j dS_ij k_j cancels: with no softcap sum_j dS_ij = 0).
//
// Why mma.sync and not wgmma: P and dS are made in registers, split in
// two and staged through shared memory for every 32-row tile, and the
// fixed tile's accumulators take half the register file; mma.sync with
// ldmatrix fragments and a cp.async ring is the simpler kernel that is
// right first. wgmma (both operands from shared memory, a producer
// warpgroup on TMA) is later work.
//
// Shared memory (bf16 row strides rounded up to 16 columns plus 8, an
// odd number of 16-byte chunks, so the 8 rows an ldmatrix reads fall in
// distinct banks): the fixed tiles 2 x kF rows, the ring 2 stages x 2 x
// 32 rows, the P / dS staging 4 (dK/dV) or 2 (dQ) x kF x 40, the
// streamed rows' lse and delta. Head dims that are multiples of 8 up to
// 256 work (columns past D load as zeros); the accumulators are sized for
// 64, 96, 128 or 256 columns and tiles past D are skipped.
//
// Filling the SMs: the launch plan (flash_attention.py: bwd_plan) splits
// the G q heads of a kv head into n_g groups and, where that is not
// enough, each key tile's query range into n_q parts, until the dK/dV
// blocks reach the two an SM the card holds. A split block writes its
// float32 dK/dV partial to a workspace, and sum_partials adds the n_g n_q
// partials of each element in a fixed order. The dK/dV blocks run the
// key tiles in order (the causal longest first), the dQ blocks the query
// tiles in reverse (the same).
//
// float32: the simple SIMT kernels; any tensor-core form would break
// float32's rtol 1e-5 against the plain version.
//  * dK/dV: one block of 256 threads per (32-key tile, kv head, batch)
//    keeps the K and V tile in shared memory and the tile's dK and dV
//    accumulators in registers (8 threads per key, 32 columns each), and
//    loops over the G q heads of its kv head and, for each, over the
//    32-row query tiles that can see the tile. Per query tile it loads Q,
//    dO, lse and delta into shared memory, computes S and dP (each thread
//    4 of the 32 x 32 pairs), then P and dS into shared memory, then dV +=
//    P^T dO and dK += dS^T Q.
//  * dQ: one block per (32-row query tile, q head, batch) holds Q, dO,
//    lse and delta and the tile's dQ accumulator (8 threads per row, 32
//    columns each), and loops over the key tiles the rows can see:
//    S, dP, dS, then dQ += dS K.
//  * Shared arrays of D + 1 floats a row, so the 8 keys or the 4 rows a
//    warp reads at once fall in distinct banks.
//
// No --use_fast_math: accurate tanhf everywhere, accurate expf on the
// float32 path and exp2f on the bf16 one; bf16 converted with the
// intrinsics only.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;            // query rows per tile
constexpr int kBK = 32;            // keys per tile
constexpr int kMaxD = 256;         // largest head dim
constexpr int kCols = kMaxD / 8;   // accumulator columns a thread owns
constexpr int kDeltaRows = 8;      // delta rows (warps) per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// key j visible from the query row at position p
__device__ __forceinline__ bool visible(int p, int j, int Sk, int causal,
                                        int window, int pre) {
  return j < Sk && (!causal || j <= p || j < pre)
         && (window <= 0 || p - j < window);
}

// P and dS of one (query, key) pair from the unscaled q . k, dO . v and
// the row's lse and delta; both 0 for a masked pair
__device__ __forceinline__ void p_ds(float raw, float dp, float lse_i,
                                     float delta_i, float scale,
                                     float softcap, bool ok, float& p,
                                     float& ds) {
  if (!ok) {
    p = 0.0f;
    ds = 0.0f;
    return;
  }
  float s = raw * scale;
  float fac = 1.0f;
  if (softcap > 0.0f) {
    s = softcap * tanhf(s / softcap);
    const float u = s / softcap;
    fac = 1.0f - u * u;
  }
  p = expf(s - lse_i);
  ds = p * (dp - delta_i) * fac;
}

// rows [r0, r0 + n) of a (B, S, H, d) tensor's head h into a float32
// shared array of row stride ld; rows past S as zeros
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src,
                                          int b, int r0, int n, int S, int H,
                                          int h, int d) {
  for (int e = threadIdx.x; e < n * d; e += kThreads) {
    const int r = e / d, c = e - r * d, s = r0 + r;
    dst[r * ld + c] =
        s < S ? src[((static_cast<long long>(b) * S + s) * H + h) * d + c]
              : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kDeltaRows * 32)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int Sq, int Hq,
             int Dv) {
  const long long row = static_cast<long long>(blockIdx.x) * kDeltaRows
                        + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* o = out + row * Dv;
  const T* g = dout + row * Dv;
  float acc = 0.0f;
  for (int c = lane; c < Dv; c += 32)
    acc = fmaf(to_f32(g[c]), to_f32(o[c]), acc);
  for (int w = 16; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    // row = (b Sq + i) Hq + h  ->  delta[(b Hq + h) Sq + i]
    const long long bi = row / Hq;
    const int h = static_cast<int>(row - bi * Hq);
    const long long b = bi / Sq;
    const int i = static_cast<int>(bi - b * Sq);
    delta[(b * Hq + h) * Sq + i] = acc;
  }
}

struct Dims {
  int Sq, Sk, q_off, Hq, Hkv, D, Dv;
  float scale;
  int causal, window;
  float softcap;
};

// S and dP of this thread's 4 pairs (row i, keys j0 + 8 c)
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       int ldq, int ldo, int i, int j0,
                                       int D, int Dv, float (&raw)[4],
                                       float (&dp)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) raw[c] = dp[c] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float qv = qs[i * ldq + d];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      raw[c] = fmaf(qv, ks[(j0 + 8 * c) * ldq + d], raw[c]);
  }
  for (int d = 0; d < Dv; ++d) {
    const float gv = dos[i * ldo + d];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dp[c] = fmaf(gv, vs[(j0 + 8 * c) * ldo + d], dp[c]);
  }
}

size_t bwd_shared_bytes(int D, int Dv) {
  return sizeof(float) * (2 * kBQ * (D + 1) + 2 * kBQ * (Dv + 1)
                          + 2 * kBQ * (kBK + 1) + 2 * kBQ);
}

// float32: one block per (32-key tile, kv head, batch): dK and dV of the
// tile
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ prefix, float* __restrict__ dk,
            float* __restrict__ dv, Dims a) {
  extern __shared__ float smem[];
  const int ldq = a.D + 1, ldo = a.Dv + 1;
  float* ks = smem;                       // kBK x ldq
  float* qs = ks + kBK * ldq;             // kBQ x ldq
  float* vs = qs + kBQ * ldq;             // kBK x ldo
  float* dos = vs + kBK * ldo;            // kBQ x ldo
  float* ps = dos + kBQ * ldo;            // kBQ x (kBK + 1)
  float* dss = ps + kBQ * (kBK + 1);      // kBQ x (kBK + 1)
  float* lse_s = dss + kBQ * (kBK + 1);   // kBQ
  float* del_s = lse_s + kBQ;             // kBQ

  const int kv0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int Sq = a.Sq, Sk = a.Sk, off = a.q_off;
  const int pre = prefix != nullptr ? prefix[b] : 0;
  const int tid = threadIdx.x;
  const int r = tid >> 3;            // score row / accumulator key
  const int c8 = tid & 7;            // score key lane / accumulator column

  load_rows(ks, ldq, k, b, kv0, kBK, Sk, a.Hkv, hk, a.D);
  load_rows(vs, ldo, v, b, kv0, kBK, Sk, a.Hkv, hk, a.Dv);

  // query rows [q_lo, q_hi) can see some key of the tile (none when
  // q_hi <= q_lo: the tile's dK and dV are zeros)
  int q_lo = 0, q_hi = Sq;
  if (a.causal && kv0 >= pre) q_lo = max(0, kv0 - off);
  if (a.window > 0) q_hi = min(Sq, kv0 + kBK - 1 + a.window - off);

  float acc_k[kCols], acc_v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc_k[c] = acc_v[c] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* lse_h = lse + (static_cast<long long>(b) * a.Hq + h) * Sq;
    const float* del_h = delta + (static_cast<long long>(b) * a.Hq + h) * Sq;
    for (int q0 = (q_lo / kBQ) * kBQ; q0 < q_hi; q0 += kBQ) {
      __syncthreads();               // the previous tile is no longer read
      load_rows(qs, ldq, q, b, q0, kBQ, Sq, a.Hq, h, a.D);
      load_rows(dos, ldo, dout, b, q0, kBQ, Sq, a.Hq, h, a.Dv);
      if (tid < kBQ) {
        lse_s[tid] = q0 + tid < Sq ? lse_h[q0 + tid] : 0.0f;
        del_s[tid] = q0 + tid < Sq ? del_h[q0 + tid] : 0.0f;
      }
      __syncthreads();

      float raw[4], dp[4];
      scores(qs, dos, ks, vs, ldq, ldo, r, c8, a.D, a.Dv, raw, dp);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = c8 + 8 * c, i = q0 + r;
        float p, ds;
        p_ds(raw[c], dp[c], lse_s[r], del_s[r], a.scale, a.softcap,
             i < Sq && visible(off + i, kv0 + j, Sk, a.causal, a.window,
                               pre), p, ds);
        ps[r * (kBK + 1) + j] = p;
        dss[r * (kBK + 1) + j] = ds;
      }
      __syncthreads();

      // this thread's key r: dV += P^T dO, dK += dS^T Q over the tile's rows
      for (int i = 0; i < kBQ; ++i) {
        const float p = ps[i * (kBK + 1) + r];
        const float ds = dss[i * (kBK + 1) + r];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = c8 + 8 * c;
          if (d < a.Dv) acc_v[c] = fmaf(p, dos[i * ldo + d], acc_v[c]);
          if (d < a.D) acc_k[c] = fmaf(ds, qs[i * ldq + d], acc_k[c]);
        }
      }
    }
  }

  const int j = kv0 + r;
  if (j < Sk) {
    const long long row = (static_cast<long long>(b) * Sk + j) * a.Hkv + hk;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = c8 + 8 * c;
      if (d < a.D) dk[row * a.D + d] = acc_k[c] * a.scale;
      if (d < a.Dv) dv[row * a.Dv + d] = acc_v[c];
    }
  }
}

// float32: one block per (32-row query tile, q head, batch): dQ of the
// tile
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ prefix, float* __restrict__ dq, Dims a) {
  extern __shared__ float smem[];
  const int ldq = a.D + 1, ldo = a.Dv + 1;
  float* ks = smem;                       // kBK x ldq
  float* qs = ks + kBK * ldq;             // kBQ x ldq
  float* vs = qs + kBQ * ldq;             // kBK x ldo
  float* dos = vs + kBK * ldo;            // kBQ x ldo
  float* dss = dos + kBQ * ldo;           // kBQ x (kBK + 1)
  float* lse_s = dss + 2 * kBQ * (kBK + 1);
  float* del_s = lse_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int Sq = a.Sq, Sk = a.Sk, off = a.q_off;
  const int pre = prefix != nullptr ? prefix[b] : 0;
  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int c8 = tid & 7;

  load_rows(qs, ldq, q, b, q0, kBQ, Sq, a.Hq, h, a.D);
  load_rows(dos, ldo, dout, b, q0, kBQ, Sq, a.Hq, h, a.Dv);
  if (tid < kBQ) {
    const long long at = (static_cast<long long>(b) * a.Hq + h) * Sq + q0
                         + tid;
    lse_s[tid] = q0 + tid < Sq ? lse[at] : 0.0f;
    del_s[tid] = q0 + tid < Sq ? delta[at] : 0.0f;
  }

  // keys [lo, hi) can be visible from some row of this tile
  int lo = 0, hi = Sk;
  if (a.window > 0) lo = max(0, off + q0 - a.window + 1);
  if (a.causal) hi = min(Sk, max(pre, off + q0 + kBQ));

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;

  for (int kv0 = (lo / kBK) * kBK; kv0 < hi; kv0 += kBK) {
    __syncthreads();                 // the previous tile is no longer read
    load_rows(ks, ldq, k, b, kv0, kBK, Sk, a.Hkv, hk, a.D);
    load_rows(vs, ldo, v, b, kv0, kBK, Sk, a.Hkv, hk, a.Dv);
    __syncthreads();

    float raw[4], dp[4];
    scores(qs, dos, ks, vs, ldq, ldo, r, c8, a.D, a.Dv, raw, dp);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = c8 + 8 * c, i = q0 + r;
      float p, ds;
      p_ds(raw[c], dp[c], lse_s[r], del_s[r], a.scale, a.softcap,
           i < Sq && visible(off + i, kv0 + j, Sk, a.causal, a.window, pre),
           p, ds);
      dss[r * (kBK + 1) + j] = ds;
    }
    __syncthreads();

    // this thread's row r: dQ += dS K over the tile's keys
    for (int j = 0; j < kBK; ++j) {
      const float ds = dss[r * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = c8 + 8 * c;
        if (d < a.D) acc[c] = fmaf(ds, ks[j * ldq + d], acc[c]);
      }
    }
  }

  const int i = q0 + r;
  if (i < Sq) {
    float* row = dq + ((static_cast<long long>(b) * Sq + i) * a.Hq + h) * a.D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = c8 + 8 * c;
      if (d < a.D) row[d] = acc[c] * a.scale;
    }
  }
}

template <typename T>
int launch_delta(const T* out, const T* dout, float* delta, int B,
                 const Dims& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * a.Sq * a.Hq;
  const long long blocks = (rows + kDeltaRows - 1) / kDeltaRows;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<unsigned>(blocks), kDeltaRows * 32, 0,
                    stream>>>(out, dout, delta, rows, a.Sq, a.Hq, a.Dv);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Tensor-core kernels (bfloat16)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;    // 8 warps
constexpr int kT = 32;             // rows of a streamed tile
constexpr int kLdW = kT + 8;       // bf16 row stride of the P / dS tiles

// bf16 row stride of a tile of head dim d: d rounded up to the 16 columns
// of an mma step, plus 8 (an odd number of 16-byte chunks)
__host__ __device__ constexpr int ld_of(int d) {
  return (d + 15) / 16 * 16 + 8;
}

// rows of a block's fixed tile for accumulators of head dim hd: 64, or
// 32 above 96, so that two blocks fit an SM's registers (128 a thread,
// no spills) and shared memory at every head dim
__host__ __device__ constexpr int fixed_rows(int hd) {
  return hd > 96 ? 32 : 64;
}

// The staging tiles: dK/dV stages dS hi, dS lo, P hi, P lo; dQ dS hi, lo.
size_t tc_shared_bytes(int D, int Dv, bool kv) {
  const size_t f = fixed_rows(D > Dv ? D : Dv);
  const size_t tiles = (f + 2 * kT) * (ld_of(D) + ld_of(Dv))
                       + (kv ? 4 : 2) * f * kLdW;
  return 2 * tiles + sizeof(float) * (kv ? 2 * 2 * kT : 2 * f);
}

struct TcArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;
  const int* prefix;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* ws;            // dK then dV partials, (n_g n_q, B, Sk, Hkv, d) each
  int B, Sq, Sk, q_off, Hq, Hkv, D, Dv;
  float scale;
  int causal, window;
  float softcap;
  int n_g, n_q;         // the plan's split of the dK/dV blocks
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the calling thread's copies but the newest N groups have landed (a
// __syncthreads() must follow before other threads read them)
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d += a b: a 16 x 16 (row-major fragment), b 16 x 8 (column fragment)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 15 of a
// row-major [m][k] bf16 tile (row stride ld).
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const uint16_t* s,
                                       int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7;
  const uint32_t addr =
      smem_u32(s + (r0 + i + 8 * (q & 1)) * ld + k0 + 8 * (q >> 1));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// The B fragments of two 8-column tiles, n0 and n0 + 8, reduction k0 ..
// k0 + 15, of a tile stored [n][k] (row stride ld): b[0], b[1] of n0,
// b[2], b[3] of n0 + 8.
__device__ __forceinline__ void ldsm_b2(uint32_t (&b)[4], const uint16_t* s,
                                        int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7;
  const uint32_t addr =
      smem_u32(s + (n0 + i + 8 * (q >> 1)) * ld + k0 + 8 * (q & 1));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3]) : "r"(addr));
}

// The B fragments of kN (1 or 2) 8-column tiles from n0, reduction k0 ..
// k0 + 15, of a tile stored [n][k] (row stride ld): b[2 t], b[2 t + 1] of
// tile t.
template <int kN>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[2 * kN],
                                       const uint16_t* s, int ld, int n0,
                                       int k0) {
  if constexpr (kN == 2) {
    ldsm_b2(b, s, ld, n0, k0);
  } else {
    const int lane = threadIdx.x & 31, q = (lane >> 3) & 1, i = lane & 7;
    const uint32_t addr = smem_u32(s + (n0 + i) * ld + k0 + 8 * q);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(b[0]), "=r"(b[1]) : "r"(addr));
  }
}

// The B fragments of 8-column tiles n0 and n1, reduction k0 .. k0 + 15,
// of a tile stored [k][n] (row stride ld), read transposed: b[0], b[1] of
// n0, b[2], b[3] of n1.
__device__ __forceinline__ void ldsm_trans_b2(uint32_t (&b)[4],
                                              const uint16_t* s, int ld,
                                              int k0, int n0, int n1) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7;
  const uint32_t addr =
      smem_u32(s + (k0 + i + 8 * (q & 1)) * ld + ((q >> 1) ? n1 : n0));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3]) : "r"(addr));
}

// two floats as bf16 hi and lo pairs, the first in the low half:
// x = hi + lo + r with |r| <= 2^-17 |x| (x - hi is exact in float32)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - back.x, x1 - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// rows [r0, r0 + n) of head h of a (B, S, H, d) bf16 tensor into dst (row
// stride ld) by cp.async, 16 bytes a copy; rows past S and the columns
// from d to ld - 8 as zeros
__device__ __forceinline__ void load_tile(uint16_t* dst, int ld,
                                          const __nv_bfloat16* src, int b,
                                          int r0, int n, int S, int H, int h,
                                          int d) {
  const int chunks = (ld - 8) / 8;
  for (int e = threadIdx.x; e < n * chunks; e += kTcThreads) {
    const int r = e / chunks, c = (e - r * chunks) * 8, s = r0 + r;
    const bool live = s < S && c < d;
    const __nv_bfloat16* p =
        live ? src + ((static_cast<long long>(b) * S + s) * H + h) * d + c
             : src;
    cp_async16(dst + r * ld + c, p, live ? 16 : 0);
  }
}

// rows [r0, r0 + n) of lse and delta at (b, h) into dst[0, n) and
// dst[n, 2n) by cp.async; rows past S as zeros
__device__ __forceinline__ void load_rows_f32(float* dst, const float* lse,
                                              const float* delta, int b,
                                              int h, int Hq, int r0, int n,
                                              int S) {
  for (int e = threadIdx.x; e < 2 * n; e += kTcThreads) {
    const int r = e % n, s = r0 + r;
    const float* src = (e < n ? lse : delta)
                       + (static_cast<long long>(b) * Hq + h) * S
                       + (s < S ? s : 0);
    cp_async4(dst + e, src, s < S ? 4 : 0);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// P and dS of one pair on the tensor-core path, from the unscaled q . k
// and dO . v: the softcap as cap tanh(s / cap) with the accurate tanhf
// (and 1 / cap multiplied in), p = 2^((s - lse) log2 e)
__device__ __forceinline__ void p_ds_tc(float raw, float dp, float lse_i,
                                        float delta_i, float scale,
                                        float cap, float inv_cap, float& p,
                                        float& ds) {
  float s = raw * scale, fac = 1.0f;
  if (cap > 0.0f) {
    const float u = tanhf(s * inv_cap);
    s = cap * u;
    fac = 1.0f - u * u;
  }
  p = exp2f((s - lse_i) * kLog2e);
  ds = p * (dp - delta_i) * fac;
}

// kKV: the dK/dV pass (fixed tile: kF keys of kv head hk; streamed: the
// query tiles of the block's q heads that see them), else the dQ pass
// (fixed: kF query rows of q head h; streamed: the key tiles they see).
// kHD: the accumulators' head dim (64, 96, 128 or 256), at least D and
// Dv. Two blocks an SM. The 8 warps split the fixed tile's kF rows into kRG
// groups of 16 and the columns into kCG groups: X and Y by streamed rows
// (kXT 8-row tiles a warp), the accumulators by head-dim column tiles
// (tile j of a warp is column tile kCG j + wc).
template <int kHD, bool kKV>
__global__ void __launch_bounds__(kTcThreads, 2)
bwd_tc_kernel(const TcArgs a) {
  constexpr int kF = fixed_rows(kHD);
  constexpr int kRG = kF / 16, kCG = 8 / kRG;
  constexpr int kXT = kT / 8 / kCG;  // 2 or 1
  constexpr int kNT = kHD / 8 / kCG; // 8-column tiles a warp owns
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int ldA = ld_of(a.D), ldB = ld_of(a.Dv);
  const int padA = ldA - 8, padB = ldB - 8;
  uint16_t* fa = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* fb = fa + kF * ldA;
  uint16_t* ta = fb + kF * ldB;            // ring: stage s at s * kT * ldA
  uint16_t* tb = ta + 2 * kT * ldA;
  uint16_t* w = tb + 2 * kT * ldB;         // 4 or 2 tiles of kF x kLdW
  float* rows = reinterpret_cast<float*>(w + (kKV ? 4 : 2) * kF * kLdW);
  uint16_t* w_dshi = w;
  uint16_t* w_dslo = w + kF * kLdW;
  uint16_t* w_phi = w + 2 * kF * kLdW;     // dK/dV only
  uint16_t* w_plo = w + 3 * kF * kLdW;

  const int Sq = a.Sq, Sk = a.Sk, off = a.q_off, G = a.Hq / a.Hkv;
  const int blk = static_cast<int>(blockIdx.x);
  int f0, b, hk, h = 0, g0 = 0, n_heads = 1, sq = 0;
  if constexpr (kKV) {
    // key tiles in order, the longest causal ones first; split sp of the
    // (b, hk) pair takes q heads [g0, g0 + n_heads) of the kv head and
    // part sq of the query range
    const int splits = a.n_g * a.n_q, per_tile = a.B * a.Hkv * splits;
    f0 = blk / per_tile * kF;
    const int sp = blk % splits, pair = blk % per_tile / splits;
    hk = pair % a.Hkv;
    b = pair / a.Hkv;
    n_heads = G / a.n_g;
    g0 = sp / a.n_q * n_heads;
    sq = sp % a.n_q;
  } else {
    // query tiles in reverse, the longest causal ones first
    const int hb = a.Hq * a.B, n_f = (Sq + kF - 1) / kF;
    f0 = (n_f - 1 - blk / hb) * kF;
    h = blk % hb % a.Hq;
    b = blk % hb / a.Hq;
    hk = h / G;
  }
  const int pre = a.causal && a.prefix != nullptr ? a.prefix[b] : 0;
  int t_first, n_t;
  if constexpr (kKV) {
    // query rows [lo, hi) (rows of q, at positions off + row) can see
    // some key of the tile; none when hi <= lo, and the tile's dK and dV
    // (or its partials) are then written as zeros
    const int lo = a.causal && f0 >= pre ? max(0, f0 - off) : 0;
    const int hi =
        a.window > 0 ? min(Sq, f0 + kF - 1 + a.window - off) : Sq;
    const int first = lo / kT;
    const int all = hi > lo ? (hi - 1) / kT - first + 1 : 0;
    const int part = (all + a.n_q - 1) / a.n_q;
    t_first = first + sq * part;
    n_t = max(0, min(part, all - sq * part));
  } else {
    // keys [lo, hi) can be visible from some row of the tile
    const int p0 = off + f0;
    const int lo = a.window > 0 ? max(0, p0 - a.window + 1) : 0;
    const int hi = a.causal ? min(Sk, max(pre, p0 + kF)) : Sk;
    t_first = lo / kT;
    n_t = (hi - 1) / kT - t_first + 1;
  }
  const int n_steps = n_heads * n_t;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wr = 16 * (warp % kRG);  // the warp's 16 fixed rows
  const int wc = warp / kRG;         // its column group

  // the fixed tile, then the first streamed one
  if constexpr (kKV) {
    load_tile(fa, ldA, a.k, b, f0, kF, Sk, a.Hkv, hk, a.D);
    load_tile(fb, ldB, a.v, b, f0, kF, Sk, a.Hkv, hk, a.Dv);
  } else {
    load_tile(fa, ldA, a.q, b, f0, kF, Sq, a.Hq, h, a.D);
    load_tile(fb, ldB, a.dout, b, f0, kF, Sq, a.Hq, h, a.Dv);
    load_rows_f32(rows, a.lse, a.delta, b, h, a.Hq, f0, kF, Sq);
  }
  cp_async_commit();
  auto issue = [&](int i) {
    const int st = i & 1;
    const int t0 = (t_first + i % n_t) * kT;
    if constexpr (kKV) {
      const int hq = hk * G + g0 + i / n_t;
      load_tile(ta + st * kT * ldA, ldA, a.q, b, t0, kT, Sq, a.Hq, hq, a.D);
      load_tile(tb + st * kT * ldB, ldB, a.dout, b, t0, kT, Sq, a.Hq, hq,
                a.Dv);
      load_rows_f32(rows + st * 2 * kT, a.lse, a.delta, b, hq, a.Hq, t0, kT,
                    Sq);
    } else {
      load_tile(ta + st * kT * ldA, ldA, a.k, b, t0, kT, Sk, a.Hkv, hk, a.D);
      load_tile(tb + st * kT * ldB, ldB, a.v, b, t0, kT, Sk, a.Hkv, hk,
                a.Dv);
    }
    cp_async_commit();
  };

  float acc_a[kNT][4], acc_b[kKV ? kNT : 1][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_a[j][e] = 0.0f;
  if constexpr (kKV) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_b[j][e] = 0.0f;
  }

  if (n_steps > 0) issue(0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    const int t0 = (t_first + i % n_t) * kT;
    if (i + 1 < n_steps) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                 // tile i (and the fixed tile) landed
    const uint16_t* tas = ta + st * kT * ldA;
    const uint16_t* tbs = tb + st * kT * ldB;

    // 1. X = F_a T_a^T, Y = F_b T_b^T: the warp's 16 fixed rows by its
    // kXT 8-row tiles of the streamed ones
    float x[kXT][4], y[kXT][4];
#pragma unroll
    for (int n = 0; n < kXT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = y[n][e] = 0.0f;
    for (int k0 = 0; k0 < padA; k0 += 16) {
      uint32_t af[4], bf[2 * kXT];
      ldsm_a(af, fa, ldA, wr, k0);
      ldsm_b<kXT>(bf, tas, ldA, 8 * kXT * wc, k0);
#pragma unroll
      for (int n = 0; n < kXT; ++n)
        mma_bf16(x[n], af, bf[2 * n], bf[2 * n + 1]);
    }
    for (int k0 = 0; k0 < padB; k0 += 16) {
      uint32_t af[4], bf[2 * kXT];
      ldsm_a(af, fb, ldB, wr, k0);
      ldsm_b<kXT>(bf, tbs, ldB, 8 * kXT * wc, k0);
#pragma unroll
      for (int n = 0; n < kXT; ++n)
        mma_bf16(y[n], af, bf[2 * n], bf[2 * n + 1]);
    }

    // 2. P and dS on the fragments, split hi + lo into shared memory; the
    // mask only where the tile pair crosses an edge of the visible band
    const float* lse_t = rows + st * 2 * kT;   // dK/dV: the streamed rows'
    const int q_lo = kKV ? t0 : f0, q_hi = q_lo + (kKV ? kT : kF) - 1;
    const int k_lo = kKV ? f0 : t0, k_hi = k_lo + (kKV ? kF : kT) - 1;
    const bool edge = q_hi >= Sq || k_hi >= Sk
                      || (a.causal && k_hi > off + q_lo && k_hi >= pre)
                      || (a.window > 0 && off + q_hi - k_lo >= a.window);
    const float inv_cap = a.softcap > 0.0f ? 1.0f / a.softcap : 0.0f;
#pragma unroll
    for (int n = 0; n < kXT; ++n) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int fr = wr + g8 + 8 * hf;             // fixed row in the tile
        const int tc = 8 * (kXT * wc + n) + 2 * t4;  // streamed row, and + 1
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int qi, kj;
          float lse_i, del_i;
          if constexpr (kKV) {
            qi = t0 + tc + e;
            kj = f0 + fr;
            lse_i = lse_t[tc + e];
            del_i = lse_t[kT + tc + e];
          } else {
            qi = f0 + fr;
            kj = t0 + tc + e;
            lse_i = rows[fr];
            del_i = rows[kF + fr];
          }
          if (!edge
              || (qi < Sq
                  && visible(off + qi, kj, Sk, a.causal, a.window, pre)))
            p_ds_tc(x[n][2 * hf + e], y[n][2 * hf + e], lse_i, del_i,
                    a.scale, a.softcap, inv_cap, p[e], ds[e]);
          else
            p[e] = ds[e] = 0.0f;
        }
        const int at = fr * kLdW + tc;
        uint32_t whi, wlo;
        split2(ds[0], ds[1], whi, wlo);
        *reinterpret_cast<uint32_t*>(w_dshi + at) = whi;
        *reinterpret_cast<uint32_t*>(w_dslo + at) = wlo;
        if constexpr (kKV) {
          split2(p[0], p[1], whi, wlo);
          *reinterpret_cast<uint32_t*>(w_phi + at) = whi;
          *reinterpret_cast<uint32_t*>(w_plo + at) = wlo;
        }
      }
    }
    __syncthreads();                 // P and dS staged

    // 3. acc_a += dS T_a, acc_b += P T_b (hi and lo), over the 32 rows
#pragma unroll
    for (int k0 = 0; k0 < kT; k0 += 16) {
      uint32_t whi[4], wlo[4];
      ldsm_a(whi, w_dshi, kLdW, wr, k0);
      ldsm_a(wlo, w_dslo, kLdW, wr, k0);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        const int n0 = 8 * (kCG * j + wc), n1 = n0 + 8 * kCG;
        if (n0 < a.D) {
          uint32_t bf[4];
          ldsm_trans_b2(bf, tas, ldA, k0, n0, n1 < a.D ? n1 : n0);
          mma_bf16(acc_a[j], whi, bf[0], bf[1]);
          mma_bf16(acc_a[j], wlo, bf[0], bf[1]);
          if (n1 < a.D) {
            mma_bf16(acc_a[j + 1], whi, bf[2], bf[3]);
            mma_bf16(acc_a[j + 1], wlo, bf[2], bf[3]);
          }
        }
      }
      if constexpr (kKV) {
        ldsm_a(whi, w_phi, kLdW, wr, k0);
        ldsm_a(wlo, w_plo, kLdW, wr, k0);
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          const int n0 = 8 * (kCG * j + wc), n1 = n0 + 8 * kCG;
          if (n0 < a.Dv) {
            uint32_t bf[4];
            ldsm_trans_b2(bf, tbs, ldB, k0, n0, n1 < a.Dv ? n1 : n0);
            mma_bf16(acc_b[j], whi, bf[0], bf[1]);
            mma_bf16(acc_b[j], wlo, bf[0], bf[1]);
            if (n1 < a.Dv) {
              mma_bf16(acc_b[j + 1], whi, bf[2], bf[3]);
              mma_bf16(acc_b[j + 1], wlo, bf[2], bf[3]);
            }
          }
        }
      }
    }
    __syncthreads();                 // stage st and the staging are free
  }
  cp_async_wait<0>();                // nothing in flight at exit

  // the warp's rows: fixed rows wr + g8 and + 8; columns 8 (kCG j + wc)
  // + 2 t4 of tile j
  const int splits = a.n_g * a.n_q;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = f0 + wr + g8 + 8 * hf;
    if (r >= (kKV ? Sk : Sq)) continue;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int c = 8 * (kCG * j + wc) + 2 * t4;
      if constexpr (kKV) {
        const long long row =
            (static_cast<long long>(b) * Sk + r) * a.Hkv + hk;
        const float k0 = acc_a[j][2 * hf] * a.scale,
                    k1 = acc_a[j][2 * hf + 1] * a.scale;
        const float v0 = acc_b[j][2 * hf], v1 = acc_b[j][2 * hf + 1];
        if (splits == 1) {
          if (c < a.D)
            *reinterpret_cast<__nv_bfloat162*>(a.dk + row * a.D + c) =
                __floats2bfloat162_rn(k0, k1);
          if (c < a.Dv)
            *reinterpret_cast<__nv_bfloat162*>(a.dv + row * a.Dv + c) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          // partial sp of (n_g n_q) at ws: dK's, then dV's
          const int sp = blk % splits;
          const long long nk =
              static_cast<long long>(a.B) * Sk * a.Hkv * a.D;
          const long long nv =
              static_cast<long long>(a.B) * Sk * a.Hkv * a.Dv;
          if (c < a.D)
            *reinterpret_cast<float2*>(a.ws + sp * nk + row * a.D + c) =
                make_float2(k0, k1);
          if (c < a.Dv)
            *reinterpret_cast<float2*>(a.ws + splits * nk + sp * nv
                                       + row * a.Dv + c) =
                make_float2(v0, v1);
        }
      } else {
        if (c < a.D)
          *reinterpret_cast<__nv_bfloat162*>(
              a.dq + ((static_cast<long long>(b) * Sq + r) * a.Hq + h) * a.D
              + c) = __floats2bfloat162_rn(acc_a[j][2 * hf] * a.scale,
                                           acc_a[j][2 * hf + 1] * a.scale);
      }
    }
  }
}

// dk[e] (and dv) = the sum of the n partials of element e, in order;
// 4 elements a thread (n_k and n_v are multiples of 8)
__global__ void __launch_bounds__(256)
sum_partials(const float* __restrict__ ws, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, long long n_k, long long n_v,
             int n) {
  const long long e =
      4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (e >= n_k + n_v) return;
  const bool is_k = e < n_k;
  const long long stride = is_k ? n_k : n_v;
  const float* src = is_k ? ws + e : ws + n * n_k + (e - n_k);
  float4 s = *reinterpret_cast<const float4*>(src);
  for (int i = 1; i < n; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(src + i * stride);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  __nv_bfloat16* dst = is_k ? dk + e : dv + (e - n_k);
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(s.x, s.y);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(s.z, s.w);
}

template <int kHD>
int launch_tc(const TcArgs& a, cudaStream_t stream) {
  const size_t smem_kv = tc_shared_bytes(a.D, a.Dv, true);
  const size_t smem_q = tc_shared_bytes(a.D, a.Dv, false);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_tc_kernel<kHD, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_tc_kernel<kHD, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = a.n_g * a.n_q;
  constexpr int kF = fixed_rows(kHD);
  const long long kv_blocks = static_cast<long long>((a.Sk + kF - 1) / kF)
                              * a.B * a.Hkv * splits;
  const long long q_blocks = static_cast<long long>((a.Sq + kF - 1) / kF)
                             * a.B * a.Hq;
  if (kv_blocks > INT_MAX || q_blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  bwd_tc_kernel<kHD, true>
      <<<static_cast<unsigned>(kv_blocks), kTcThreads, smem_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const long long n_k = static_cast<long long>(a.B) * a.Sk * a.Hkv * a.D;
    const long long n_v = static_cast<long long>(a.B) * a.Sk * a.Hkv * a.Dv;
    const long long blocks = ((n_k + n_v) / 4 + 255) / 256;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    sum_partials<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        a.ws, a.dk, a.dv, n_k, n_v, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bwd_tc_kernel<kHD, false>
      <<<static_cast<unsigned>(q_blocks), kTcThreads, smem_q, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// float32: delta, then the SIMT dK/dV and dQ kernels
int launch_simt(const float* q, const float* k, const float* v,
                const float* out, const float* dout, const float* lse,
                const int* prefix, float* delta, float* dq, float* dk,
                float* dv, int B, Dims a, cudaStream_t stream) {
  int err = launch_delta(out, dout, delta, B, a, stream);
  if (err != 0) return err;
  const size_t smem = bwd_shared_bytes(a.D, a.Dv);
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gkv((a.Sk + kBK - 1) / kBK, a.Hkv, B);
  dkdv_kernel<<<gkv, kThreads, smem, stream>>>(q, k, v, dout, lse,
                                                      delta, prefix, dk, dv,
                                                      a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gq((a.Sq + kBQ - 1) / kBQ, a.Hq, B);
  dq_kernel<<<gq, kThreads, smem, stream>>>(q, k, v, dout, lse, delta,
                                                   prefix, dq, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bwd_max_head_dim() { return kMaxD; }

// Dynamic shared memory of one bfloat16 block: the dK/dV pass (kv != 0)
// or the dQ pass, at head dims D, Dv.
extern "C" long long flash_attention_bwd_shared_bytes(int D, int Dv, int kv) {
  return static_cast<long long>(tc_shared_bytes(D, Dv, kv != 0));
}

// dtype 0 = float32 (three launches: delta, dK/dV, dQ; n_g, n_q and ws
// unused), 1 = bfloat16 (delta, dK/dV in n_g x n_q splits, their sum when
// n_g n_q > 1, dQ; ws float32 (n_g n_q) B S Hkv (D + Dv), null when not
// split). q, k, v, out, dout, dq, dk, dv in that type; lse and delta
// (scratch, written here) float32 (B, Hq, Sq); Sq query rows at positions
// q_off .. q_off + Sq - 1 against Sk keys (0 <= q_off, q_off + Sq <= Sk,
// else cudaErrorInvalidValue); ws float32 (n_g n_q) B Sk Hkv (D + Dv);
// prefix null or int32 (B,), read only when causal; window <= 0: none;
// softcap <= 0: none. Launch
// on `stream`; returns the first CUDA error (0 = ok). bfloat16 needs head
// dims that are multiples of 8 and q, k, v, dout 16-byte aligned (the
// rule of flash_attention_fits). The caller has checked shapes (Hq a
// multiple of Hkv, head dims at most kMaxD, G a multiple of n_g), types
// and contiguity, and that B, Sq and the heads are non-zero.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const float* lse,
                                   const int* prefix, float* delta,
                                   void* dq, void* dk, void* dv, float* ws,
                                   int B, int Sq, int Sk, int Hq, int Hkv,
                                   int D, int Dv, int q_off, float scale,
                                   int causal, int window, float softcap,
                                   int n_g, int n_q, int dtype,
                                   void* stream) {
  if (D > kMaxD || Dv > kMaxD || Hkv <= 0 || Hq % Hkv || q_off < 0
      || q_off > Sk - Sq)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims a{Sq, Sk, q_off, Hq, Hkv, D, Dv, scale, causal, window,
               softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_simt(static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const float*>(out),
                       static_cast<const float*>(dout), lse, prefix, delta,
                       static_cast<float*>(dq), static_cast<float*>(dk),
                       static_cast<float*>(dv), B, a, s);
  if (dtype != 1 || D % 8 || Dv % 8 || n_g < 1 || n_q < 1
      || (Hq / Hkv) % n_g || (n_g * n_q > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return static_cast<int>(cudaErrorMisalignedAddress);
  using bf16 = __nv_bfloat16;
  int err = launch_delta(static_cast<const bf16*>(out),
                         static_cast<const bf16*>(dout), delta, B, a, s);
  if (err != 0) return err;
  const TcArgs t{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                 lse, delta, prefix, static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk), static_cast<bf16*>(dv), ws, B, Sq,
                 Sk, q_off, Hq, Hkv, D, Dv, scale, causal, window, softcap,
                 n_g, n_q};
  const int hd = D > Dv ? D : Dv;
  if (hd <= 64) return launch_tc<64>(t, s);
  if (hd <= 96) return launch_tc<96>(t, s);
  if (hd <= 128) return launch_tc<128>(t, s);
  return launch_tc<256>(t, s);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
