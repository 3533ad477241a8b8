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
// forward's mask: key j is visible from query i iff j < S, when causal
// j <= i or j < prefix[b], and i - j < window when a window is set. q
// (B, S, Hq, D), k (B, S, Hkv, D), v (B, S, Hkv, Dv), out and dout (B, S,
// Hq, Dv), all float32 or all bfloat16 and contiguous; lse (B, Hq, S)
// float32 from the forward. dq, dk, dv come out in the inputs' type;
// every product and sum is float32.
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
// The design is the simple one, on float32 SIMT arithmetic (tensor cores,
// TMA and wgmma are later work):
//  * delta: one warp per (b, i, h) row, a shuffle sum.
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
//  * S and dP are computed twice (once in each kernel): the cost of
//    writing dQ without atomics. No atomics anywhere: every output element
//    is summed by one thread in a fixed order, so two launches give equal
//    bits.
//  * Shared arrays of D + 1 floats a row, so the 8 keys or the 4 rows a
//    warp reads at once fall in distinct banks. At D = Dv = 256 a block
//    holds 140 KB of shared memory.
//  * Accurate expf and tanhf, no --use_fast_math; bf16 converted with the
//    intrinsics only.

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

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int i, int j, int S, int causal,
                                        int window, int pre) {
  return j < S && (!causal || j <= i || j < pre)
         && (window <= 0 || i - j < window);
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
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int b, int r0, int n, int S, int H,
                                          int h, int d) {
  for (int e = threadIdx.x; e < n * d; e += kThreads) {
    const int r = e / d, c = e - r * d, s = r0 + r;
    dst[r * ld + c] =
        s < S ? to_f32(src[((static_cast<long long>(b) * S + s) * H + h) * d
                           + c])
              : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kDeltaRows * 32)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int S, int Hq,
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
    // row = (b S + i) Hq + h  ->  delta[(b Hq + h) S + i]
    const long long bi = row / Hq;
    const int h = static_cast<int>(row - bi * Hq);
    const long long b = bi / S;
    const int i = static_cast<int>(bi - b * S);
    delta[(b * Hq + h) * S + i] = acc;
  }
}

struct Dims {
  int S, Hq, Hkv, D, Dv;
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

// one block per (32-key tile, kv head, batch): dK and dV of the tile
template <typename T>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ prefix, T* __restrict__ dk,
            T* __restrict__ dv, Dims a) {
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
  const int S = a.S;
  const int pre = prefix != nullptr ? prefix[b] : 0;
  const int tid = threadIdx.x;
  const int r = tid >> 3;            // score row / accumulator key
  const int c8 = tid & 7;            // score key lane / accumulator column

  load_rows(ks, ldq, k, b, kv0, kBK, S, a.Hkv, hk, a.D);
  load_rows(vs, ldo, v, b, kv0, kBK, S, a.Hkv, hk, a.Dv);

  // query rows [q_lo, q_hi) can see some key of the tile
  int q_lo = 0, q_hi = S;
  if (a.causal && kv0 >= pre) q_lo = kv0;
  if (a.window > 0) q_hi = min(S, kv0 + kBK - 1 + a.window);

  float acc_k[kCols], acc_v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc_k[c] = acc_v[c] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* lse_h = lse + (static_cast<long long>(b) * a.Hq + h) * S;
    const float* del_h = delta + (static_cast<long long>(b) * a.Hq + h) * S;
    for (int q0 = (q_lo / kBQ) * kBQ; q0 < q_hi; q0 += kBQ) {
      __syncthreads();               // the previous tile is no longer read
      load_rows(qs, ldq, q, b, q0, kBQ, S, a.Hq, h, a.D);
      load_rows(dos, ldo, dout, b, q0, kBQ, S, a.Hq, h, a.Dv);
      if (tid < kBQ) {
        lse_s[tid] = q0 + tid < S ? lse_h[q0 + tid] : 0.0f;
        del_s[tid] = q0 + tid < S ? del_h[q0 + tid] : 0.0f;
      }
      __syncthreads();

      float raw[4], dp[4];
      scores(qs, dos, ks, vs, ldq, ldo, r, c8, a.D, a.Dv, raw, dp);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = c8 + 8 * c, i = q0 + r;
        float p, ds;
        p_ds(raw[c], dp[c], lse_s[r], del_s[r], a.scale, a.softcap,
             i < S && visible(i, kv0 + j, S, a.causal, a.window, pre), p,
             ds);
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
  if (j < S) {
    const long long row = (static_cast<long long>(b) * S + j) * a.Hkv + hk;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = c8 + 8 * c;
      if (d < a.D) dk[row * a.D + d] = from_f32<T>(acc_k[c] * a.scale);
      if (d < a.Dv) dv[row * a.Dv + d] = from_f32<T>(acc_v[c]);
    }
  }
}

// one block per (32-row query tile, q head, batch): dQ of the tile
template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ prefix, T* __restrict__ dq, Dims a) {
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
  const int S = a.S;
  const int pre = prefix != nullptr ? prefix[b] : 0;
  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int c8 = tid & 7;

  load_rows(qs, ldq, q, b, q0, kBQ, S, a.Hq, h, a.D);
  load_rows(dos, ldo, dout, b, q0, kBQ, S, a.Hq, h, a.Dv);
  if (tid < kBQ) {
    const long long at = (static_cast<long long>(b) * a.Hq + h) * S + q0
                         + tid;
    lse_s[tid] = q0 + tid < S ? lse[at] : 0.0f;
    del_s[tid] = q0 + tid < S ? delta[at] : 0.0f;
  }

  // keys [lo, hi) can be visible from some row of this tile
  int lo = 0, hi = S;
  if (a.window > 0) lo = max(0, q0 - a.window + 1);
  if (a.causal) hi = min(S, max(pre, q0 + kBQ));

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;

  for (int kv0 = (lo / kBK) * kBK; kv0 < hi; kv0 += kBK) {
    __syncthreads();                 // the previous tile is no longer read
    load_rows(ks, ldq, k, b, kv0, kBK, S, a.Hkv, hk, a.D);
    load_rows(vs, ldo, v, b, kv0, kBK, S, a.Hkv, hk, a.Dv);
    __syncthreads();

    float raw[4], dp[4];
    scores(qs, dos, ks, vs, ldq, ldo, r, c8, a.D, a.Dv, raw, dp);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = c8 + 8 * c, i = q0 + r;
      float p, ds;
      p_ds(raw[c], dp[c], lse_s[r], del_s[r], a.scale, a.softcap,
           i < S && visible(i, kv0 + j, S, a.causal, a.window, pre), p, ds);
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
  if (i < S) {
    T* row = dq + ((static_cast<long long>(b) * S + i) * a.Hq + h) * a.D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = c8 + 8 * c;
      if (d < a.D) row[d] = from_f32<T>(acc[c] * a.scale);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, const int* prefix,
           float* delta, void* dq, void* dk, void* dv, int B, Dims a,
           cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * a.S * a.Hq;
  const long long dblocks = (rows + kDeltaRows - 1) / kDeltaRows;
  if (dblocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<unsigned>(dblocks), kDeltaRows * 32, 0,
                    stream>>>(static_cast<const T*>(out),
                              static_cast<const T*>(dout), delta, rows, a.S,
                              a.Hq, a.Dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = bwd_shared_bytes(a.D, a.Dv);
  err = cudaFuncSetAttribute(dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gkv((a.S + kBK - 1) / kBK, a.Hkv, B);
  dkdv_kernel<T><<<gkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      prefix, static_cast<T*>(dk), static_cast<T*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gq((a.S + kBQ - 1) / kBQ, a.Hq, B);
  dq_kernel<T><<<gq, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      prefix, static_cast<T*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bwd_max_head_dim() { return kMaxD; }

// Three launches on `stream`: delta, dK/dV, dQ. dtype 0 = float32, 1 =
// bfloat16 (q, k, v, out, dout, dq, dk, dv alike); lse and delta (scratch,
// written here) float32 (B, Hq, S); prefix null or int32 (B,), read only
// when causal; window <= 0: none; softcap <= 0: none. Returns the first
// CUDA error (0 = ok). The caller has checked shapes (Hq a multiple of
// Hkv, head dims at most kMaxD), types and contiguity, and that B, S and
// the heads are non-zero.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const float* lse,
                                   const int* prefix, float* delta,
                                   void* dq, void* dk, void* dv, int B,
                                   int S, int Hq, int Hkv, int D, int Dv,
                                   float scale, int causal, int window,
                                   float softcap, int dtype, void* stream) {
  if (D > kMaxD || Dv > kMaxD || Hkv <= 0 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims a{S, Hq, Hkv, D, Dv, scale, causal, window, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, dout, lse, prefix, delta, dq, dk, dv,
                         B, a, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, dout, lse, prefix, delta, dq,
                                 dk, dv, B, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
