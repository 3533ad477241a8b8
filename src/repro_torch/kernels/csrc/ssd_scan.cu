// ssd_scan — the Mamba-2 SSD chunked scan, one block per (batch, head)
//
// For each (b, h), over chunks of `chunk` positions, with the (P, N) state
// carried from chunk to chunk (zero before the first):
//
//   dA = dt * A                  cs = inclusive cumsum of dA in the chunk
//   M[q, k] = (C_q . B_k) * exp(cs_q - cs_k) * dt_k    (k <= q, else 0)
//   y[q]    = M x + exp(cs_q) * (C_q . state)
//   state   = state * exp(cs_end) + sum_k x_k ((exp(cs_end - cs_k) dt_k) B_k)
//
// x (B, S, H, P), dt (B, S, H) float32, A (H,) float32, B/C (B, S, G, N),
// y (B, S, H, P), final state (B, H, P, N); x, B, C, y and the state all
// float32 or all bfloat16, contiguous. Head h reads group h / (H / G) of
// B and C in place (the Pallas wrapper repeated them in memory). Any S:
// the ragged last chunk behaves as dt = 0 padding, and y is written only
// at real positions. Everything between the loads and the final casts is
// float32; the cumsum is summed in float64 and rounded once, so its value
// does not depend on the order of the sum.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan (Pallas
// body _ssd_kernel), whose grid (B*H, n_chunks) walked the chunks of one
// (b, h) in order on one core and carried the state in VMEM scratch from
// grid step to grid step, and which needed S to be a multiple of chunk.
//
// What bounds it on this card. At mamba2-780m's prefill of 4 x 512 tokens
// (H = 48, P = 64, N = 128, chunk 256) the function needs 8.1 GFLOP (the
// causal half of each chunk's Q x Q dual form, L (L + 1) / 2 pairs, plus
// the state's products) and moves 29.8 MB of inputs and outputs: 8.2 us
// at 989 TFLOP/s against 8.9 us at 3.35 TB/s, so bytes; at one 4000-token
// prompt the two are even (15.8 us). This kernel uses no tensor cores:
// float32 FMAs fed from shared memory keep it far from that bound; it is
// the simple, exact version that later work makes fast (wgmma tiles, TMA,
// chunks split across blocks with a second pass for the carry). No
// PyTorch call computes an SSD scan, so there is no library time to
// compare it with.
//
// What the design does about it.
//  * The TPU's sequential chunk axis becomes a loop inside the block, so
//    the state never leaves shared memory: (P, N + 1) floats, 33 KB at
//    P = 64, N = 128.
//  * A chunk is cut into tiles of 64 positions. For each query tile, the
//    key tiles up to the diagonal only (causal: the tiles above it are
//    all masked) give C B^T (64 x 64, reduced over N), scaled into M in
//    shared memory, then M x accumulates in registers; then the state's
//    contribution is added and the tile's y rows are stored. A last pass
//    over the key tiles accumulates the state update in registers.
//  * 256 threads as a 16 x 16 grid: a thread owns rows ty + 16 i and
//    columns tx + 16 j of every 64-row product (4 x 4 outputs; 4 x 8 for
//    the (P, N) state update), so the row operand is a broadcast and the
//    column operand is read by 16 lanes at consecutive addresses. Rows of
//    the C, B and state arrays are padded by one float, so the 16 lanes
//    reading one column of B or of the state fall in different banks.
//  * Positions past S (and past the chunk's end) load as zeros, take no
//    part in the product and are never stored.
//  * About 131 KB of shared memory at P = 64, N = 128 (one block per SM,
//    8 warps); 82 KB at N = 64 (two blocks per SM).
//  * No atomics: every output element is written once by one thread, and
//    the result does not depend on scheduling.
//  * bfloat16 is converted only with the intrinsics; no --use_fast_math
//    (expf is the accurate one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // positions of a query / key tile
constexpr int kLanes = 16;         // the thread grid is kLanes x kLanes
constexpr int kRows = kTile / kLanes;        // 4 rows per thread
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kColsP = kMaxP / kLanes;       // 4
constexpr int kColsN = kMaxN / kLanes;       // 8
constexpr int kMaxShared = 232448;           // bytes a block may opt into

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

// rows [0, rows) of a tile from `src` (row stride `stride`, `cols` values
// a row) into `dst` (row stride `ld`), rows [rows, kTile) as zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long stride, int rows,
                                          int cols) {
  for (int i = threadIdx.x; i < kTile * cols; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ld + c] = r < rows ? to_f32(src[r * stride + c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                T* __restrict__ state_out, int S, int H, int P, int G, int N,
                int chunk) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* c_s = smem;                        // kTile x ldn
  float* b_s = c_s + kTile * ldn;           // kTile x ldn
  float* x_s = b_s + kTile * ldn;           // kTile x P
  float* m_s = x_s + kTile * P;             // kTile x kTile
  float* st_s = m_s + kTile * kTile;        // P x ldn
  float* dt_s = st_s + P * ldn;             // chunk
  float* cs_s = dt_s + chunk;               // chunk

  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid / kLanes, tx = tid % kLanes;
  const float a = A[h];
  const long long x_stride = static_cast<long long>(H) * P;
  const long long bc_stride = static_cast<long long>(G) * N;
  const T* xb = x + static_cast<long long>(b) * S * x_stride +
                static_cast<long long>(h) * P;
  T* yb = y + static_cast<long long>(b) * S * x_stride +
          static_cast<long long>(h) * P;
  const float* dtb = dt + static_cast<long long>(b) * S * H + h;
  const T* Bb = Bm + static_cast<long long>(b) * S * bc_stride +
                static_cast<long long>(grp) * N;
  const T* Cb = Cm + static_cast<long long>(b) * S * bc_stride +
                static_cast<long long>(grp) * N;

  for (int i = tid; i < P * ldn; i += kThreads) st_s[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int len = min(chunk, S - c0);
    __syncthreads();                // the last chunk is done with dt_s, cs_s
    for (int i = tid; i < len; i += kThreads)
      dt_s[i] = dtb[static_cast<long long>(c0 + i) * H];
    __syncthreads();
    // inclusive cumsum of dA = dt * A in float64: each lane of warp 0
    // sums a run of positions, a shuffle scan offsets the runs
    if (tid < 32) {
      const int per = (len + 31) / 32;
      const int lo = min(tid * per, len), hi = min(lo + per, len);
      double run = 0.0;
      for (int i = lo; i < hi; ++i)
        run += static_cast<double>(__fmul_rn(dt_s[i], a));
      double incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      double acc = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) acc = 0.0;
      for (int i = lo; i < hi; ++i) {
        acc += static_cast<double>(__fmul_rn(dt_s[i], a));
        cs_s[i] = static_cast<float>(acc);
      }
    }
    __syncthreads();
    const float cs_end = cs_s[len - 1];
    const int n_tiles = (len + kTile - 1) / kTile;
    const T* xc = xb + static_cast<long long>(c0) * x_stride;
    const T* Bc = Bb + static_cast<long long>(c0) * bc_stride;
    const T* Cc = Cb + static_cast<long long>(c0) * bc_stride;

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      load_tile(c_s, ldn, Cc + q0 * bc_stride, bc_stride,
                min(kTile, len - q0), N);
      float acc[kRows][kColsP] = {};
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kTile;
        const int kn = min(kTile, len - k0);
        load_tile(b_s, ldn, Bc + k0 * bc_stride, bc_stride, kn, N);
        load_tile(x_s, P, xc + k0 * x_stride, x_stride, kn, P);
        __syncthreads();
        // C B^T for this (query, key) tile pair
        float cb[kRows][kRows] = {};
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[kRows], bv[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            cv[i] = c_s[(ty + kLanes * i) * ldn + n];
            bv[i] = b_s[(tx + kLanes * i) * ldn + n];
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kRows; ++j)
              cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
        }
        // M = (C B^T * exp(cs_q - cs_k)) * dt_k on and below the diagonal
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = ty + kLanes * i, q = q0 + r;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int kk = tx + kLanes * j, k = k0 + kk;
            float m = 0.0f;
            if (k <= q && q < len)
              m = (cb[i][j] * expf(cs_s[q] - cs_s[k])) * dt_s[k];
            m_s[r * kTile + kk] = m;
          }
        }
        __syncthreads();
        // y += M x
        for (int kk = 0; kk < kn; ++kk) {
          float mv[kRows], xv[kColsP];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            mv[i] = m_s[(ty + kLanes * i) * kTile + kk];
#pragma unroll
          for (int j = 0; j < kColsP; ++j) {
            const int p = tx + kLanes * j;
            xv[j] = p < P ? x_s[kk * P + p] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kColsP; ++j)
              acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
        }
        __syncthreads();            // b_s, x_s, m_s are refilled next
      }
      // the carried state's part: exp(cs_q) * (C_q . state)
      float off[kRows][kColsP] = {};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[kRows], sv[kColsP];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          cv[i] = c_s[(ty + kLanes * i) * ldn + n];
#pragma unroll
        for (int j = 0; j < kColsP; ++j) {
          const int p = tx + kLanes * j;
          sv[j] = p < P ? st_s[p * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kColsP; ++j)
            off[i][j] = fmaf(cv[i], sv[j], off[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q = q0 + ty + kLanes * i;
        if (q >= len) continue;
        const float e = expf(cs_s[q]);
        T* yrow = yb + static_cast<long long>(c0 + q) * x_stride;
#pragma unroll
        for (int j = 0; j < kColsP; ++j) {
          const int p = tx + kLanes * j;
          if (p < P) yrow[p] = from_f32<T>(acc[i][j] + e * off[i][j]);
        }
      }
      __syncthreads();              // c_s is refilled by the next tile
    }

    // state update: sum_k x_k^T ((exp(cs_end - cs_k) * dt_k) * B_k)
    float upd[kColsP][kColsN] = {};
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kTile;
      const int kn = min(kTile, len - k0);
      load_tile(x_s, P, xc + k0 * x_stride, x_stride, kn, P);
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        float v = 0.0f;
        if (r < kn) {
          const int k = k0 + r;
          const float w = expf(cs_end - cs_s[k]) * dt_s[k];
          v = w * to_f32(Bc[(k0 + r) * bc_stride + n]);
        }
        b_s[r * ldn + n] = v;
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        float xv[kColsP], bv[kColsN];
#pragma unroll
        for (int i = 0; i < kColsP; ++i) {
          const int p = ty + kLanes * i;
          xv[i] = p < P ? x_s[kk * P + p] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kColsN; ++j) {
          const int n = tx + kLanes * j;
          bv[j] = n < N ? b_s[kk * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kColsP; ++i)
#pragma unroll
          for (int j = 0; j < kColsN; ++j)
            upd[i][j] = fmaf(xv[i], bv[j], upd[i][j]);
      }
      __syncthreads();
    }
    const float decay = expf(cs_end);
#pragma unroll
    for (int i = 0; i < kColsP; ++i) {
      const int p = ty + kLanes * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < kColsN; ++j) {
        const int n = tx + kLanes * j;
        if (n < N) st_s[p * ldn + n] = st_s[p * ldn + n] * decay + upd[i][j];
      }
    }
  }
  __syncthreads();
  T* out = state_out + (static_cast<long long>(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    out[i] = from_f32<T>(st_s[p * ldn + n]);
  }
}

// shared memory of one block: the C and B tiles (N + 1 floats a row), the
// x tile, the tile of M, the (P, N + 1) state, dt and the cumsum of a chunk
long long shared_bytes(int P, int N, int chunk) {
  return 4LL * (2 * kTile * (N + 1) + kTile * P + kTile * kTile +
                P * (N + 1) + 2LL * chunk);
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, void* y, void* state, int batch, int S, int H,
           int P, int G, int N, int chunk, cudaStream_t stream) {
  // per launch: the attribute belongs to the current device
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(batch));
  ssd_scan_kernel<T><<<grid, kThreads, shared_bytes(P, N, chunk), stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), static_cast<T*>(state),
      S, H, P, G, N, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// What the kernel takes: 0 if P, N and chunk are within its limits, else
// 1 (P > kMaxP), 2 (N > kMaxN) or 3 (more shared memory than a block may
// opt into). The guard in Python reports these; the launch refuses them.
extern "C" int ssd_scan_fits(int P, int N, int chunk) {
  if (P > kMaxP) return 1;
  if (N > kMaxN) return 2;
  if (shared_bytes(P, N, chunk) > kMaxShared) return 3;
  return 0;
}

extern "C" int ssd_scan_max_head_dim() { return kMaxP; }
extern "C" int ssd_scan_max_state() { return kMaxN; }
extern "C" int ssd_scan_max_shared_bytes() { return kMaxShared; }
extern "C" long long ssd_scan_shared_bytes(int P, int N, int chunk) {
  return shared_bytes(P, N, chunk);
}

// dtype codes: 0 = float32, 1 = bfloat16 (x, B, C, y and state). Launch
// on `stream`; returns the CUDA error after the launch (0 = ok). The
// caller has checked shapes (G divides H, ssd_scan_fits), types and
// contiguity, and that B, S, H, P, N are non-zero.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, void* y, void* state,
                        int batch, int S, int H, int P, int G, int N,
                        int chunk, int dtype, void* stream) {
  if (ssd_scan_fits(P, N, chunk) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  if (dtype == 0)
    return launch<float>(x, dtf, Af, B, C, y, state, batch, S, H, P, G, N,
                         chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, Af, B, C, y, state, batch, S, H, P,
                                 G, N, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
