// ssd_scan — the Mamba-2 SSD chunked scan, in three passes
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
// B and C in place. Any S: the ragged last chunk behaves as dt = 0
// padding, and y is written only at real positions. Everything between
// the loads and the final casts is float32; the cumsum is summed in
// float64 and rounded once, so its value does not depend on the order of
// the sum.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan (Pallas
// body _ssd_kernel), whose grid (B*H, n_chunks) walked the chunks of one
// (b, h) in order on one core and carried the state in VMEM scratch from
// grid step to grid step, and which needed S to be a multiple of chunk.
//
// What bounds it on this card. At mamba2-780m's prefill of 4 x 512 tokens
// (H = 48, P = 64, N = 128, chunk 256) the function needs 8.1 GFLOP (the
// causal half of each chunk's Q x Q dual form plus the state's products)
// and moves 29.8 MB: 0.0082 ms at 989 TFLOP/s against 0.0089 ms at
// 3.35 TB/s, so bytes; at one 4000-token prompt (run B) 0.0158 ms of
// operations; zamba2-7b's (2, 700, 112, 64), N = 64, 0.0128 ms of bytes.
// The kernel this file replaced took one block per (b, h) that walked all
// chunks in order: 48 blocks on 132 SMs at mamba2's 48 heads, every
// product a float32 FMA from shared memory, 4.02 ms at run B (255x).
//
// What the design does about it: the SSD algorithm's own split, so that
// the chunks of one (b, h) run in parallel and only an elementwise carry
// is sequential.
//  1. Chunk state, grid (chunk, h, b). The chunk's cumsum of dt * A
//     (float64, rounded once) goes to scratch for pass 3, which reads
//     exactly these rounded values. The chunk's local state
//     sum_k x_k (w_k B_k), w_k = exp(cs_end - cs_k) dt_k, goes to scratch
//     as (P, N) float32.
//  2. Carry, one thread per (b, h, p, n), sequential over the chunks:
//     state_in[c] = state_in[c-1] * exp(cs_end[c-1]) + local[c-1] (the
//     expression the single-pass kernel evaluated per chunk), written in
//     place of local[c] (float32), or as its bf16 hi + lo split, the
//     operand pass 3 loads; then the final state.
//  3. Chunk scan, grid (chunk, 64-row query tile, b * h), causal key tiles
//     only: y = (C B^T * L * dt) x + exp(cs_q) (C state_in^T).
// In bfloat16 the products run on the tensor cores with mma.sync m16n8k16
// (bf16 operands, float32 sums). Not wgmma: the operands of M x and of the
// local state are float32 values split into bf16 hi + lo, which mma.sync
// takes straight from registers in its documented fragment layout (M never
// goes through shared memory), and the tiles are small (a warp's 16 query
// rows by 64 keys, P <= 64) while the grid has 768-3,000 blocks to fill the
// SMs with; the bound is bytes or near it, so the tensor cores' peak is not
// what limits the passes. C B^T is exact bf16 products; M, the state and
// w B each split into hi + lo bf16, so the products keep about 16 bits of
// each float32 operand (relative error below 2^-17), within the 2-ulp
// bf16 gate. The x, B and C tiles and the split state are copied with
// cp.async, 16 bytes a copy, zero filled past the edges, where their rows
// are aligned (else element by element); x stays [key][p] as in memory and
// ldmatrix.trans reads it as the transposed operand. Row strides of 72 and
// 136 bf16 keep every fragment load free of bank conflicts. float32
// inputs keep SIMT FMAs (the single-pass kernel's 16 x 16 thread grid)
// but take the same three passes.
//  * Positions past S (and past a chunk's end) load as zeros, take no part
//    in a product and are never stored.
//  * No atomics: every output element is written once by one thread, and
//    the result does not depend on scheduling.
//  * bfloat16 is converted with the intrinsics; no --use_fast_math (expf
//    is the accurate one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // positions of a query / key tile
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxShared = 232448;           // bytes a block may opt into

// float32 (SIMT): a 16 x 16 thread grid over 64-row products
constexpr int kThreads = 256;
constexpr int kLanes = 16;
constexpr int kRows = kTile / kLanes;        // 4 rows per thread
constexpr int kColsP = kMaxP / kLanes;       // 4
constexpr int kColsN = kMaxN / kLanes;       // 8

// bfloat16 (tensor cores)
constexpr int kScanThreads = 128;            // pass 3: 4 warps x 16 query rows
constexpr int kStateThreads = 256;           // pass 1: 4 x 2 warps over (P, N)
constexpr int kLdN = kMaxN + 8;              // bf16 row stride over N
constexpr int kLdK = kTile + 8;              // bf16 row stride over 64 keys
                                             // (or over P <= 64)

union Pack8 {                                // 8 bf16 as one 16-byte load
  uint4 u;
  uint16_t h[8];
};

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ uint16_t f32_to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// v = hi + lo + r with |r| <= 2^-17 |v|: v - hi is exact in float32
__device__ __forceinline__ void split_bf16(float v, uint16_t& hi,
                                           uint16_t& lo) {
  hi = f32_to_bf16(v);
  lo = f32_to_bf16(v - bf16_to_f32(hi));
}

__device__ __forceinline__ uint32_t pack2(uint16_t first, uint16_t second) {
  return static_cast<uint32_t>(first) | (static_cast<uint32_t>(second) << 16);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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
// row-major bf16 tile with row stride ld.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint16_t* s,
                                       int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint16_t* p = s + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// d += A * B^T-tile: B stored as rows n0 .. n0 + 7 of a [n][k] tile
__device__ __forceinline__ void mma_rows(float (&d)[4], const uint32_t (&a)[4],
                                         const uint16_t* s, int ld, int n0,
                                         int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint16_t* p = s + (n0 + g) * ld + k0 + 2 * t;
  mma_bf16(d, a, ld32(p), ld32(p + 8));
}

// 8 bf16 from src (n_valid of them real, the rest zero)
__device__ __forceinline__ uint4 load8(const uint16_t* src, int n_valid,
                                       bool vec) {
  Pack8 v;
  v.u = make_uint4(0, 0, 0, 0);
  if (vec && n_valid >= 8) {
    v.u = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n_valid) v.h[j] = src[j];
  }
  return v.u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

// the calling thread's cp.async copies have landed (a __syncthreads()
// must follow before other threads read them)
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A 64-row tile, rows [0, rows) from src (row stride `stride`, `cols`
// values a row), into dst [r][c] (row stride ld), zeros up to colsp
// columns (a multiple of 8) and 64 rows. Aligned rows (`vec`: cols a
// multiple of 8, 16-byte aligned) go by cp.async, 16 bytes a copy, zero
// filled past the edge; the caller waits with cp_async_wait(). Else
// element by element through registers.
__device__ void load_rows(uint16_t* dst, int ld, const uint16_t* src,
                          long long stride, int rows, int cols, int colsp,
                          bool vec) {
  const int groups = colsp / 8;
  for (int i = threadIdx.x; i < kTile * groups; i += blockDim.x) {
    const int r = i / groups, c = (i - r * groups) * 8;
    if (vec) {
      const bool live = r < rows && c < cols;
      cp_async16(dst + r * ld + c, live ? src + r * stride + c : src,
                 live ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          r < rows ? load8(src + r * stride + c, cols - c, false)
                   : make_uint4(0, 0, 0, 0);
    }
  }
}

// Fragments of a tile stored [k][m] (row stride ld, k the reduction),
// read transposed by ldmatrix: the A fragment of rows m0 .. m0 + 15 and
// k0 .. k0 + 15 (x^T in pass 1), or the B fragment of n0 .. n0 + 7 and
// k0 .. k0 + 15 (x in M x).
__device__ __forceinline__ void ldsm_trans_a(uint32_t (&a)[4],
                                             const uint16_t* s, int ld,
                                             int m0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
      s + (k0 + (q >> 1) * 8 + i) * ld + m0 + (q & 1) * 8));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_trans_b(uint32_t& b0, uint32_t& b1,
                                             const uint16_t* s, int ld,
                                             int n0, int k0) {
  const int lane = threadIdx.x & 31, q = (lane >> 3) & 1, i = lane & 7;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
      s + (k0 + q * 8 + i) * ld + n0));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1) : "r"(addr));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ uint16_t from_f32<uint16_t>(float x) {
  return f32_to_bf16(x);
}

// dt of positions [0, len) of a chunk into dt_s, and the inclusive cumsum
// of dt * a, summed in float64 and rounded once, into cs_s and cs_out:
// each lane of warp 0 sums a run of positions, a shuffle scan offsets
// the runs.
__device__ void chunk_cumsum(const float* dtc, int H, int len, float a,
                             float* dt_s, float* cs_s, float* cs_out) {
  const int tid = threadIdx.x;
  for (int i = tid; i < len; i += blockDim.x)
    dt_s[i] = dtc[static_cast<long long>(i) * H];
  __syncthreads();
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
      cs_out[i] = cs_s[i];
    }
  }
  __syncthreads();
}

// Offsets of one (b, h, chunk) shared by the passes.
struct Chunk {
  int b, h, grp, c, c0, len;
  long long x_off, bc_off, dt_off, scratch;  // scratch: (b * H + h) * nc + c
};

__device__ __forceinline__ Chunk chunk_of(int b, int h, int c, int S, int H,
                                          int P, int G, int N, int chunk,
                                          int nc) {
  Chunk k;
  k.b = b;
  k.h = h;
  k.grp = h / (H / G);
  k.c = c;
  k.c0 = c * chunk;
  k.len = min(chunk, S - k.c0);
  const long long pos = static_cast<long long>(b) * S + k.c0;
  k.x_off = pos * H * P + static_cast<long long>(h) * P;
  k.bc_off = pos * G * N + static_cast<long long>(k.grp) * N;
  k.dt_off = pos * H + h;
  k.scratch = (static_cast<long long>(b) * H + h) * nc + c;
  return k;
}

// ---------------------------------------------------------------------------
// pass 1: the chunk's cumsum and local state
// ---------------------------------------------------------------------------

// kGrad: the backward's state gradient of the chunk, sum_q dy_q^T
// (exp(cs_q) C_q), from x = dy and Bm = C (same shapes, same passes).
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
chunk_state_f32(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                float* __restrict__ cs_g, float* __restrict__ local, int S,
                int H, int P, int G, int N, int chunk, int nc) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* x_s = smem;                         // kTile x P
  float* b_s = x_s + kTile * P;              // kTile x ldn
  float* dt_s = b_s + kTile * ldn;           // chunk
  float* cs_s = dt_s + chunk;                // chunk
  const Chunk k = chunk_of(blockIdx.z, blockIdx.y, blockIdx.x, S, H, P, G, N,
                           chunk, nc);
  const int tid = threadIdx.x, ty = tid / kLanes, tx = tid % kLanes;
  const long long x_stride = static_cast<long long>(H) * P;
  const long long bc_stride = static_cast<long long>(G) * N;
  const float* xc = x + k.x_off;
  const float* Bc = Bm + k.bc_off;
  chunk_cumsum(dt + k.dt_off, H, k.len, A[k.h], dt_s, cs_s,
               cs_g + k.scratch * chunk);
  const float cs_end = cs_s[k.len - 1];

  // sum_k x_k^T ((exp(cs_end - cs_k) * dt_k) * B_k)
  float upd[kColsP][kColsN] = {};
  for (int k0 = 0; k0 < k.len; k0 += kTile) {
    const int kn = min(kTile, k.len - k0);
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      x_s[i] = r < kn ? xc[(k0 + r) * x_stride + p] : 0.0f;
    }
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      float v = 0.0f;
      if (r < kn) {
        const int q = k0 + r;
        const float w = kGrad ? expf(cs_s[q])
                              : expf(cs_end - cs_s[q]) * dt_s[q];
        v = w * Bc[q * bc_stride + n];
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
  float* out = local + k.scratch * P * N;
#pragma unroll
  for (int i = 0; i < kColsP; ++i) {
    const int p = ty + kLanes * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < kColsN; ++j) {
      const int n = tx + kLanes * j;
      if (n < N) out[p * N + n] = upd[i][j];
    }
  }
}

template <bool kGrad>
__global__ void __launch_bounds__(kStateThreads)
chunk_state_bf16(const uint16_t* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const uint16_t* __restrict__ Bm,
                 float* __restrict__ cs_g, float* __restrict__ local, int S,
                 int H, int P, int G, int N, int chunk, int nc, int vec_x,
                 int vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* x_s = reinterpret_cast<uint16_t*>(smem_raw);  // kTile x kLdK
  uint16_t* wh_s = x_s + kTile * kLdK;       // kMaxN x kLdK: w B, [n][key]
  uint16_t* wl_s = wh_s + kMaxN * kLdK;
  float* wk_s = reinterpret_cast<float*>(wl_s + kMaxN * kLdK);  // kTile
  float* dt_s = wk_s + kTile;                // chunk
  float* cs_s = dt_s + chunk;                // chunk
  const Chunk k = chunk_of(blockIdx.z, blockIdx.y, blockIdx.x, S, H, P, G, N,
                           chunk, nc);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;   // rows wm*16 of P, n tiles wn*8
  const long long x_stride = static_cast<long long>(H) * P;
  const long long bc_stride = static_cast<long long>(G) * N;
  const uint16_t* xc = x + k.x_off;
  const uint16_t* Bc = Bm + k.bc_off;
  const int pm = (P + 15) & ~15, nn = (N + 7) & ~7;
  chunk_cumsum(dt + k.dt_off, H, k.len, A[k.h], dt_s, cs_s,
               cs_g + k.scratch * chunk);
  const float cs_end = cs_s[k.len - 1];

  float acc[8][4] = {};
  for (int k0 = 0; k0 < k.len; k0 += kTile) {
    const int kn = min(kTile, k.len - k0);
    for (int i = tid; i < kTile; i += kStateThreads)
      wk_s[i] = i >= kn ? 0.0f
                : kGrad ? expf(cs_s[k0 + i])
                        : expf(cs_end - cs_s[k0 + i]) * dt_s[k0 + i];
    load_rows(x_s, kLdK, xc + k0 * x_stride, x_stride, kn, P, pm, vec_x);
    __syncthreads();                         // wk_s
    // (w_k B_k) transposed into [n][key], split into hi + lo
    for (int i = tid; i < kTile * (nn / 8); i += kStateThreads) {
      // neighbouring lanes take neighbouring keys, so each 2-byte store
      // of a warp lands in its own bank pair
      const int key = i % kTile, n = (i / kTile) * 8;
      Pack8 v;
      v.u = key < kn ? load8(Bc + (k0 + key) * bc_stride + n, N - n, vec_bc)
                     : make_uint4(0, 0, 0, 0);
      const float w = wk_s[key];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint16_t hi, lo;
        split_bf16(w * bf16_to_f32(v.h[j]), hi, lo);
        wh_s[(n + j) * kLdK + key] = hi;
        wl_s[(n + j) * kLdK + key] = lo;
      }
    }
    cp_async_wait();
    __syncthreads();
    if (wm * 16 < P) {
#pragma unroll
      for (int kb = 0; kb < kTile / 16; ++kb) {
        uint32_t a[4];
        ldsm_trans_a(a, x_s, kLdK, wm * 16, kb * 16);   // x^T
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n0 = (wn * 8 + j) * 8;
          if (n0 < N) {
            mma_rows(acc[j], a, wh_s, kLdK, n0, kb * 16);
            mma_rows(acc[j], a, wl_s, kLdK, n0, kb * 16);
          }
        }
      }
    }
    __syncthreads();                         // x_s, w and wk_s refill next
  }
  float* out = local + k.scratch * P * N;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = (wn * 8 + j) * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = wm * 16 + g + (e >> 1) * 8, col = n + (e & 1);
      if (p < P && col < N) out[p * N + col] = acc[j][e];
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: the carry between chunks
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
carry(const float* __restrict__ cs_g, float* __restrict__ local,
      uint16_t* __restrict__ split, T* __restrict__ state_out,
      long long n_elems, int PN, int S, int chunk, int nc) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n_elems) return;
  const long long bh = i / PN;
  const int pn = static_cast<int>(i - bh * PN);
  const float* cs = cs_g + bh * nc * chunk;
  float* loc = local + bh * nc * PN + pn;
  float run = 0.0f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const int len = min(chunk, S - c * chunk);
    const float decay = expf(cs[static_cast<long long>(c) * chunk + len - 1]);
    const float l = loc[static_cast<long long>(c) * PN];
    if (split == nullptr) {
      loc[static_cast<long long>(c) * PN] = run;    // state entering chunk c
    } else {                                        // as bf16 hi + lo
      uint16_t hi, lo;
      split_bf16(run, hi, lo);
      uint16_t* sp = split + ((bh * nc + c) * 2) * PN + pn;
      sp[0] = hi;
      sp[PN] = lo;
    }
    run = run * decay + l;
  }
  if (state_out != nullptr) state_out[i] = from_f32<T>(run);
}

// ---------------------------------------------------------------------------
// pass 3: y of one 64-row query tile of one chunk
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
chunk_scan_f32(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ cs_g,
               const float* __restrict__ state_in, float* __restrict__ y,
               int S, int H, int P, int G, int N, int chunk, int nc) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* c_s = smem;                        // kTile x ldn
  float* b_s = c_s + kTile * ldn;           // kTile x ldn
  float* x_s = b_s + kTile * ldn;           // kTile x P
  float* m_s = x_s + kTile * P;             // kTile x kTile
  float* st_s = m_s + kTile * kTile;        // P x ldn
  float* dt_s = st_s + P * ldn;             // chunk
  float* cs_s = dt_s + chunk;               // chunk

  const int bh = blockIdx.z;
  const Chunk k = chunk_of(bh / H, bh % H, blockIdx.x, S, H, P, G, N, chunk,
                           nc);
  const int q0 = blockIdx.y * kTile;
  if (q0 >= k.len) return;
  const int top = min(k.len, q0 + kTile);
  const int tid = threadIdx.x, ty = tid / kLanes, tx = tid % kLanes;
  const long long x_stride = static_cast<long long>(H) * P;
  const long long bc_stride = static_cast<long long>(G) * N;
  const float* xc = x + k.x_off;
  const float* Bc = Bm + k.bc_off;
  const float* Cc = Cm + k.bc_off;
  const float* dtc = dt + k.dt_off;
  const float* csc = cs_g + k.scratch * chunk;
  const float* st = state_in + k.scratch * P * N;
  for (int i = tid; i < top; i += kThreads) {
    dt_s[i] = dtc[static_cast<long long>(i) * H];
    cs_s[i] = csc[i];
  }
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    st_s[p * ldn + n] = st[i];
  }
  for (int i = tid; i < kTile * N; i += kThreads) {
    const int r = i / N, n = i - r * N;
    c_s[r * ldn + n] = r < top - q0 ? Cc[(q0 + r) * bc_stride + n] : 0.0f;
  }

  float acc[kRows][kColsP] = {};
  for (int k0 = 0; k0 < top; k0 += kTile) {
    const int kn = min(kTile, k.len - k0);
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      b_s[r * ldn + n] = r < kn ? Bc[(k0 + r) * bc_stride + n] : 0.0f;
    }
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      x_s[i] = r < kn ? xc[(k0 + r) * x_stride + p] : 0.0f;
    }
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
        const int kk = tx + kLanes * j, kq = k0 + kk;
        float m = 0.0f;
        if (kq <= q && q < k.len)
          m = (cb[i][j] * expf(cs_s[q] - cs_s[kq])) * dt_s[kq];
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
    __syncthreads();                // b_s, x_s, m_s are refilled next
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
  float* yc = y + k.x_off;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q = q0 + ty + kLanes * i;
    if (q >= k.len) continue;
    const float e = expf(cs_s[q]);
#pragma unroll
    for (int j = 0; j < kColsP; ++j) {
      const int p = tx + kLanes * j;
      if (p < P) yc[q * x_stride + p] = acc[i][j] + e * off[i][j];
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
chunk_scan_bf16(const uint16_t* __restrict__ x, const float* __restrict__ dt,
                const uint16_t* __restrict__ Bm,
                const uint16_t* __restrict__ Cm,
                const float* __restrict__ cs_g,
                const uint16_t* __restrict__ state_in,
                uint16_t* __restrict__ y,
                int S, int H, int P, int G, int N, int chunk, int nc,
                int vec_x, int vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* c_s = reinterpret_cast<uint16_t*>(smem_raw);  // kTile x kLdN
  uint16_t* b_s = c_s + kTile * kLdN;        // kTile x kLdN, [key][n]
  uint16_t* x_s = b_s + kTile * kLdN;        // kTile x kLdK, [key][p]
  float* dt_s = reinterpret_cast<float*>(x_s + kTile * kLdK);   // chunk
  float* cs_s = dt_s + chunk;                // chunk

  const int bh = blockIdx.z;
  const Chunk k = chunk_of(bh / H, bh % H, blockIdx.x, S, H, P, G, N, chunk,
                           nc);
  const int q0 = blockIdx.y * kTile;
  if (q0 >= k.len) return;
  const int top = min(k.len, q0 + kTile);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;                  // the warp's query rows
  const int qa = q0 + r0 + g, qb = qa + 8;   // the thread's two rows
  const int nk = (N + 15) & ~15;             // reduction over N, zero padded
  const int pp = (P + 7) & ~7;               // P in n tiles of 8
  const long long x_stride = static_cast<long long>(H) * P;
  const long long bc_stride = static_cast<long long>(G) * N;
  const uint16_t* xc = x + k.x_off;
  const uint16_t* Bc = Bm + k.bc_off;
  const uint16_t* Cc = Cm + k.bc_off;
  const float* dtc = dt + k.dt_off;
  const float* csc = cs_g + k.scratch * chunk;
  const uint16_t* st = state_in + k.scratch * 2 * P * N;   // hi, then lo

  for (int i = tid; i < top; i += kScanThreads) {
    dt_s[i] = dtc[static_cast<long long>(i) * H];
    cs_s[i] = csc[i];
  }
  load_rows(c_s, kLdN, Cc + q0 * bc_stride, bc_stride, top - q0, N, nk,
            vec_bc);

  // the carried state's part first, C state_in^T with the state as hi +
  // lo, 64 columns of N at a time through the space of the B and x tiles
  // ([p][n], row stride kLdK: hi, then lo), so that four blocks fit an SM
  float off[8][4] = {};
  uint16_t* sl_s = b_s + kMaxP * kLdK;
  for (int n0 = 0; n0 < nk; n0 += kTile) {
    const int nw = min(kTile, nk - n0);
    __syncthreads();                         // b_s free again
    load_rows(b_s, kLdK, st + n0, N, P, N - n0, nw, vec_bc);
    load_rows(sl_s, kLdK, st + P * N + n0, N, P, N - n0, nw, vec_bc);
    cp_async_wait();                         // and the C tile's, first time
    __syncthreads();
    for (int kk = 0; kk < nw; kk += 16) {
      uint32_t a[4];
      frag_a(a, c_s, kLdN, r0, n0 + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j * 8 < P) {
          mma_rows(off[j], a, b_s, kLdK, j * 8, kk);
          mma_rows(off[j], a, sl_s, kLdK, j * 8, kk);
        }
    }
  }

  const float csa = qa < k.len ? cs_s[qa] : 0.0f;
  const float csb = qb < k.len ? cs_s[qb] : 0.0f;
  float acc[8][4] = {};
  for (int k0 = 0; k0 < top; k0 += kTile) {  // causal key tiles only
    const int kn = min(kTile, k.len - k0);
    __syncthreads();                         // b_s, x_s free again
    load_rows(b_s, kLdN, Bc + k0 * bc_stride, bc_stride, kn, N, nk, vec_bc);
    load_rows(x_s, kLdK, xc + k0 * x_stride, x_stride, kn, P, pp, vec_x);
    cp_async_wait();
    __syncthreads();
    // C B^T: the warp's 16 rows by 64 keys, exact products, float32 sums
    float sc[8][4] = {};
    for (int kk = 0; kk < nk; kk += 16) {
      uint32_t a[4];
      frag_a(a, c_s, kLdN, r0, kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_rows(sc[j], a, b_s, kLdN, j * 8, kk);
    }
    // M = (C B^T * exp(cs_q - cs_k)) * dt_k, causal, split into bf16 hi +
    // lo A fragments: key block kb is accumulator tiles 2 kb and 2 kb + 1
    uint32_t mh[4][4], ml[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint16_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = e < 2 ? qa : qb, kq = k0 + j * 8 + 2 * t + (e & 1);
        float m = 0.0f;
        if (kq <= q && q < k.len)
          m = (sc[j][e] * expf((e < 2 ? csa : csb) - cs_s[kq])) * dt_s[kq];
        split_bf16(m, hi[e], lo[e]);
      }
      const int kb = j >> 1, half = (j & 1) * 2;
      mh[kb][half] = pack2(hi[0], hi[1]);
      mh[kb][half + 1] = pack2(hi[2], hi[3]);
      ml[kb][half] = pack2(lo[0], lo[1]);
      ml[kb][half + 1] = pack2(lo[2], lo[3]);
    }
    // y += M x, x's fragments read transposed from [key][p]
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j * 8 < P) {
          uint32_t b0, b1;
          ldsm_trans_b(b0, b1, x_s, kLdK, j * 8, kb * 16);
          mma_bf16(acc[j], mh[kb], b0, b1);
          mma_bf16(acc[j], ml[kb], b0, b1);
        }
  }
  uint16_t* yc = y + k.x_off;
  const float ea = qa < k.len ? expf(csa) : 0.0f;
  const float eb = qb < k.len ? expf(csb) : 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = e < 2 ? qa : qb, p = j * 8 + 2 * t + (e & 1);
      if (q < k.len && p < P)
        yc[q * x_stride + p] =
            f32_to_bf16(acc[j][e] + (e < 2 ? ea : eb) * off[j][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// shared memory and launch
// ---------------------------------------------------------------------------

long long state_f32_bytes(int P, int N, int chunk) {
  return 4LL * (kTile * P + kTile * (N + 1) + 2LL * chunk);
}
long long scan_f32_bytes(int P, int N, int chunk) {
  return 4LL * (2 * kTile * (N + 1) + kTile * P + kTile * kTile +
                P * (N + 1) + 2LL * chunk);
}
long long state_bf16_bytes(int chunk) {
  return 2LL * (kMaxP * kLdK + 2 * kMaxN * kLdK) + 4LL * (kTile + 2LL * chunk);
}
long long scan_bf16_bytes(int chunk) {
  return 2LL * (2 * kTile * kLdN + kMaxP * kLdK) + 8LL * chunk;
}

// the most any of the passes' blocks uses
long long shared_bytes(int P, int N, int chunk) {
  long long m = state_f32_bytes(P, N, chunk);
  const long long others[] = {scan_f32_bytes(P, N, chunk),
                              state_bf16_bytes(chunk),
                              scan_bf16_bytes(chunk)};
  for (long long v : others) m = v > m ? v : m;
  return m;
}

template <typename K>
cudaError_t allow_shared(K* kernel, long long bytes) {
  // per launch: the attribute belongs to the current device
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int launch_f32(const float* x, const float* dt, const float* A,
               const float* B, const float* C, float* y, float* state,
               float* cs_g, float* local, int batch, int S, int H, int P,
               int G, int N, int chunk, int nc, cudaStream_t stream) {
  const long long b1 = state_f32_bytes(P, N, chunk);
  const long long b3 = scan_f32_bytes(P, N, chunk);
  cudaError_t err = allow_shared(chunk_state_f32<false>, b1);
  if (err == cudaSuccess) err = allow_shared(chunk_scan_f32, b3);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_state_f32<false><<<dim3(nc, H, batch), kThreads, b1, stream>>>(
      x, dt, A, B, cs_g, local, S, H, P, G, N, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(batch) * H * P * N;
  carry<float><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                 kThreads, 0, stream>>>(cs_g, local, nullptr, state, n,
                                        P * N, S, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int qtiles = (min(chunk, S) + kTile - 1) / kTile;
  chunk_scan_f32<<<dim3(nc, qtiles, batch * H), kThreads, b3, stream>>>(
      x, dt, B, C, cs_g, local, y, S, H, P, G, N, chunk, nc);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const uint16_t* x, const float* dt, const float* A,
                const uint16_t* B, const uint16_t* C, uint16_t* y,
                uint16_t* state, float* cs_g, float* local, uint16_t* split,
                int batch, int S,
                int H, int P, int G, int N, int chunk, int nc,
                cudaStream_t stream) {
  const long long b1 = state_bf16_bytes(chunk);
  const long long b3 = scan_bf16_bytes(chunk);
  cudaError_t err = allow_shared(chunk_state_bf16<false>, b1);
  if (err == cudaSuccess) err = allow_shared(chunk_scan_bf16, b3);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte row loads where every row of x (of B, C) starts aligned
  const int vec_x = P % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_bc = N % 8 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(C) % 16 == 0;
  chunk_state_bf16<false><<<dim3(nc, H, batch), kStateThreads, b1, stream>>>(
      x, dt, A, B, cs_g, local, S, H, P, G, N, chunk, nc, vec_x, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(batch) * H * P * N;
  carry<uint16_t><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    kThreads, 0, stream>>>(cs_g, local, split, state, n,
                                           P * N, S, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int qtiles = (min(chunk, S) + kTile - 1) / kTile;
  chunk_scan_bf16<<<dim3(nc, qtiles, batch * H), kScanThreads, b3, stream>>>(
      x, dt, B, C, cs_g, split, y, S, H, P, G, N, chunk, nc, vec_x, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
//
// The gradients of (y, final state) with respect to x, dt, A, B and C,
// given dy and dfinal (the final state's, or none). With L[q, k] =
// exp(cs_q - cs_k) (k <= q), M = (C B^T) L dt_k, w_k = exp(cs_end - cs_k)
// dt_k, S_in the state entering a chunk and G = dS_out its gradient
// leaving it:
//
//   dx = M^T dy + w (B G^T)              dM = dy x^T (causal)
//   dC = (dM L dt_k) B + exp(cs) (dy S_in)
//   dB = (dM L dt_k)^T C + w (x G)
//   ddt = sum_q dM C.B L + exp(cs_end - cs) (x G . B) + A d(dt A)
//   dA = sum over (b, s) of dt d(dt A)
//   d(dt A)_j = sum_{q >= j} dcs_q (the reverse cumsum of dcs)
//   dcs_q = sum_k (dM M)[q, k] - sum_k (dM M)[k, q] + exp(cs_q) dy_q.S_in C_q
//           - w_q (x G . B)_q  (+ at the chunk's end: sum_k w_k (x G . B)_k
//           + exp(cs_end) <G, S_in>); the diagonal of dM M cancels (L = 1
//           there) and is left out of both sums
//   G[c - 1] = exp(cs_end[c]) G[c] + sum_q exp(cs_q) dy_q (x) C_q
//
// This is what the reference gets from autodiff of models/ssm.py's
// ssd_chunked; the Pallas kernel has no VJP.
//
// What bounds it on this card: operations. At mamba2-780m's training call
// (2, 1024, 48, 64), N 128, bf16, the function needs 21.0 GFLOP (per
// causal pair C B^T, dy x^T, M^T dy and dB's and dC's products; the
// states' five L N P products) and moves 40.6 MB: 0.0212 ms at 989
// TFLOP/s against 0.0121 ms at 3.35 TB/s. This first design is right and
// simple rather than fast: 0.84 ms there (zamba2-7b's (2, 1024, 112, 64),
// N 64, 1.03 ms) on an H100 at 700 W, two thirds of it in passes 3 and 4.
// Passes, on one stream:
//  1. the forward's chunk_state and carry again: the cumsums, and S_in of
//     every chunk as float32;
//  2. chunk_state<kGrad> and carry_back: each chunk's sum_q exp(cs_q) dy_q
//     (x) C_q, then G carried from the last chunk (dfinal, or zero) to the
//     first, written in place;
//  3. chunk_keys, grid (chunk, 64-key tile, b * h): dx, the head's dB, the
//     direct part of ddt and the key side of dcs, walking the query tiles
//     at and after the key tile (the causal ones);
//  4. chunk_queries, grid (chunk, 64-query tile, b * h): the head's dC and
//     the query side of dcs, walking the key tiles at and before it;
//  5. finish, grid (chunk, h, b): the chunk-end terms, the reverse cumsum
//     summed in float64 and rounded once (as the forward's cumsum), ddt
//     and the chunk's part of dA;
//  6. reduce: dB and dC summed over each group's heads and dA over (b,
//     chunk), in a fixed order, cast to the outputs' types.
// No atomics: two launches give equal bits.
//
// Passes 3 and 4, bfloat16 (chunk_keys_tc, chunk_queries_tc): the
// forward's building blocks. Tiles of x, dy, B and C stay bf16 in shared
// memory (copied by cp.async), and every product runs on the tensor cores
// with mma.sync m16n8k16, a warp owning 16 rows of the 64-row tile. The
// bf16 inputs enter products exactly (C B^T, dy x^T); every float32
// operand is split into bf16 hi + lo, as in the forward: G and S_in once
// per block into two shared tiles, M and dM L dt in registers, straight
// from the accumulators of C B^T and dy x^T into A fragments (they never
// touch shared memory). Operands stored with the reduction along rows are
// read by ldmatrix.trans. A warp's row sums are warp shuffles in a fixed
// order.
// float32 (chunk_keys, chunk_queries): float32 tiles in shared memory and
// SIMT FMAs on an 8 x 16 thread grid (Tile::mul_add); M and dM L dt go
// through shared memory, row sums through shared memory in a fixed order.

constexpr int kBwdThreads = 128;
constexpr int kLdP = kMaxP + 4;              // float32 row strides
constexpr int kLdQ = kTile + 4;

__host__ __device__ constexpr int ld_n(int kn) { return kn + 4; }

__device__ __forceinline__ float ld_f32(const float* p) { return *p; }
__device__ __forceinline__ float ld_f32(const uint16_t* p) {
  return bf16_to_f32(*p);
}

// A 64 x kCols float32 product of a 128-thread block, held in registers:
// an 8 x 16 thread grid, element kJ ii + jj of a thread is row ty + 8 ii,
// column tx + 16 jj.
template <int kCols>
struct Tile {
  static constexpr int kN = kCols / 2;       // elements a thread holds
  static constexpr int kJ = kCols / 16;      // columns a thread holds
  static constexpr int kRowsPer = 8;
  static constexpr int kSlots = 16;          // threads sharing a row
  float v[kN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = 0.0f;
  }
  __device__ static int row(int i) {
    return (threadIdx.x >> 4) + 8 * (i / kJ);
  }
  __device__ static int col(int i) {
    return (threadIdx.x & 15) + 16 * (i % kJ);
  }
  // which of the thread's rows element i is in, and the thread's slot
  // among those sharing its rows
  __device__ static int local_row(int i) { return i / kJ; }
  __device__ static int slot() { return threadIdx.x & 15; }
  __device__ static int row_of(int r) { return (threadIdx.x >> 4) + 8 * r; }

  // v[r][c] += sum_k A[r ars + k acs] B[k brs + c bcs] over k < K and
  // every column; A has 64 rows, the operands are zero where they are
  // padding.
  __device__ void mul_add(const float* A, int ars, int acs, const float* B,
                          int brs, int bcs, int K) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    for (int k = 0; k < K; ++k) {
      float a[8], b[kJ];
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) a[ii] = A[(ty + 8 * ii) * ars + k * acs];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) b[jj] = B[k * brs + (tx + 16 * jj) * bcs];
#pragma unroll
      for (int ii = 0; ii < 8; ++ii)
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
          v[ii * kJ + jj] = fmaf(a[ii], b[jj], v[ii * kJ + jj]);
    }
  }

  // v written to dst[r][c] (row stride ld)
  __device__ void store(float* dst, int ld) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) dst[row(i) * ld + col(i)] = v[i];
  }
};

// Row sums of two per-element terms of a tile, in a fixed order: each
// thread's partials over its columns go to red[row][slot], then (after
// the caller's __syncthreads()) row_total adds the slots in order.
template <class TileT, class F>
__device__ __forceinline__ void row_partials(F term, float2* red) {
  float2 part[TileT::kRowsPer];
#pragma unroll
  for (int r = 0; r < TileT::kRowsPer; ++r) part[r] = make_float2(0, 0);
#pragma unroll
  for (int i = 0; i < TileT::kN; ++i) {
    const float2 t2 = term(i);
    part[TileT::local_row(i)].x += t2.x;
    part[TileT::local_row(i)].y += t2.y;
  }
#pragma unroll
  for (int r = 0; r < TileT::kRowsPer; ++r)
    red[TileT::row_of(r) * TileT::kSlots + TileT::slot()] = part[r];
}

template <class TileT>
__device__ __forceinline__ float2 row_total(const float2* red, int r) {
  float2 s = make_float2(0, 0);
#pragma unroll
  for (int i = 0; i < TileT::kSlots; ++i) {
    s.x += red[r * TileT::kSlots + i].x;
    s.y += red[r * TileT::kSlots + i].y;
  }
  return s;
}

// rows [0, rows) x cols [0, cols) of src (row stride `stride`) into the
// float32 tile dst (row stride ld), zeros up to 64 rows and colsp columns
template <typename T>
__device__ void load_f32_tile(float* dst, int ld, const T* src,
                              long long stride, int rows, int cols,
                              int colsp) {
  for (int i = threadIdx.x; i < kTile * colsp; i += blockDim.x) {
    const int r = i / colsp, c = i - r * colsp;
    dst[r * ld + c] = r < rows && c < cols ? ld_f32(src + r * stride + c)
                                           : 0.0f;
  }
}

// The backward's scratch, float32, carved from one workspace:
struct BwdWork {
  float *cs, *s_in, *g;                      // (b, h, nc, chunk), 2 x (.., P, N)
  float *ddt_k, *dcs_k, *wdw, *dcs_q;        // (b, h, nc, chunk) each
  float *db_h, *dc_h;                        // (b, S, H, N) each
  float *da;                                 // (b, h, nc)
};

// Floats of the workspace; with `base`, its slices into *w.
long long bwd_work_floats(int batch, int S, int H, int P, int N, int chunk,
                          BwdWork* w = nullptr, float* base = nullptr) {
  BwdWork unused;
  if (w == nullptr) w = &unused;
  const int nc = (S + chunk - 1) / chunk;
  const long long bhc = static_cast<long long>(batch) * H * nc;
  const long long bshn = static_cast<long long>(batch) * S * H * N;
  const struct {
    float** at;
    long long n;
  } slices[] = {{&w->cs, bhc * chunk},   {&w->s_in, bhc * P * N},
                {&w->g, bhc * P * N},    {&w->ddt_k, bhc * chunk},
                {&w->dcs_k, bhc * chunk}, {&w->wdw, bhc * chunk},
                {&w->dcs_q, bhc * chunk}, {&w->db_h, bshn},
                {&w->dc_h, bshn},        {&w->da, bhc}};
  long long off = 0;
  for (const auto& sl : slices) {
    *sl.at = base == nullptr ? nullptr : base + off;
    off += (sl.n + 3) & ~3LL;                // 16-byte aligned slices
  }
  return off;
}

// shared memory of chunk_keys and chunk_queries (float32 tiles: two of
// 64 x ld_n(kN), three of 64 x kLdP or kLdQ, the chunk's cs and dt, the
// row sums' slots and three per-row arrays)
long long bwd_tile_bytes(int kn, int chunk) {
  return 4LL * (2 * kTile * ld_n(kn) + 2 * kTile * kLdP + kTile * kLdQ +
                2LL * chunk + 2 * kTile * 16 + 3 * kTile);
}

// the chunk's dt and cumsum (from pass 1's scratch) into shared memory
__device__ void load_chunk_cs(const Chunk& k, const float* dt, const float* cs_g,
                              int H, int chunk, float* dt_s, float* cs_s) {
  const float* dtc = dt + k.dt_off;
  const float* csc = cs_g + k.scratch * chunk;
  for (int i = threadIdx.x; i < k.len; i += blockDim.x) {
    dt_s[i] = dtc[static_cast<long long>(i) * H];
    cs_s[i] = csc[i];
  }
}

template <int kN>
__global__ void __launch_bounds__(kBwdThreads)
chunk_keys(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           const float* __restrict__ dy, BwdWork w, float* __restrict__ dx,
           int S, int H, int P, int G, int N, int chunk, int nc) {
  using TileP = Tile<kMaxP>;                 // 64 x 64 (also keys x queries)
  using TileN = Tile<kN>;
  constexpr int kLdN = ld_n(kN);
  extern __shared__ __align__(16) float smem_f[];
  float* bk_s = smem_f;                      // keys' B, [k][n]
  float* xk_s = bk_s + kTile * kLdN;         // keys' x, [k][p]
  float* cq_s = xk_s + kTile * kLdP;         // queries' C [q][n]; first G [p][n]
  float* dq_s = cq_s + kTile * kLdN;         // queries' dy, [q][p]
  float* m_s = dq_s + kTile * kLdP;          // M^T, then (dM L dt)^T, [k][q]
  float* dt_s = m_s + kTile * kLdQ;
  float* cs_s = dt_s + chunk;
  float2* red = reinterpret_cast<float2*>(cs_s + chunk);
  float* dw_s = reinterpret_cast<float*>(red + kTile * 16);
  float* acc_ddt = dw_s + kTile;
  float* acc_dcs = acc_ddt + kTile;

  const int bh = blockIdx.z;
  const Chunk k = chunk_of(bh / H, bh % H, blockIdx.x, S, H, P, G, N, chunk,
                           nc);
  const int k0 = blockIdx.y * kTile;
  if (k0 >= k.len) return;
  const int kn = min(kTile, k.len - k0);
  const int tid = threadIdx.x;
  const long long x_stride = static_cast<long long>(H) * P;
  const long long bc_stride = static_cast<long long>(G) * N;
  load_chunk_cs(k, dt, w.cs, H, chunk, dt_s, cs_s);
  load_f32_tile(bk_s, kLdN, Bm + k.bc_off + k0 * bc_stride, bc_stride, kn, N,
                kN);
  load_f32_tile(xk_s, kLdP, x + k.x_off + k0 * x_stride, x_stride, kn, P,
                kMaxP);
  load_f32_tile(cq_s, kLdN, w.g + k.scratch * P * N, N, P, N, kN);
  __syncthreads();
  const float cs_end = cs_s[k.len - 1];

  // the state terms: x G and B G^T, then dw_k = (x G)_k . B_k
  TileN db;                                  // x G, then dB
  db.zero();
  db.mul_add(xk_s, kLdP, 1, cq_s, kLdN, 1, kMaxP);
  TileP dxt;                                 // B G^T, then dx
  dxt.zero();
  dxt.mul_add(bk_s, kLdN, 1, cq_s, 1, kLdN, kN);
  row_partials<TileN>([&](int i) {
    return make_float2(db.v[i] * bk_s[TileN::row(i) * kLdN + TileN::col(i)],
                       0.0f);
  }, red);
  __syncthreads();
  if (tid < kTile) {
    dw_s[tid] = row_total<TileN>(red, tid).x;
    acc_ddt[tid] = 0.0f;
    acc_dcs[tid] = 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TileN::kN; ++i) {
    const int r = TileN::row(i);
    db.v[i] *= r < kn ? expf(cs_end - cs_s[k0 + r]) * dt_s[k0 + r] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < TileP::kN; ++i) {
    const int r = TileP::row(i);
    dxt.v[i] *= r < kn ? expf(cs_end - cs_s[k0 + r]) * dt_s[k0 + r] : 0.0f;
  }

  // the dual form, query tiles at and after the key tile
  for (int q0 = k0; q0 < k.len; q0 += kTile) {
    const int qn = min(kTile, k.len - q0);
    __syncthreads();                         // cq_s, dq_s, m_s free again
    load_f32_tile(cq_s, kLdN, Cm + k.bc_off + q0 * bc_stride, bc_stride, qn,
                  N, kN);
    load_f32_tile(dq_s, kLdP, dy + k.x_off + q0 * x_stride, x_stride, qn, P,
                  kMaxP);
    __syncthreads();
    TileP cb, dm;                            // (C B^T)^T, (dy x^T)^T: [k][q]
    cb.zero();
    dm.zero();
    cb.mul_add(bk_s, kLdN, 1, cq_s, 1, kLdN, kN);
    dm.mul_add(xk_s, kLdP, 1, dq_s, 1, kLdP, kMaxP);
    // M^T into cb, (dM L dt)^T into dm; per key: sum_q dM C.B L and
    // sum_q dM M
    float2 part[TileP::kRowsPer];
#pragma unroll
    for (int r = 0; r < TileP::kRowsPer; ++r) part[r] = make_float2(0, 0);
#pragma unroll
    for (int i = 0; i < TileP::kN; ++i) {
      const int kk = k0 + TileP::row(i), q = q0 + TileP::col(i);
      float m = 0.0f, d = 0.0f;
      if (kk <= q && q < k.len) {
        const float L = expf(cs_s[q] - cs_s[kk]);
        const float cbl = cb.v[i] * L;
        m = cbl * dt_s[kk];
        d = (dm.v[i] * L) * dt_s[kk];
        part[TileP::local_row(i)].x += dm.v[i] * cbl;
        if (kk < q) part[TileP::local_row(i)].y += dm.v[i] * m;
      }
      cb.v[i] = m;
      dm.v[i] = d;
    }
#pragma unroll
    for (int r = 0; r < TileP::kRowsPer; ++r)
      red[TileP::row_of(r) * TileP::kSlots + TileP::slot()] = part[r];
    cb.store(m_s, kLdQ);
    __syncthreads();
    if (tid < kTile) {
      const float2 t2 = row_total<TileP>(red, tid);
      acc_ddt[tid] += t2.x;
      acc_dcs[tid] -= t2.y;
    }
    dxt.mul_add(m_s, kLdQ, 1, dq_s, kLdP, 1, kTile);
    __syncthreads();
    dm.store(m_s, kLdQ);
    __syncthreads();
    db.mul_add(m_s, kLdQ, 1, cq_s, kLdN, 1, kTile);
  }

  // dx (x's type), the head's dB (float32), the per-key scalars
  float* dxc = dx + k.x_off + k0 * x_stride;
#pragma unroll
  for (int i = 0; i < TileP::kN; ++i) {
    const int r = TileP::row(i), c = TileP::col(i);
    if (r < kn && c < P) dxc[r * x_stride + c] = dxt.v[i];
  }
  const long long hn_stride = static_cast<long long>(H) * N;
  float* dbc = w.db_h + (static_cast<long long>(k.b) * S + k.c0 + k0) *
                            hn_stride + static_cast<long long>(k.h) * N;
#pragma unroll
  for (int i = 0; i < TileN::kN; ++i) {
    const int r = TileN::row(i), c = TileN::col(i);
    if (r < kn && c < N) dbc[r * hn_stride + c] = db.v[i];
  }
  if (tid < kn) {
    const long long o = k.scratch * chunk + k0 + tid;
    const float e = expf(cs_end - cs_s[k0 + tid]);
    const float wdw = e * dt_s[k0 + tid] * dw_s[tid];
    w.ddt_k[o] = acc_ddt[tid] + e * dw_s[tid];
    w.dcs_k[o] = acc_dcs[tid];
    w.wdw[o] = wdw;
  }
}

template <int kN>
__global__ void __launch_bounds__(kBwdThreads)
chunk_queries(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ Bm, const float* __restrict__ Cm,
              const float* __restrict__ dy, BwdWork w, int S, int H, int P,
              int G, int N, int chunk, int nc) {
  using TileP = Tile<kMaxP>;
  using TileN = Tile<kN>;
  constexpr int kLdN = ld_n(kN);
  extern __shared__ __align__(16) float smem_f[];
  float* cq_s = smem_f;                      // queries' C, [q][n]
  float* dq_s = cq_s + kTile * kLdN;         // queries' dy, [q][p]
  float* bk_s = dq_s + kTile * kLdP;         // keys' B [k][n]; first S_in [p][n]
  float* xk_s = bk_s + kTile * kLdN;         // keys' x, [k][p]
  float* m_s = xk_s + kTile * kLdP;          // dM L dt, [q][k]
  float* dt_s = m_s + kTile * kLdQ;
  float* cs_s = dt_s + chunk;
  float2* red = reinterpret_cast<float2*>(cs_s + chunk);
  float* acc_dcs = reinterpret_cast<float*>(red + kTile * 16);

  const int bh = blockIdx.z;
  const Chunk k = chunk_of(bh / H, bh % H, blockIdx.x, S, H, P, G, N, chunk,
                           nc);
  const int q0 = blockIdx.y * kTile;
  if (q0 >= k.len) return;
  const int qn = min(kTile, k.len - q0);
  const int tid = threadIdx.x;
  const long long x_stride = static_cast<long long>(H) * P;
  const long long bc_stride = static_cast<long long>(G) * N;
  load_chunk_cs(k, dt, w.cs, H, chunk, dt_s, cs_s);
  load_f32_tile(cq_s, kLdN, Cm + k.bc_off + q0 * bc_stride, bc_stride, qn, N,
                kN);
  load_f32_tile(dq_s, kLdP, dy + k.x_off + q0 * x_stride, x_stride, qn, P,
                kMaxP);
  load_f32_tile(bk_s, kLdN, w.s_in + k.scratch * P * N, N, P, N, kN);
  __syncthreads();

  // the carried state's part: dy S_in, then off_q = C_q . (dy S_in)_q
  TileN dc;
  dc.zero();
  dc.mul_add(dq_s, kLdP, 1, bk_s, kLdN, 1, kMaxP);
  row_partials<TileN>([&](int i) {
    return make_float2(dc.v[i] * cq_s[TileN::row(i) * kLdN + TileN::col(i)],
                       0.0f);
  }, red);
  __syncthreads();
  if (tid < kTile)
    acc_dcs[tid] = tid < qn ? expf(cs_s[q0 + tid]) *
                                  row_total<TileN>(red, tid).x
                            : 0.0f;
#pragma unroll
  for (int i = 0; i < TileN::kN; ++i) {
    const int r = TileN::row(i);
    dc.v[i] *= r < qn ? expf(cs_s[q0 + r]) : 0.0f;
  }

  // the dual form, key tiles at and before the query tile
  for (int k0 = 0; k0 <= q0; k0 += kTile) {
    const int kn = min(kTile, k.len - k0);
    __syncthreads();                         // bk_s, xk_s, m_s, red free again
    load_f32_tile(bk_s, kLdN, Bm + k.bc_off + k0 * bc_stride, bc_stride, kn,
                  N, kN);
    load_f32_tile(xk_s, kLdP, x + k.x_off + k0 * x_stride, x_stride, kn, P,
                  kMaxP);
    __syncthreads();
    TileP cb, dm;                            // C B^T, dy x^T: [q][k]
    cb.zero();
    dm.zero();
    cb.mul_add(cq_s, kLdN, 1, bk_s, 1, kLdN, kN);
    dm.mul_add(dq_s, kLdP, 1, xk_s, 1, kLdP, kMaxP);
    float2 part[TileP::kRowsPer];
#pragma unroll
    for (int r = 0; r < TileP::kRowsPer; ++r) part[r] = make_float2(0, 0);
#pragma unroll
    for (int i = 0; i < TileP::kN; ++i) {
      const int q = q0 + TileP::row(i), kk = k0 + TileP::col(i);
      float d = 0.0f;
      if (kk <= q && q < k.len) {
        const float L = expf(cs_s[q] - cs_s[kk]);
        const float m = (cb.v[i] * L) * dt_s[kk];
        d = (dm.v[i] * L) * dt_s[kk];
        if (kk < q) part[TileP::local_row(i)].x += dm.v[i] * m;
      }
      dm.v[i] = d;
    }
#pragma unroll
    for (int r = 0; r < TileP::kRowsPer; ++r)
      red[TileP::row_of(r) * TileP::kSlots + TileP::slot()] = part[r];
    dm.store(m_s, kLdQ);
    __syncthreads();
    if (tid < kTile) acc_dcs[tid] += row_total<TileP>(red, tid).x;
    dc.mul_add(m_s, kLdQ, 1, bk_s, kLdN, 1, kTile);
  }

  const long long hn_stride = static_cast<long long>(H) * N;
  float* dcc = w.dc_h + (static_cast<long long>(k.b) * S + k.c0 + q0) *
                            hn_stride + static_cast<long long>(k.h) * N;
#pragma unroll
  for (int i = 0; i < TileN::kN; ++i) {
    const int r = TileN::row(i), c = TileN::col(i);
    if (r < qn && c < N) dcc[r * hn_stride + c] = dc.v[i];
  }
  __syncthreads();
  if (tid < qn) w.dcs_q[k.scratch * chunk + q0 + tid] = acc_dcs[tid];
}

// ---- bfloat16: the tensor-core passes -----------------------------------

__host__ __device__ constexpr int ld_tc(int kn) { return kn + 8; }

// shared memory of chunk_keys_tc and chunk_queries_tc: bf16 tiles of 64
// rows, four of ld_tc(kN) (B or C, the other, G or S_in hi and lo) and
// two of kLdK (x, dy), then the chunk's dt and cs
long long tc_tile_bytes(int kn, int chunk) {
  return 2LL * kTile * (4 * ld_tc(kn) + 2 * kLdK) + 8LL * chunk;
}

// rows [0, rows) x cols [0, cols) of the float32 src (row stride cols)
// split into bf16 hi and lo tiles (row stride ld), zeros up to 64 rows
// and colsp columns
__device__ void load_split(uint16_t* hi, uint16_t* lo, int ld,
                           const float* src, int rows, int cols,
                           int colsp) {
  for (int i = threadIdx.x; i < kTile * colsp; i += blockDim.x) {
    const int r = i / colsp, c = i - r * colsp;
    uint16_t h = 0, l = 0;
    if (r < rows && c < cols) split_bf16(src[r * cols + c], h, l);
    hi[r * ld + c] = h;
    lo[r * ld + c] = l;
  }
}

// the sum over the four lanes of a quad (the lanes holding one row of an
// mma.sync accumulator), the same bits in each
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// accumulator tile j's four values as the bf16 hi and lo halves of the A
// fragment they belong to: tile j holds columns 8 j .. 8 j + 7, which are
// k block j / 2, its first or second half
__device__ __forceinline__ void to_frag(const float (&v)[4], int j,
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
  uint16_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_bf16(v[e], h[e], l[e]);
  const int kb = j >> 1, half = (j & 1) * 2;
  hi[kb][half] = pack2(h[0], h[1]);
  hi[kb][half + 1] = pack2(h[2], h[3]);
  lo[kb][half] = pack2(l[0], l[1]);
  lo[kb][half + 1] = pack2(l[2], l[3]);
}

template <int kN>
__global__ void __launch_bounds__(kBwdThreads)
chunk_keys_tc(const uint16_t* __restrict__ x, const float* __restrict__ dt,
              const uint16_t* __restrict__ Bm,
              const uint16_t* __restrict__ Cm,
              const uint16_t* __restrict__ dy, BwdWork w,
              uint16_t* __restrict__ dx, int S, int H, int P, int G, int N,
              int chunk, int nc, int vec_x, int vec_bc) {
  constexpr int ldn = ld_tc(kN);
  constexpr int kJn = kN / 8;                // n tiles of a warp's 16 rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* bk_s = reinterpret_cast<uint16_t*>(smem_raw);  // keys' B [k][n]
  uint16_t* xk_s = bk_s + kTile * ldn;       // keys' x [k][p]
  uint16_t* cq_s = xk_s + kTile * kLdK;      // queries' C [q][n]
  uint16_t* dq_s = cq_s + kTile * ldn;       // queries' dy [q][p]
  uint16_t* gh_s = dq_s + kTile * kLdK;      // G [p][n], hi
  uint16_t* gl_s = gh_s + kTile * ldn;       // and lo
  float* dt_s = reinterpret_cast<float*>(gl_s + kTile * ldn);
  float* cs_s = dt_s + chunk;

  const int bh = blockIdx.z;
  const Chunk k = chunk_of(bh / H, bh % H, blockIdx.x, S, H, P, G, N, chunk,
                           nc);
  const int k0 = blockIdx.y * kTile;
  if (k0 >= k.len) return;
  const int kn = min(kTile, k.len - k0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);    // the warp's 16 keys
  const long long x_stride = static_cast<long long>(H) * P;
  const long long bc_stride = static_cast<long long>(G) * N;
  load_chunk_cs(k, dt, w.cs, H, chunk, dt_s, cs_s);
  load_rows(bk_s, ldn, Bm + k.bc_off + k0 * bc_stride, bc_stride, kn, N, kN,
            vec_bc);
  load_rows(xk_s, kLdK, x + k.x_off + k0 * x_stride, x_stride, kn, P, kMaxP,
            vec_x);
  load_split(gh_s, gl_s, ldn, w.g + k.scratch * P * N, P, N, kN);
  cp_async_wait();
  __syncthreads();
  const float cs_end = cs_s[k.len - 1];
  float wk[2];                               // w_k of the thread's two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    wk[h] = r < kn ? expf(cs_end - cs_s[k0 + r]) * dt_s[k0 + r] : 0.0f;
  }

  // the state terms: x G (then dB) and B G^T (then dx), G as hi + lo
  float db[kJn][4] = {}, dxa[8][4] = {};
  for (int kk = 0; kk < kMaxP; kk += 16) {
    uint32_t a[4];
    frag_a(a, xk_s, kLdK, r0, kk);
#pragma unroll
    for (int j = 0; j < kJn; ++j) {
      uint32_t b0, b1;
      ldsm_trans_b(b0, b1, gh_s, ldn, 8 * j, kk);
      mma_bf16(db[j], a, b0, b1);
      ldsm_trans_b(b0, b1, gl_s, ldn, 8 * j, kk);
      mma_bf16(db[j], a, b0, b1);
    }
  }
  for (int kk = 0; kk < kN; kk += 16) {
    uint32_t a[4];
    frag_a(a, bk_s, ldn, r0, kk);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mma_rows(dxa[j], a, gh_s, ldn, 8 * j, kk);
      mma_rows(dxa[j], a, gl_s, ldn, 8 * j, kk);
    }
  }
  // dw_k = (x G)_k . B_k
  float dw[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kJn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      dw[e >> 1] += bf16_to_f32(bk_s[r * ldn + c]) * db[j][e];
    }
  dw[0] = quad_sum(dw[0]);
  dw[1] = quad_sum(dw[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int j = 0; j < kJn; ++j) db[j][e] *= wk[e >> 1];
#pragma unroll
    for (int j = 0; j < 8; ++j) dxa[j][e] *= wk[e >> 1];
  }

  // the dual form, query tiles at and after the key tile
  float pddt[2] = {0.0f, 0.0f}, pT[2] = {0.0f, 0.0f};
  for (int q0 = k0; q0 < k.len; q0 += kTile) {
    const int qn = min(kTile, k.len - q0);
    __syncthreads();                         // cq_s, dq_s free again
    load_rows(cq_s, ldn, Cm + k.bc_off + q0 * bc_stride, bc_stride, qn, N,
              kN, vec_bc);
    load_rows(dq_s, kLdK, dy + k.x_off + q0 * x_stride, x_stride, qn, P,
              kMaxP, vec_x);
    cp_async_wait();
    __syncthreads();
    float cb[8][4] = {}, dm[8][4] = {};      // (C B^T)^T, (dy x^T)^T: [k][q]
    for (int kk = 0; kk < kN; kk += 16) {
      uint32_t a[4];
      frag_a(a, bk_s, ldn, r0, kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_rows(cb[j], a, cq_s, ldn, 8 * j, kk);
    }
    for (int kk = 0; kk < kMaxP; kk += 16) {
      uint32_t a[4];
      frag_a(a, xk_s, kLdK, r0, kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_rows(dm[j], a, dq_s, kLdK, 8 * j, kk);
    }
    // M^T into cb, (dM L dt)^T into dm; per key the sums of dM C.B L and
    // (off the diagonal) dM M
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k0 + r0 + g + 8 * (e >> 1);
        const int q = q0 + 8 * j + 2 * t + (e & 1);
        float m = 0.0f, d = 0.0f;
        if (kk <= q && q < k.len) {
          const float L = expf(cs_s[q] - cs_s[kk]);
          const float cbl = cb[j][e] * L;
          m = cbl * dt_s[kk];
          d = (dm[j][e] * L) * dt_s[kk];
          pddt[e >> 1] += dm[j][e] * cbl;
          if (kk < q) pT[e >> 1] += dm[j][e] * m;
        }
        cb[j][e] = m;
        dm[j][e] = d;
      }
    // dx += M^T dy, then dB += (dM L dt)^T C, each as hi + lo A fragments
    // from the registers; dy and C read transposed
    {
      uint32_t fh[4][4], fl[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) to_frag(cb[j], j, fh, fl);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t b0, b1;
          ldsm_trans_b(b0, b1, dq_s, kLdK, 8 * j, 16 * kb);
          mma_bf16(dxa[j], fh[kb], b0, b1);
          mma_bf16(dxa[j], fl[kb], b0, b1);
        }
    }
    {
      uint32_t fh[4][4], fl[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) to_frag(dm[j], j, fh, fl);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
#pragma unroll
        for (int j = 0; j < kJn; ++j) {
          uint32_t b0, b1;
          ldsm_trans_b(b0, b1, cq_s, ldn, 8 * j, 16 * kb);
          mma_bf16(db[j], fh[kb], b0, b1);
          mma_bf16(db[j], fl[kb], b0, b1);
        }
    }
  }

  // dx (bf16), the head's dB (float32), the per-key scalars
  uint16_t* dxc = dx + k.x_off + k0 * x_stride;
  const long long hn_stride = static_cast<long long>(H) * N;
  float* dbc = w.db_h + (static_cast<long long>(k.b) * S + k.c0 + k0) *
                            hn_stride + static_cast<long long>(k.h) * N;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = r0 + g + 8 * (e >> 1);
    if (r >= kn) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t + (e & 1);
      if (c < P) dxc[r * x_stride + c] = f32_to_bf16(dxa[j][e]);
    }
#pragma unroll
    for (int j = 0; j < kJn; ++j) {
      const int c = 8 * j + 2 * t + (e & 1);
      if (c < N) dbc[r * hn_stride + c] = db[j][e];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float ddt = quad_sum(pddt[h]), T = quad_sum(pT[h]);
    const int r = r0 + g + 8 * h;
    if (t == 0 && r < kn) {
      const long long o = k.scratch * chunk + k0 + r;
      w.ddt_k[o] = ddt + expf(cs_end - cs_s[k0 + r]) * dw[h];
      w.dcs_k[o] = -T;
      w.wdw[o] = wk[h] * dw[h];
    }
  }
}

template <int kN>
__global__ void __launch_bounds__(kBwdThreads)
chunk_queries_tc(const uint16_t* __restrict__ x, const float* __restrict__ dt,
                 const uint16_t* __restrict__ Bm,
                 const uint16_t* __restrict__ Cm,
                 const uint16_t* __restrict__ dy, BwdWork w, int S, int H,
                 int P, int G, int N, int chunk, int nc, int vec_x,
                 int vec_bc) {
  constexpr int ldn = ld_tc(kN);
  constexpr int kJn = kN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* cq_s = reinterpret_cast<uint16_t*>(smem_raw);  // queries' C
  uint16_t* dq_s = cq_s + kTile * ldn;       // queries' dy [q][p]
  uint16_t* bk_s = dq_s + kTile * kLdK;      // keys' B [k][n]
  uint16_t* xk_s = bk_s + kTile * ldn;       // keys' x [k][p]
  uint16_t* sh_s = xk_s + kTile * kLdK;      // S_in [p][n], hi
  uint16_t* sl_s = sh_s + kTile * ldn;       // and lo
  float* dt_s = reinterpret_cast<float*>(sl_s + kTile * ldn);
  float* cs_s = dt_s + chunk;

  const int bh = blockIdx.z;
  const Chunk k = chunk_of(bh / H, bh % H, blockIdx.x, S, H, P, G, N, chunk,
                           nc);
  const int q0 = blockIdx.y * kTile;
  if (q0 >= k.len) return;
  const int qn = min(kTile, k.len - q0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);    // the warp's 16 queries
  const long long x_stride = static_cast<long long>(H) * P;
  const long long bc_stride = static_cast<long long>(G) * N;
  load_chunk_cs(k, dt, w.cs, H, chunk, dt_s, cs_s);
  load_rows(cq_s, ldn, Cm + k.bc_off + q0 * bc_stride, bc_stride, qn, N, kN,
            vec_bc);
  load_rows(dq_s, kLdK, dy + k.x_off + q0 * x_stride, x_stride, qn, P,
            kMaxP, vec_x);
  load_split(sh_s, sl_s, ldn, w.s_in + k.scratch * P * N, P, N, kN);
  cp_async_wait();
  __syncthreads();

  // the carried state's part: dy S_in, off_q = C_q . (dy S_in)_q
  float dc[kJn][4] = {};
  for (int kk = 0; kk < kMaxP; kk += 16) {
    uint32_t a[4];
    frag_a(a, dq_s, kLdK, r0, kk);
#pragma unroll
    for (int j = 0; j < kJn; ++j) {
      uint32_t b0, b1;
      ldsm_trans_b(b0, b1, sh_s, ldn, 8 * j, kk);
      mma_bf16(dc[j], a, b0, b1);
      ldsm_trans_b(b0, b1, sl_s, ldn, 8 * j, kk);
      mma_bf16(dc[j], a, b0, b1);
    }
  }
  float off[2] = {0.0f, 0.0f}, eq[2];
#pragma unroll
  for (int j = 0; j < kJn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      off[e >> 1] += bf16_to_f32(cq_s[r * ldn + c]) * dc[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    eq[h] = r < qn ? expf(cs_s[q0 + r]) : 0.0f;
    off[h] = eq[h] * quad_sum(off[h]);
  }
#pragma unroll
  for (int j = 0; j < kJn; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dc[j][e] *= eq[e >> 1];

  // the dual form, key tiles at and before the query tile
  float pT[2] = {0.0f, 0.0f};
  for (int k0 = 0; k0 <= q0; k0 += kTile) {
    const int kn = min(kTile, k.len - k0);
    __syncthreads();                         // bk_s, xk_s free again
    load_rows(bk_s, ldn, Bm + k.bc_off + k0 * bc_stride, bc_stride, kn, N,
              kN, vec_bc);
    load_rows(xk_s, kLdK, x + k.x_off + k0 * x_stride, x_stride, kn, P,
              kMaxP, vec_x);
    cp_async_wait();
    __syncthreads();
    float cb[8][4] = {}, dm[8][4] = {};      // C B^T, dy x^T: [q][k]
    for (int kk = 0; kk < kN; kk += 16) {
      uint32_t a[4];
      frag_a(a, cq_s, ldn, r0, kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_rows(cb[j], a, bk_s, ldn, 8 * j, kk);
    }
    for (int kk = 0; kk < kMaxP; kk += 16) {
      uint32_t a[4];
      frag_a(a, dq_s, kLdK, r0, kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_rows(dm[j], a, xk_s, kLdK, 8 * j, kk);
    }
    uint32_t dh[4][4], dl[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + r0 + g + 8 * (e >> 1);
        const int kk = k0 + 8 * j + 2 * t + (e & 1);
        float d = 0.0f;
        if (kk <= q && q < k.len) {
          const float L = expf(cs_s[q] - cs_s[kk]);
          const float m = (cb[j][e] * L) * dt_s[kk];
          d = (dm[j][e] * L) * dt_s[kk];
          if (kk < q) pT[e >> 1] += dm[j][e] * m;
        }
        dm[j][e] = d;
      }
      to_frag(dm[j], j, dh, dl);
    }
    // dC += (dM L dt) B, B read transposed
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int j = 0; j < kJn; ++j) {
        uint32_t b0, b1;
        ldsm_trans_b(b0, b1, bk_s, ldn, 8 * j, 16 * kb);
        mma_bf16(dc[j], dh[kb], b0, b1);
        mma_bf16(dc[j], dl[kb], b0, b1);
      }
  }

  const long long hn_stride = static_cast<long long>(H) * N;
  float* dcc = w.dc_h + (static_cast<long long>(k.b) * S + k.c0 + q0) *
                            hn_stride + static_cast<long long>(k.h) * N;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = r0 + g + 8 * (e >> 1);
    if (r >= qn) continue;
#pragma unroll
    for (int j = 0; j < kJn; ++j) {
      const int c = 8 * j + 2 * t + (e & 1);
      if (c < N) dcc[r * hn_stride + c] = dc[j][e];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float T = quad_sum(pT[h]);
    const int r = r0 + g + 8 * h;
    if (t == 0 && r < qn) w.dcs_q[k.scratch * chunk + q0 + r] = off[h] + T;
  }
}

// A block's sum of v over its threads, in a fixed order (warp shuffles,
// then the warps in order); every thread gets it.
__device__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();                           // scratch free
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < nw; ++i) s += scratch[i];
  return s;
}

// Pass 5, one block per (chunk, h, b): dcs, its reverse cumsum (float64,
// rounded once), ddt and the chunk's part of dA.
__global__ void __launch_bounds__(kThreads)
chunk_finish(const float* __restrict__ dt, const float* __restrict__ A,
             BwdWork w, float* __restrict__ ddt, int S, int H, int P, int N,
             int chunk, int nc) {
  __shared__ float scratch[kThreads / 32];
  extern __shared__ float dcs_s[];           // chunk
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long sc = (static_cast<long long>(b) * H + h) * nc + c;
  const int c0 = c * chunk, len = min(chunk, S - c0);
  const float* cs = w.cs + sc * chunk;
  const float* gp = w.g + sc * P * N;
  const float* sp = w.s_in + sc * P * N;
  float dot = 0.0f, wsum = 0.0f;
  for (int i = threadIdx.x; i < P * N; i += blockDim.x)
    dot = fmaf(gp[i], sp[i], dot);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    wsum += w.wdw[sc * chunk + i];
    dcs_s[i] = (w.dcs_q[sc * chunk + i] + w.dcs_k[sc * chunk + i]) -
               w.wdw[sc * chunk + i];
  }
  dot = block_sum(dot, scratch);
  wsum = block_sum(wsum, scratch);
  if (threadIdx.x == 0) {
    const float a = A[h];
    dcs_s[len - 1] += wsum + expf(cs[len - 1]) * dot;
    const float* dtc = dt + (static_cast<long long>(b) * S + c0) * H + h;
    float* ddtc = ddt + (static_cast<long long>(b) * S + c0) * H + h;
    double run = 0.0;
    float da_sum = 0.0f;
    for (int j = len - 1; j >= 0; --j) {
      run += static_cast<double>(dcs_s[j]);
      const float da = static_cast<float>(run);
      const long long o = static_cast<long long>(j) * H;
      ddtc[o] = w.ddt_k[sc * chunk + j] + a * da;
      da_sum = fmaf(dtc[o], da, da_sum);
    }
    w.da[sc] = da_sum;
  }
}

// Pass 6: dB and dC summed over each group's heads (in head order), dA
// over (b, chunk) (in order), cast to the outputs' types.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_reduce(BwdWork w, T* __restrict__ dB, T* __restrict__ dC,
           float* __restrict__ dA, long long n_bc, int batch, int H, int G,
           int N, int nc) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < H) {
    float s = 0.0f;
    for (int b = 0; b < batch; ++b)
      for (int c = 0; c < nc; ++c)
        s += w.da[(static_cast<long long>(b) * H + i) * nc + c];
    dA[i] = s;
  }
  if (i >= n_bc) return;
  const int rep = H / G;
  const long long bs = i / (static_cast<long long>(G) * N);
  const int gn = static_cast<int>(i - bs * G * N), grp = gn / N, n = gn % N;
  const long long base = bs * H * N + static_cast<long long>(grp) * rep * N +
                         n;
  float sb = 0.0f, sc = 0.0f;
  for (int r = 0; r < rep; ++r) {
    sb += w.db_h[base + static_cast<long long>(r) * N];
    sc += w.dc_h[base + static_cast<long long>(r) * N];
  }
  dB[i] = from_f32<T>(sb);
  dC[i] = from_f32<T>(sc);
}

template <int kN>
int launch_bwd_tiles(const float* x, const float* dt, const float* B,
                     const float* C, const float* dy, const BwdWork& w,
                     float* dx, int batch, int S, int H, int P, int G, int N,
                     int chunk, int nc, cudaStream_t stream) {
  const long long bytes = bwd_tile_bytes(kN, chunk);
  cudaError_t err = allow_shared(chunk_keys<kN>, bytes);
  if (err == cudaSuccess) err = allow_shared(chunk_queries<kN>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nc, (min(chunk, S) + kTile - 1) / kTile, batch * H);
  chunk_keys<kN><<<grid, kBwdThreads, bytes, stream>>>(
      x, dt, B, C, dy, w, dx, S, H, P, G, N, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chunk_queries<kN><<<grid, kBwdThreads, bytes, stream>>>(
      x, dt, B, C, dy, w, S, H, P, G, N, chunk, nc);
  return static_cast<int>(cudaGetLastError());
}

template <int kN>
int launch_bwd_tiles(const uint16_t* x, const float* dt, const uint16_t* B,
                     const uint16_t* C, const uint16_t* dy, const BwdWork& w,
                     uint16_t* dx, int batch, int S, int H, int P, int G,
                     int N, int chunk, int nc, cudaStream_t stream) {
  const long long bytes = tc_tile_bytes(kN, chunk);
  cudaError_t err = allow_shared(chunk_keys_tc<kN>, bytes);
  if (err == cudaSuccess) err = allow_shared(chunk_queries_tc<kN>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte row copies where every row of x and dy (of B and C) starts
  // aligned
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = P % 8 == 0 && al(x) && al(dy);
  const int vec_bc = N % 8 == 0 && al(B) && al(C);
  const dim3 grid(nc, (min(chunk, S) + kTile - 1) / kTile, batch * H);
  chunk_keys_tc<kN><<<grid, kBwdThreads, bytes, stream>>>(
      x, dt, B, C, dy, w, dx, S, H, P, G, N, chunk, nc, vec_x, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chunk_queries_tc<kN><<<grid, kBwdThreads, bytes, stream>>>(
      x, dt, B, C, dy, w, S, H, P, G, N, chunk, nc, vec_x, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

// Passes 1 and 2 (the forward's kernels), per type
int bwd_states(const float* x, const float* dt, const float* A,
               const float* B, const float* C, const float* dy,
               const BwdWork& w, int batch, int S, int H, int P, int G,
               int N, int chunk, int nc, cudaStream_t stream) {
  const long long b1 = state_f32_bytes(P, N, chunk);
  cudaError_t err = allow_shared(chunk_state_f32<false>, b1);
  if (err == cudaSuccess) err = allow_shared(chunk_state_f32<true>, b1);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_state_f32<false><<<dim3(nc, H, batch), kThreads, b1, stream>>>(
      x, dt, A, B, w.cs, w.s_in, S, H, P, G, N, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chunk_state_f32<true><<<dim3(nc, H, batch), kThreads, b1, stream>>>(
      dy, dt, A, C, w.cs, w.g, S, H, P, G, N, chunk, nc);
  return static_cast<int>(cudaGetLastError());
}

int bwd_states(const uint16_t* x, const float* dt, const float* A,
               const uint16_t* B, const uint16_t* C, const uint16_t* dy,
               const BwdWork& w, int batch, int S, int H, int P, int G,
               int N, int chunk, int nc, cudaStream_t stream) {
  const long long b1 = state_bf16_bytes(chunk);
  cudaError_t err = allow_shared(chunk_state_bf16<false>, b1);
  if (err == cudaSuccess) err = allow_shared(chunk_state_bf16<true>, b1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool n8 = N % 8 == 0, p8 = P % 8 == 0;
  const int vec_x = p8 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_dy = p8 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const int vec_b = n8 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const int vec_c = n8 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
  chunk_state_bf16<false><<<dim3(nc, H, batch), kStateThreads, b1, stream>>>(
      x, dt, A, B, w.cs, w.s_in, S, H, P, G, N, chunk, nc, vec_x, vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chunk_state_bf16<true><<<dim3(nc, H, batch), kStateThreads, b1, stream>>>(
      dy, dt, A, C, w.cs, w.g, S, H, P, G, N, chunk, nc, vec_dy, vec_c);
  return static_cast<int>(cudaGetLastError());
}

// carry the state gradient from the last chunk to the first: in: each
// chunk's sum_q exp(cs_q) dy_q (x) C_q; out, in place: G of each chunk
template <typename T>
__global__ void __launch_bounds__(kThreads)
carry_back(const float* __restrict__ cs_g, float* __restrict__ g,
           const T* __restrict__ dfinal, long long n_elems, int PN, int S,
           int chunk, int nc) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n_elems) return;
  const long long bh = i / PN;
  const int pn = static_cast<int>(i - bh * PN);
  const float* cs = cs_g + bh * nc * chunk;
  float* gc = g + bh * nc * PN + pn;
  float run = dfinal != nullptr ? ld_f32(dfinal + i) : 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const int len = min(chunk, S - c * chunk);
    const float decay = expf(cs[static_cast<long long>(c) * chunk + len - 1]);
    const float u = gc[static_cast<long long>(c) * PN];
    gc[static_cast<long long>(c) * PN] = run;
    run = run * decay + u;
  }
}

template <typename T>
int launch_bwd(const T* x, const float* dt, const float* A, const T* B,
               const T* C, const T* dy, const T* dfinal, T* dx, float* ddt,
               float* dA, T* dB, T* dC, float* work, int batch, int S, int H,
               int P, int G, int N, int chunk, cudaStream_t stream) {
  const int nc = (S + chunk - 1) / chunk;
  BwdWork w;
  bwd_work_floats(batch, S, H, P, N, chunk, &w, work);
  int err = bwd_states(x, dt, A, B, C, dy, w, batch, S, H, P, G, N, chunk,
                       nc, stream);
  if (err != 0) return err;
  const long long n = static_cast<long long>(batch) * H * P * N;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  carry<float><<<blocks, kThreads, 0, stream>>>(
      w.cs, w.s_in, nullptr, static_cast<float*>(nullptr), n, P * N, S,
      chunk, nc);
  if ((err = cudaGetLastError()) != 0) return err;
  carry_back<T><<<blocks, kThreads, 0, stream>>>(w.cs, w.g, dfinal, n, P * N,
                                                 S, chunk, nc);
  if ((err = cudaGetLastError()) != 0) return err;
  err = N <= 64 ? launch_bwd_tiles<64>(x, dt, B, C, dy, w, dx, batch, S, H,
                                       P, G, N, chunk, nc, stream)
                : launch_bwd_tiles<kMaxN>(x, dt, B, C, dy, w, dx, batch, S,
                                          H, P, G, N, chunk, nc, stream);
  if (err != 0) return err;
  chunk_finish<<<dim3(nc, H, batch), kThreads, 4 * chunk, stream>>>(
      dt, A, w, ddt, S, H, P, N, chunk, nc);
  if ((err = cudaGetLastError()) != 0) return err;
  const long long n_bc = static_cast<long long>(batch) * S * G * N;
  const long long n_red = n_bc > H ? n_bc : H;
  bwd_reduce<T><<<static_cast<unsigned>((n_red + kThreads - 1) / kThreads),
                  kThreads, 0, stream>>>(w, dB, dC, dA, n_bc, batch, H, G, N,
                                         nc);
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

// dtype codes: 0 = float32, 1 = bfloat16 (x, B, C, y and state). cs is
// float32 scratch of batch * H * nc * chunk values, local of batch * H *
// nc * P * N (nc = ceil(S / chunk)); split (bfloat16 only, else unused)
// uint16 scratch of batch * H * nc * 2 * P * N. Launches the three passes on
// `stream`; returns the first CUDA error (0 = ok). The caller has checked
// shapes (G divides H, ssd_scan_fits), types and contiguity, and that
// batch, S, H, P, N are non-zero.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, void* y, void* state,
                        void* cs, void* local, void* split, int batch, int S,
                        int H,
                        int P, int G, int N, int chunk, int dtype,
                        void* stream) {
  if (ssd_scan_fits(P, N, chunk) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* csf = static_cast<float*>(cs);
  float* lf = static_cast<float*>(local);
  const int nc = (S + chunk - 1) / chunk;
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), dtf, Af,
                      static_cast<const float*>(B),
                      static_cast<const float*>(C), static_cast<float*>(y),
                      static_cast<float*>(state), csf, lf, batch, S, H, P, G,
                      N, chunk, nc, s);
  if (dtype == 1)
    return launch_bf16(static_cast<const uint16_t*>(x), dtf, Af,
                       static_cast<const uint16_t*>(B),
                       static_cast<const uint16_t*>(C),
                       static_cast<uint16_t*>(y),
                       static_cast<uint16_t*>(state), csf, lf,
                       static_cast<uint16_t*>(split), batch, S, H, P, G, N,
                       chunk, nc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory the backward's largest block uses (its passes' most)
extern "C" long long ssd_scan_bwd_shared_bytes(int P, int N, int chunk) {
  const int kn = N <= 64 ? 64 : kMaxN;
  const long long sizes[] = {bwd_tile_bytes(kn, chunk),
                             tc_tile_bytes(kn, chunk),
                             shared_bytes(P, N, chunk)};
  long long m = 0;
  for (long long v : sizes) m = v > m ? v : m;
  return m;
}

// The backward: 0 if it takes P, N and chunk, else 1 or 2 (as
// ssd_scan_fits) or 3 (a block of any of its passes would need more
// shared memory than it may opt into).
extern "C" int ssd_scan_bwd_fits(int P, int N, int chunk) {
  const int fwd = ssd_scan_fits(P, N, chunk);
  if (fwd != 0) return fwd;
  return ssd_scan_bwd_shared_bytes(P, N, chunk) > kMaxShared ? 3 : 0;
}

// float32 workspace the backward needs (the caller allocates it)
extern "C" long long ssd_scan_bwd_workspace(int batch, int S, int H, int P,
                                            int N, int chunk) {
  return bwd_work_floats(batch, S, H, P, N, chunk);
}

// The backward (dtype codes as ssd_scan): x, dt, A, B, C as the forward
// took them, dy (B, S, H, P) and dfinal (B, H, P, N) or null in x's type;
// writes dx (x's type), ddt (B, S, H) float32, dA (H,) float32, dB and dC
// (B, S, G, N) in x's type, with `work` (ssd_scan_bwd_workspace floats) as
// scratch. Eight launches on `stream`; returns the first CUDA error (0 =
// ok). The caller has checked shapes, types, contiguity and
// ssd_scan_bwd_fits, and that batch, S, H, P, N are non-zero.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, const void* dy,
                            const void* dfinal, void* dx, void* ddt,
                            void* dA, void* dB, void* dC, void* work,
                            int batch, int S, int H, int P, int G, int N,
                            int chunk, int dtype, void* stream) {
  if (ssd_scan_bwd_fits(P, N, chunk) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  float* wf = static_cast<float*>(work);
  if (dtype == 0)
    return launch_bwd(
        static_cast<const float*>(x), dtf, Af, static_cast<const float*>(B),
        static_cast<const float*>(C), static_cast<const float*>(dy),
        static_cast<const float*>(dfinal), static_cast<float*>(dx), ddtf,
        dAf, static_cast<float*>(dB), static_cast<float*>(dC), wf, batch, S,
        H, P, G, N, chunk, s);
  if (dtype == 1)
    return launch_bwd(
        static_cast<const uint16_t*>(x), dtf, Af,
        static_cast<const uint16_t*>(B), static_cast<const uint16_t*>(C),
        static_cast<const uint16_t*>(dy),
        static_cast<const uint16_t*>(dfinal), static_cast<uint16_t*>(dx),
        ddtf, dAf, static_cast<uint16_t*>(dB), static_cast<uint16_t*>(dC),
        wf, batch, S, H, P, G, N, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
