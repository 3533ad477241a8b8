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
        const float w = expf(cs_end - cs_s[q]) * dt_s[q];
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
      wk_s[i] = i < kn ? expf(cs_end - cs_s[k0 + i]) * dt_s[k0 + i] : 0.0f;
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
  state_out[i] = from_f32<T>(run);
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
  cudaError_t err = allow_shared(chunk_state_f32, b1);
  if (err == cudaSuccess) err = allow_shared(chunk_scan_f32, b3);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_state_f32<<<dim3(nc, H, batch), kThreads, b1, stream>>>(
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
  cudaError_t err = allow_shared(chunk_state_bf16, b1);
  if (err == cudaSuccess) err = allow_shared(chunk_scan_bf16, b3);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte row loads where every row of x (of B, C) starts aligned
  const int vec_x = P % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_bc = N % 8 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(C) % 16 == 0;
  chunk_state_bf16<<<dim3(nc, H, batch), kStateThreads, b1, stream>>>(
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

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
