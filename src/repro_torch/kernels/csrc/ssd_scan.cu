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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// close the calling thread's cp.async copies issued so far into a group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all of the calling thread's cp.async groups but the newest have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 4 bytes from src, or zeros where !live
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(live ? 4 : 0) : "memory");
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
                          bool vec, int tid = threadIdx.x,
                          int nthr = blockDim.x) {
  const int groups = colsp / 8;
  for (int i = tid; i < kTile * groups; i += nthr) {
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

// a barrier of the block (bar 0) or of the nthr threads of named barrier
// `bar`
__device__ __forceinline__ void group_sync(int bar, int nthr) {
  // immediate ids, so that the block holds three barriers and not all 16
  if (bar == 0)
    __syncthreads();
  else if (bar == 1)
    asm volatile("bar.sync 1, %0;\n" :: "r"(nthr) : "memory");
  else
    asm volatile("bar.sync 2, %0;\n" :: "r"(nthr) : "memory");
}

// dt of positions [0, len) of a chunk into dt_s, and the inclusive cumsum
// of dt * a, summed in float64 and rounded once, into cs_s and cs_out:
// each lane of warp 0 sums a run of positions, a shuffle scan offsets
// the runs.
__device__ void chunk_cumsum(const float* dtc, int H, int len, float a,
                             float* dt_s, float* cs_s, float* cs_out,
                             int tid = threadIdx.x, int nthr = blockDim.x,
                             int bar = 0) {
  for (int i = tid; i < len; i += nthr)
    dt_s[i] = dtc[static_cast<long long>(i) * H];
  group_sync(bar, nthr);
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
      if (cs_out != nullptr) cs_out[i] = cs_s[i];
    }
  }
  group_sync(bar, nthr);
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
      wk_s[i] = i >= kn ? 0.0f : expf(cs_end - cs_s[k0 + i]) * dt_s[k0 + i];
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
//
// The gradients of (y, final state) with respect to x, dt, A, B and C,
// given dy and dfinal (the final state's, or none). With L[q, k] =
// exp(cs_q - cs_k) (k <= q), CB = C B^T (one per group), M = CB L dt_k,
// w_k = exp(cs_end - cs_k) dt_k, S_in the state entering a chunk and G =
// dS_out its gradient leaving it, per head:
//
//   dM = dy x^T (causal)              dCB_h = dM L dt_k
//   dx = M^T dy + w (B G^T)           dw_k = x_k . (B G^T)_k
//   dB = sum_h dCB_h^T C + sum_h w (x G)
//   dC = sum_h dCB_h B + sum_h exp(cs) (dy S_in)
//   ddt = sum_q dM CB L + exp(cs_end - cs) dw + A d(dt A)
//   dA = sum over (b, s) of dt d(dt A)
//   d(dt A)_j = sum_{q >= j} dcs_q (the reverse cumsum of dcs)
//   dcs_q = sum_k (dM M)[q, k] - sum_k (dM M)[k, q] + exp(cs_q) C_q .
//           (dy S_in)_q - w_q dw_q  (+ at the chunk's end: sum_k w_k dw_k
//           + exp(cs_end) <G, S_in>); the diagonal of dM M cancels (L = 1
//           there) and is left out of both sums
//   G[c - 1] = exp(cs_end[c]) G[c] + sum_q exp(cs_q) dy_q (x) C_q
//
// This is what the reference gets from autodiff of models/ssm.py's
// ssd_chunked (which builds C B^T once per group and repeats it over the
// group's heads, so its dB and dC take one product of the heads' summed
// dCB); the Pallas kernel has no VJP.
//
// What bounds it on this card. At mamba2-780m's training call (2, 1024,
// 48, 64), N 128, bf16, one group, the function needs 11.5 GFLOP (per
// causal pair and head dy x^T and M^T dy; per pair and group C B^T and
// dB's and dC's products; the states' five L N P products per head) and
// moves 40.6 MB: 0.0117 ms at 989 TFLOP/s against 0.0121 ms at 3.35 TB/s,
// so bytes; zamba2-7b's (2, 1024, 112, 64), N 64, 17.0 GFLOP and 91 MB,
// 0.0272 ms of bytes.
//
// Passes, on one stream (four launches):
//  1. bwd_states, 256 threads: a block per (b, h, 64 state columns) carries
//     the state over the chunks in two warp groups at once, warps 0-3
//     forward (each chunk's local state (v x)^T B on the tensor cores, S_in
//     of each chunk written as bf16 planes) and warps 4-7 backward from
//     dfinal (G as planes); then the block's share of <G, S_in> of each
//     chunk from the planes. The carries never leave the registers, and
//     S_in and G are split into planes once, here. Blocks past those
//     compute C B^T of one (b, chunk, group, key tile) against its causal
//     query tiles into float32 scratch, in the register order pass 2 reads.
//  2. bwd_dual, 128 threads (4 warps x 16 keys), a cluster of hs CTAs per
//     (b, chunk, group, pair of key tiles kt and its mirror T - 1 - kt, so
//     that every cluster walks T + 1 query tiles), each CTA hps of the
//     group's heads: per head B G^T (dx's state term and dw), G in
//     32-column slices two in flight, then the causal query tiles, the
//     next tile's dy and C B^T in flight: dy x^T once, and from the same
//     registers M^T (dx += M^T dy), the direct ddt, the key side of dcs,
//     the query side of dcs (column sums, then the four warps in order)
//     and dCB_h, summed over the CTA's heads in shared memory. The cluster
//     then sums its CTAs' dCB in rank order through distributed shared
//     memory and writes the group's dCB^T as bf16 planes, once. Pairs of
//     the diagonal or past the chunk's end take masks; L = exp(cs_q -
//     cs_k) of the others factors at the key tile's last cs.
//  3. bwd_group, 256 threads (4 row warps x 2 halves of N), clusters as
//     pass 2 over 64-row tiles: one product per causal pair and group for
//     dB (dCB^T C) and dC (dCB B), the pairs dealt over the cluster; then
//     each CTA's heads' state terms, w (x G) into dB and exp(cs) (dy S_in)
//     into dC (one float32 accumulator over the heads, x and dy exact),
//     and dcs's state term, two stages of tiles in flight; the cluster
//     sums dB and dC in rank order and writes them in the inputs' type.
//  4. bwd_finish, a block per head, a warp per chunk: dcs from the passes'
//     parts, the reverse cumsum as a warp scan in float64 (rounded once),
//     ddt, and dA summed in a fixed order.
// hs is the largest cluster (at most 16 CTAs, the last ones non-portable)
// with which every cluster of the launch is resident at once, asked of
// the device once per shape (pick_cluster). Every sum over heads, warps or
// CTAs runs in a fixed order and no atomics are used: two launches give
// equal bits.
//
// Products. Each runs on the tensor cores with mma.sync m16n8k16 from
// bf16 planes in shared memory (cp.async, ldmatrix.trans for the operands
// stored with the reduction along rows) or, for M, dCB_h and v x,
// straight from registers. An operand is one plane where it is exact in
// bf16 (the bf16 inputs), two (hi + lo) where it is a float32 value of the
// bf16 path (M, dCB, G, S_in, v x), three where the inputs are float32
// (every operand; three bf16 planes hold a float32 exactly), and of the
// plane pairs (i, j) those with i + j below the larger count are
// multiplied: 1, 2 or 3 products in bf16, 6 in float32. One bf16 plane for
// a float32 operand fails the 2-ulp gate 19-220x
// (tests/test_torch_ssm_train.py). Why mma.sync and not wgmma: the M, dCB
// and v x operands are born in registers in mma.sync's fragment layouts,
// the tiles are 16-row warp slices of 64-row tiles, and the card is filled
// by the clusters, not by large tiles.
// Block shapes at mamba2's training shape (bf16, P 64, N 128, chunk 256:
// 4 tiles, 10 causal pairs, 8 (b, chunk) units; ptxas for sm_90a):
//  * pass 1: 192 state blocks + 32 C B^T blocks, 126 registers, 78,848
//    bytes of shared memory (two 128-key slabs of x and B per warp group),
//    two an SM;
//  * pass 2: 2 folds x 12 CTAs (hps 4, as pick_cluster finds on an H100:
//    16 clusters of 16 do not fit at once) x 8 units = 192 CTAs, 252
//    registers, 114,720 bytes (dCB sums 64 KB, B, x, two buffers of dy or
//    of G's slices), two an SM;
//  * pass 3: 192 CTAs, 128 registers, 107,040 bytes (C, two stages), two
//    an SM;
//  * scratch 30.94 MB: S_in and G as planes 25.2 MB, C B^T and the
//    group's dCB 1.3 MB each, the cumsums and per-position parts 3.1 MB.
// What holds it back: every pass runs one or two warps an SM
// sub-partition (pass 2's 64 KB of dCB sums cap it at two CTAs an SM), so
// each warp's chain of loads, products and elementwise work shows its
// latency; at mamba2's shape 0.36 ms, 3.3 % of the bound, pass 2 41 % of
// it (tools/kernel_probe.py, H100 at 700 W).
// float32 takes the same passes with three planes an operand.
//  * Positions past S (and past a chunk's end) load as zeros, take no part
//    in a product and are never stored.

constexpr int kBwdThreads = 128;             // pass 2; a pass-1 warp group
constexpr int kWideThreads = 256;            // passes 1, 3 and 4
constexpr int kMaxCluster = 16;              // CTAs over a group's heads
constexpr int kPart = 64;                    // state columns a pass-1 block
constexpr int kGSlice = 32;                  // G's columns a pass-2 stage

__device__ __forceinline__ float ld_f32(const float* p) { return *p; }
__device__ __forceinline__ float ld_f32(const uint16_t* p) {
  return bf16_to_f32(*p);
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the sum of *p over the cluster's first hs CTAs, in rank order (the
// remote loads issued together)
__device__ __forceinline__ float cluster_sum(const cg::cluster_group& cl,
                                             float* p, int hs) {
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    v[r] = r < hs ? *cl.map_shared_rank(p, r) : 0.0f;
  float s = v[0];
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r)
    if (r < hs) s += v[r];
  return s;
}

// v as NP bf16 planes, v = p[0] + ... + p[NP - 1]: one plane rounds, two
// keep v within 2^-17 |v|, three hold a float32 exactly (save values the
// exponent range cuts); each difference is exact in float32
template <int NP>
__device__ __forceinline__ void split_planes(float v, uint16_t (&p)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    p[i] = f32_to_bf16(v);
    v -= bf16_to_f32(p[i]);
  }
}

// d += A B over the operands' planes: the pairs (i, j) with i + j below the
// larger plane count (the rest are below float32's rounding)
template <int NA, int NB>
__device__ __forceinline__ void mma_planes(float (&d)[4],
                                           const uint32_t (&a)[NA][4],
                                           const uint32_t (&b)[NB][2]) {
  constexpr int kMax = NA > NB ? NA : NB;
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (i + j < kMax) mma_bf16(d, a[i], b[j][0], b[j][1]);
}

// Fragments of NP planes `ps` elements apart: the A fragment of a row-major
// tile, of a tile stored [k][m] (read transposed), the B fragment of a tile
// stored as rows n (k contiguous) or [k][n] (read transposed)
template <int NP>
__device__ __forceinline__ void frag_a_pl(uint32_t (&a)[NP][4],
                                          const uint16_t* s, int ps, int ld,
                                          int r0, int k0) {
#pragma unroll
  for (int i = 0; i < NP; ++i) frag_a(a[i], s + i * ps, ld, r0, k0);
}

template <int NP>
__device__ __forceinline__ void frag_at_pl(uint32_t (&a)[NP][4],
                                           const uint16_t* s, int ps, int ld,
                                           int m0, int k0) {
#pragma unroll
  for (int i = 0; i < NP; ++i) ldsm_trans_a(a[i], s + i * ps, ld, m0, k0);
}

template <int NP>
__device__ __forceinline__ void frag_b_pl(uint32_t (&b)[NP][2],
                                          const uint16_t* s, int ps, int ld,
                                          int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const uint16_t* p = s + i * ps + (n0 + g) * ld + k0 + 2 * t;
    b[i][0] = ld32(p);
    b[i][1] = ld32(p + 8);
  }
}

template <int NP>
__device__ __forceinline__ void frag_bt_pl(uint32_t (&b)[NP][2],
                                           const uint16_t* s, int ps, int ld,
                                           int n0, int k0) {
#pragma unroll
  for (int i = 0; i < NP; ++i)
    ldsm_trans_b(b[i][0], b[i][1], s + i * ps, ld, n0, k0);
}

// The A fragment planes of key block kb of a 16 x 64 accumulator (its
// tiles 2 kb and 2 kb + 1), for the product that reduces over its columns
template <int NP>
__device__ __forceinline__ void acc_frag(uint32_t (&a)[NP][4],
                                         const float (&v)[8][4], int kb) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint16_t p[4][NP];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_planes(v[2 * kb + half][e], p[e]);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      a[i][2 * half] = pack2(p[0][i], p[1][i]);
      a[i][2 * half + 1] = pack2(p[2][i], p[3][i]);
    }
  }
}

// A 64-row tile of the inputs as NP planes (`ps` elements apart, row
// stride ld), rows [0, rows) x cols [0, cols) of src (row stride
// `stride`), zeros up to colsp columns: bf16 by load_rows (cp.async where
// `vec`; the caller waits), float32 split through registers.
template <int NP>
__device__ void load_tile(uint16_t* dst, int ps, int ld, const uint16_t* src,
                          long long stride, int rows, int cols, int colsp,
                          bool vec, int tid = threadIdx.x,
                          int nthr = blockDim.x) {
  static_assert(NP == 1, "bf16 inputs are one plane");
  load_rows(dst, ld, src, stride, rows, cols, colsp, vec, tid, nthr);
}

// (float32: eight loads in flight a thread before their splits)
template <int NP>
__device__ void load_tile(uint16_t* dst, int ps, int ld, const float* src,
                          long long stride, int rows, int cols, int colsp,
                          bool, int tid = threadIdx.x,
                          int nthr = blockDim.x) {
  const int n = kTile * colsp;
  for (int i0 = tid; i0 < n; i0 += 8 * nthr) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nthr, r = i / colsp, c = i - r * colsp;
      v[u] = i < n && r < rows && c < cols ? src[r * stride + c] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nthr, r = i / colsp, c = i - r * colsp;
      if (i >= n) break;
      uint16_t p[NP];
      split_planes(v[u], p);
#pragma unroll
      for (int k = 0; k < NP; ++k) dst[k * ps + r * ld + c] = p[k];
    }
  }
}

// the sum over the four lanes of a quad (the lanes holding one row of an
// mma.sync accumulator), the same bits in each
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// two neighbouring outputs in one store (dst aligned to the pair)
__device__ __forceinline__ void store2(uint16_t* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack2(f32_to_bf16(a), f32_to_bf16(b));
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__host__ __device__ __forceinline__ int pair_of(int qt, int kt) {
  return qt * (qt + 1) / 2 + kt;
}

// The backward's scratch, carved from one workspace (NPF planes of bf16
// for a float32 value: 2 in bf16, 3 in float32):
struct BwdWork {
  float* cs;       // (b, H, nc, chunk) the chunks' cumsums
  uint16_t* sp;    // (b, H, nc, NPF, P, N) S_in as planes
  uint16_t* gp;    // (b, H, nc, NPF, P, N) G as planes
  float* gs;       // (b, H, nc, parts) <G, S_in> by pass 1's parts
  float* cb;       // (b, nc, G, pairs, 64 x 64) C B^T, pass 2's order
  uint16_t* dcb;   // (b, nc, G, pairs, NPF, 64, 64) the group's dCB^T
  float* ddt_k;    // (b, H, nc, chunk) ddt's direct part
  float* dself;    // (b, H, nc, chunk) dcs's key side and -w dw
  float* off;      // (b, H, nc, chunk) dcs's state term
  float* rowt;     // (b, H, nc, tiles, chunk) dcs's query side by key tile
  float* wsum;     // (b, H, nc, tiles) sum of w dw by key tile
};

// Bytes of the workspace; with `base`, its slices into *w.
long long bwd_work_bytes(int batch, int S, int H, int P, int G, int N,
                         int chunk, int npf, BwdWork* w = nullptr,
                         unsigned char* base = nullptr) {
  BwdWork unused;
  if (w == nullptr) w = &unused;
  const long long nc = (S + chunk - 1) / chunk, tiles = (chunk + 63) / 64;
  const long long bhc = static_cast<long long>(batch) * H * nc;
  const long long units = static_cast<long long>(batch) * nc * G;
  const long long pairs = tiles * (tiles + 1) / 2;
  const long long planes = bhc * npf * P * N;
  const struct {
    void* at;
    long long bytes;
  } slices[] = {{&w->cs, 4 * bhc * chunk},
                {&w->sp, 2 * planes},
                {&w->gp, 2 * planes},
                {&w->gs, 4 * bhc * ((N + kPart - 1) / kPart)},
                {&w->cb, 4 * units * pairs * 4096},
                {&w->dcb, 2 * units * pairs * npf * 4096},
                {&w->ddt_k, 4 * bhc * chunk},
                {&w->dself, 4 * bhc * chunk},
                {&w->off, 4 * bhc * chunk},
                {&w->rowt, 4 * bhc * tiles * chunk},
                {&w->wsum, 4 * bhc * tiles}};
  long long off = 0;
  for (const auto& sl : slices) {
    *static_cast<unsigned char**>(sl.at) =
        base == nullptr ? nullptr : base + off;
    off += (sl.bytes + 15) & ~15LL;          // 16-byte aligned slices
  }
  return off;
}

// pass 1's keys a slab: its shared memory is a slab of x (or dy) and of
// (v B) as planes
__host__ __device__ constexpr int state_slab(int npi) {
  return npi == 1 ? 128 : 64;
}

// one pass-1 warp group's shared memory: slabs of x (or dy) and of B (or
// C), v, and the chunk's dt and cs
__host__ __device__ constexpr long long state_group_bytes(int npi,
                                                          int chunk) {
  return (2LL * npi * state_slab(npi) * (kLdK + kPart + 8) +
          4LL * (state_slab(npi) + 2 * chunk) + 15) & ~15LL;
}

__host__ __device__ constexpr long long plane_bytes(int ld) {
  return 2LL * kTile * ld;
}

// shared memory of each pass's block, by planes of the inputs (NPI) and
// of float32 values (NPF)
long long states_bytes(int npi, int npf, int chunk) {
  const long long state = 2 * state_group_bytes(npi, chunk);
  const long long cbr = 3 * npi * plane_bytes(kLdN);
  return state > cbr ? state : cbr;
}
long long dual_bytes(int npi, int npf, int chunk) {
  const int tiles = (chunk + kTile - 1) / kTile;
  const long long g = npf * plane_bytes(kGSlice + 8);
  const long long y = npi * plane_bytes(kLdK);
  return 16384LL * tiles + npi * (plane_bytes(kLdN) + plane_bytes(kLdK)) +
         2 * (g > y ? g : y) + 4LL * (8 * kTile + 8);
}
// pass 3's stage buffer: a 64-row tile of x or dy, G or S_in as planes,
// and the tile's cs, dt and cs_end (132 floats)
__host__ __device__ constexpr long long group_buf(int npi, int npf) {
  return npi * plane_bytes(kLdK) + npf * plane_bytes(kLdN) + 4 * 132;
}
// two stage buffers, or the 2 x 8192 floats staged for the cluster's sum
__host__ __device__ constexpr long long group_region(int npi, int npf) {
  return 2 * group_buf(npi, npf) > 4LL * 2 * 8 * 4 * kWideThreads
             ? 2 * group_buf(npi, npf)
             : 4LL * 2 * 8 * 4 * kWideThreads;
}
long long group_bytes(int npi, int npf) {
  return npi * plane_bytes(kLdN) + group_region(npi, npf) + 4LL * 2 * kTile;
}

// ---- pass 1 ---------------------------------------------------------------

// acc = sum over the chunk's keys k of (v_k a_k)^T b_k for the kPart
// state columns from n_lo: a (len, P) rows of x or dy (row stride
// a_stride), b (len, N) rows of B or C, v_k = exp(cs_end - cs_k) dt_k (the
// local state) or exp(cs_k) (`grad`: the state gradient), by a group of 4
// warps (group thread gt, named barrier bar), warp wm owning P rows 16 wm;
// the keys in slabs of kSlab, both operands copied by cp.async, one
// barrier pair a slab. b stays exact; v a is formed and split into planes
// from a's fragments.
template <typename In, int NPI, int NPF, int kSlab>
__device__ void state_product(float (&acc)[kPart / 8][4], const In* a,
                              const In* b, long long a_stride,
                              long long b_stride, int len, const float* cs_s,
                              const float* dt_s, bool grad, int P, int N,
                              int n_lo, bool vec_a, bool vec_b,
                              uint16_t* x_s, uint16_t* b_s, float* wk_s,
                              int gt, int bar) {
  const int wm = gt >> 5, t = gt & 3;
  const int pm = (P + 15) & ~15, nw = min(kPart, N - n_lo);
  constexpr int kLdB = kPart + 8;
  constexpr int kPsX = kSlab * kLdK, kPsB = kSlab * kLdB;
  const float cs_end = cs_s[len - 1];
#pragma unroll
  for (int j = 0; j < kPart / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  for (int k0 = 0; k0 < len; k0 += kSlab) {
    const int kn = min(kSlab, len - k0);
    for (int i = gt; i < kSlab; i += kBwdThreads)
      wk_s[i] = i >= kn ? 0.0f
                : grad  ? expf(cs_s[k0 + i])
                        : expf(cs_end - cs_s[k0 + i]) * dt_s[k0 + i];
    for (int r = 0; r < kSlab; r += kTile) {
      const int rows = max(0, min(kTile, kn - r));
      load_tile<NPI>(x_s + r * kLdK, kPsX, kLdK, a + (k0 + r) * a_stride,
                     a_stride, rows, P, pm, vec_a, gt, kBwdThreads);
      load_tile<NPI>(b_s + r * kLdB, kPsB, kLdB,
                     b + (k0 + r) * b_stride + n_lo, b_stride, rows, nw,
                     kPart, vec_b, gt, kBwdThreads);
    }
    cp_async_wait();
    group_sync(bar, kBwdThreads);
    if (wm * 16 < P) {
      const int kbs = (kn + 15) / 16;
      for (int kb = 0; kb < kbs; ++kb) {
        uint32_t xa[NPI][4], fa[NPF][4];
        frag_at_pl(xa, x_s, kPsX, kLdK, wm * 16, kb * 16);   // a^T
        // fragment register r holds keys 2t, 2t + 1 (r < 2) or 2t + 8,
        // 2t + 9 (r >= 2) of a row: scale by v_k, split into planes
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = kb * 16 + 2 * t + (r >> 1) * 8;
          float lo = 0.0f, hi = 0.0f;
#pragma unroll
          for (int q = 0; q < NPI; ++q) {
            lo += bf16_to_f32(static_cast<uint16_t>(xa[q][r] & 0xffffu));
            hi += bf16_to_f32(static_cast<uint16_t>(xa[q][r] >> 16));
          }
          uint16_t pl[NPF], ph[NPF];
          split_planes(lo * wk_s[key], pl);
          split_planes(hi * wk_s[key + 1], ph);
#pragma unroll
          for (int q = 0; q < NPF; ++q) fa[q][r] = pack2(pl[q], ph[q]);
        }
#pragma unroll
        for (int j = 0; j < kPart / 8; ++j)
          if (n_lo + 8 * j < N) {
            uint32_t fb[NPI][2];
            frag_bt_pl(fb, b_s, kPsB, kLdB, 8 * j, kb * 16);
            mma_planes(acc[j], fa, fb);
          }
      }
    }
    group_sync(bar, kBwdThreads);            // x_s, b_s, wk_s refill next
  }
}

// element e of accumulator tile j of state_product's layout for group
// thread gt: its (p, n)
__device__ __forceinline__ void state_pos(int gt, int j, int e, int n_lo,
                                          int& p, int& n) {
  const int lane = gt & 31;
  p = (gt >> 5) * 16 + (lane >> 2) + 8 * (e >> 1);
  n = n_lo + 8 * j + 2 * (lane & 3) + (e & 1);
}

// a state in state_product's layout as NPF planes at dst (plane stride P
// N): elements e and e + 1 are neighbouring columns, stored as one word
// where N is even
template <int NPF>
__device__ void store_state(const float (&v)[kPart / 8][4], uint16_t* dst,
                            int gt, int n_lo, int P, int N) {
  const long long pn = static_cast<long long>(P) * N;
#pragma unroll
  for (int j = 0; j < kPart / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      int p, n;
      state_pos(gt, j, e, n_lo, p, n);
      if (p >= P || n >= N) continue;
      uint16_t q0[NPF], q1[NPF];
      split_planes(v[j][e], q0);
      split_planes(v[j][e + 1], q1);
      uint16_t* d = dst + p * N + n;
#pragma unroll
      for (int i = 0; i < NPF; ++i) {
        if (N % 2 == 0) {
          *reinterpret_cast<uint32_t*>(d + i * pn) = pack2(q0[i], q1[i]);
        } else {
          d[i * pn] = q0[i];
          if (n + 1 < N) d[i * pn + 1] = q1[i];
        }
      }
    }
}

// C B^T of one (b, chunk, group, key tile) against its causal query tiles,
// as [key][query] tiles in pass 2's register order: element (j, e) of
// thread `tid` of its 4 warps at ((j * 4 + e) * 128 + tid). Warps 0-3
// take every other query tile, warps 4-7 the ones between.
template <typename In, int NPI>
__device__ void cb_block(int i, const In* Bm, const In* Cm, const BwdWork& w,
                         int S, int G, int N, int chunk, int nc, int tiles_s,
                         int vec_bc, unsigned char* smem) {
  const int kt = i % tiles_s, grp = (i / tiles_s) % G;
  const int c = (i / tiles_s / G) % nc, b = i / tiles_s / G / nc;
  const int c0 = c * chunk, len = min(chunk, S - c0), k0 = kt * kTile;
  if (k0 >= len) return;
  constexpr int kPs = kTile * kLdN;
  uint16_t* b_s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* c_s = b_s + NPI * kPs;           // two query tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, half = warp >> 2;
  const int nk = (N + 15) & ~15;
  const long long bc_stride = static_cast<long long>(G) * N;
  const long long base = (static_cast<long long>(b) * S + c0) * bc_stride +
                         static_cast<long long>(grp) * N;
  const int tiles = (chunk + kTile - 1) / kTile;
  const int pairs = tiles * (tiles + 1) / 2;
  float* out = w.cb + ((static_cast<long long>(b) * nc + c) * G + grp) *
                          pairs * 4096;
  load_tile<NPI>(b_s, kPs, kLdN, Bm + base + k0 * bc_stride, bc_stride,
                 min(kTile, len - k0), N, nk, vec_bc);
  for (int qt0 = kt; qt0 * kTile < len; qt0 += 2) {
    __syncthreads();                         // c_s free again
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q0 = (qt0 + h) * kTile;
      if (q0 < len)
        load_tile<NPI>(c_s + h * NPI * kPs, kPs, kLdN,
                       Cm + base + q0 * bc_stride, bc_stride,
                       min(kTile, len - q0), N, nk, vec_bc);
    }
    cp_async_wait();
    __syncthreads();
    const int qt = qt0 + half;
    if (qt * kTile >= len) continue;
    const uint16_t* cq = c_s + half * NPI * kPs;
    float acc[8][4] = {};
    for (int kk = 0; kk < nk; kk += 16) {
      uint32_t fa[NPI][4];
      frag_a_pl(fa, b_s, kPs, kLdN, wr * 16, kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t fb[NPI][2];
        frag_b_pl(fb, cq, kPs, kLdN, 8 * j, kk);
        mma_planes(acc[j], fa, fb);
      }
    }
    float* dst = out + pair_of(qt, kt) * 4096 + wr * 32 + lane;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[(j * 4 + e) * 128] = acc[j][e];
  }
}

// Pass 1: blocks below batch * H * parts carry one (b, h)'s states over
// its chunks for kPart state columns, two warp groups at once: warps 0-3
// forward (S_in of each chunk), warps 4-7 backward from dfinal (G), each
// written as NPF planes; then the part's share of <G, S_in> of each
// chunk. The rest compute C B^T of one (b, chunk, group, key tile).
template <typename In, int NPI, int NPF>
__global__ void __launch_bounds__(kWideThreads)
bwd_states(const In* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const In* __restrict__ Bm,
           const In* __restrict__ Cm, const In* __restrict__ dy,
           const In* __restrict__ dfinal, BwdWork w, int batch, int S, int H,
           int P, int G, int N, int chunk, int nc, int parts, int tiles_s,
           int vec_x, int vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (static_cast<int>(blockIdx.x) >= batch * H * parts) {
    cb_block<In, NPI>(blockIdx.x - batch * H * parts, Bm, Cm, w, S, G, N,
                      chunk, nc, tiles_s, vec_bc, smem_raw);
    return;
  }
  constexpr int kSlab = state_slab(NPI);
  const int back = threadIdx.x >> 7, gt = threadIdx.x & 127, bar = 1 + back;
  // the group's space: a slab of x or dy, of B or C, v, dt and cs
  unsigned char* gs_raw = smem_raw + back * state_group_bytes(NPI, chunk);
  uint16_t* x_s = reinterpret_cast<uint16_t*>(gs_raw);
  uint16_t* b_s = x_s + NPI * kSlab * kLdK;
  float* wk_s = reinterpret_cast<float*>(b_s + NPI * kSlab * (kPart + 8));
  float* dt_s = wk_s + kSlab;                // chunk
  float* cs_s = dt_s + chunk;                // chunk
  __shared__ float red[kWideThreads / 32];
  const int part = blockIdx.x % parts, bh = blockIdx.x / parts;
  const int b = bh / H, h = bh % H, n_lo = part * kPart;
  const long long x_stride = static_cast<long long>(H) * P;
  const long long bc_stride = static_cast<long long>(G) * N;
  const long long pn = static_cast<long long>(P) * N;
  constexpr int kJ = kPart / 8;

  // forward: S_in of each chunk, then the chunk's local state carried on;
  // backward: G of each chunk (dfinal, or zero, leaving the last), then
  // the chunk's state gradient carried on
  float run[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int p, n;
      state_pos(gt, j, e, n_lo, p, n);
      run[j][e] = back && dfinal != nullptr && p < P && n < N
                      ? ld_f32(dfinal + static_cast<long long>(bh) * pn +
                               p * N + n)
                      : 0.0f;
    }
  for (int step = 0; step < nc; ++step) {
    const int c = back ? nc - 1 - step : step;
    const Chunk k = chunk_of(b, h, c, S, H, P, G, N, chunk, nc);
    chunk_cumsum(dt + k.dt_off, H, k.len, A[h], dt_s, cs_s,
                 part == 0 && !back ? w.cs + k.scratch * chunk : nullptr, gt,
                 kBwdThreads, bar);
    store_state<NPF>(run, (back ? w.gp : w.sp) + k.scratch * NPF * pn, gt,
                     n_lo, P, N);
    float loc[kJ][4];
    state_product<In, NPI, NPF, kSlab>(
        loc, (back ? dy : x) + k.x_off, (back ? Cm : Bm) + k.bc_off, x_stride,
        bc_stride, k.len, cs_s, dt_s, back, P, N, n_lo, vec_x, vec_bc, x_s,
        b_s, wk_s, gt, bar);
    const float decay = expf(cs_s[k.len - 1]);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[j][e] = run[j][e] * decay + loc[j][e];
  }

  // <G, S_in> of each chunk over the part's columns, from the planes
  __syncthreads();
  const int ncols = min(kPart, N - n_lo);
  for (int c = 0; c < nc; ++c) {
    const long long sc = (static_cast<long long>(b) * H + h) * nc + c;
    const uint16_t* gp = w.gp + sc * NPF * pn;
    const uint16_t* sp = w.sp + sc * NPF * pn;
    float dot = 0.0f;
    if (N % 2 == 0) {                        // two columns a word
      const int half = ncols / 2 + ncols % 2;
      for (int i = threadIdx.x; i < P * half; i += kWideThreads) {
        const int p = i / half, n = n_lo + 2 * (i % half);
        float g0 = 0.0f, g1 = 0.0f, s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int q = 0; q < NPF; ++q) {
          const uint32_t gw =
              *reinterpret_cast<const uint32_t*>(gp + q * pn + p * N + n);
          const uint32_t sw =
              *reinterpret_cast<const uint32_t*>(sp + q * pn + p * N + n);
          g0 += bf16_to_f32(static_cast<uint16_t>(gw & 0xffffu));
          g1 += bf16_to_f32(static_cast<uint16_t>(gw >> 16));
          s0 += bf16_to_f32(static_cast<uint16_t>(sw & 0xffffu));
          s1 += bf16_to_f32(static_cast<uint16_t>(sw >> 16));
        }
        dot = fmaf(g0, s0, dot);
        dot = fmaf(g1, s1, dot);
      }
    } else {
      for (int i = threadIdx.x; i < P * ncols; i += kWideThreads) {
        const int p = i / ncols, n = n_lo + i % ncols;
        float gv = 0.0f, sv = 0.0f;
#pragma unroll
        for (int q = 0; q < NPF; ++q) {
          gv += bf16_to_f32(gp[q * pn + p * N + n]);
          sv += bf16_to_f32(sp[q * pn + p * N + n]);
        }
        dot = fmaf(gv, sv, dot);
      }
    }
    dot = block_sum(dot, red);
    if (threadIdx.x == 0) w.gs[sc * parts + part] = dot;
  }
}

// ---- pass 2 ---------------------------------------------------------------

template <typename In, int NPI, int NPF>
__global__ void __launch_bounds__(kBwdThreads, 2)
bwd_dual(const In* __restrict__ x, const float* __restrict__ dt,
         const In* __restrict__ Bm, const In* __restrict__ dy, BwdWork w,
         In* __restrict__ dx, int S, int H, int P, int G, int N, int chunk,
         int nc, int tiles_s, int hs, int hps, int vec_x, int vec_bc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int fold = blockIdx.x / hs, unit = blockIdx.y;
  const int grp = unit % G, c = (unit / G) % nc, b = unit / G / nc;
  const int c0 = c * chunk, len = min(chunk, S - c0);
  // this CTA's tiles: `fold` and its mirror, so that every cluster walks
  // about as many causal tile pairs as any other
  for (int side = 0; side < 2; ++side) {
    const int kt = side == 0 ? fold : tiles_s - 1 - fold, k0 = kt * kTile;
    if ((side == 1 && kt == fold) || k0 >= len) continue;   // whole cluster
    const int kn = min(kTile, len - k0);
    const int ntq = (len - k0 + kTile - 1) / kTile;
    const int tiles = (chunk + kTile - 1) / kTile;
    const int pairs = tiles * (tiles + 1) / 2;
    constexpr int kPsN = kTile * kLdN, kPsK = kTile * kLdK;
    constexpr int kGs = kGSlice, kLdG = kGs + 8, kPsG = kTile * kLdG;
    constexpr int kGY = NPF * kPsG > NPI * kPsK ? NPF * kPsG : NPI * kPsK;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* acc_s = reinterpret_cast<float*>(smem_raw);   // tiles x 4096
    uint16_t* bk_s = reinterpret_cast<uint16_t*>(acc_s + tiles * 4096);
    uint16_t* xk_s = bk_s + NPI * kPsN;        // the head's x, [key][p]
    // two buffers, each a 32-column slice of G [p][n] or a tile of dy [q][p]
    uint16_t* buf[2] = {xk_s + NPI * kPsK, xk_s + NPI * kPsK + kGY};
    float* ck_s = reinterpret_cast<float*>(buf[1] + kGY);  // keys' cs
    float* dk_s = ck_s + kTile;                // keys' dt
    float* cqb = dk_s + kTile;                 // queries' cs, 2 buffers
    float* red = cqb + 2 * kTile;              // 4 warps x 64 queries
    float* red2 = red + 4 * kTile;             // 8

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
    const long long x_stride = static_cast<long long>(H) * P;
    const long long bc_stride = static_cast<long long>(G) * N;
    const long long pn = static_cast<long long>(P) * N;
    const int nk = (N + 15) & ~15, pm = (P + 15) & ~15;
    const bool vec_g = N % 8 == 0;
    const float* cb_unit = w.cb + static_cast<long long>(unit) * pairs * 4096;
    for (int qi = 0; qi < ntq; ++qi)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_s[qi * 4096 + i * 128 + tid] = 0.0f;
    load_tile<NPI>(bk_s, kPsN, kLdN,
                   Bm + (static_cast<long long>(b) * S + c0 + k0) * bc_stride +
                       static_cast<long long>(grp) * N,
                   bc_stride, kn, N, nk, vec_bc);

    // G's slices alternate between the buffers, slice s in buf[s & 1]; query
    // tile qi's dy goes to buf[(d0 + qi) & 1], d0 the buffer the state phase
    // frees first, with its cs (cp.async); its C B^T into registers
    const int ns = (N + kGs - 1) / kGs, d0 = ns == 1 ? 1 : ns & 1;
    const auto issue_g = [&](const Chunk& k, int sl) {
      for (int i = 0; i < NPF; ++i)
        load_rows(buf[sl & 1] + i * kPsG, kLdG,
                  w.gp + (k.scratch * NPF + i) * pn + sl * kGs, N, P,
                  N - sl * kGs, kGs, vec_g);
    };
    const auto issue_q = [&](const Chunk& k, int qi) {
      const int q0 = (kt + qi) * kTile, qn = min(kTile, len - q0);
      load_tile<NPI>(buf[(d0 + qi) & 1], kPsK, kLdK,
                     dy + k.x_off + q0 * x_stride, x_stride, qn, P, kTile,
                     vec_x);
      if (tid < kTile)
        cp_async4(cqb + (qi & 1) * kTile + tid,
                  w.cs + k.scratch * chunk + q0 + min(tid, qn - 1), tid < qn);
    };
    const auto load_cb = [&](float (&cb)[8][4], int qi) {
      const float* cbp = cb_unit + pair_of(kt + qi, kt) * 4096 + tid;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[j][e] = cbp[(j * 4 + e) * 128];
    };

    const int rep = H / G, h0 = grp * rep + rank * hps;
    const int h1 = min(grp * rep + rep, h0 + hps);
    for (int h = h0; h < h1; ++h) {
      const Chunk k = chunk_of(b, h, c, S, H, P, G, N, chunk, nc);
      const float* csc = w.cs + k.scratch * chunk;
      __syncthreads();                         // the last head's buffers
      load_tile<NPI>(xk_s, kPsK, kLdK, x + k.x_off + k0 * x_stride, x_stride,
                     kn, P, kTile, vec_x);
      if (tid < kTile)
        cp_async4(ck_s + tid, csc + k0 + min(tid, kn - 1), tid < kn);
      else
        cp_async4(dk_s + tid - kTile,
                  dt + k.dt_off +
                      static_cast<long long>(k0 + min(tid - kTile, kn - 1)) * H,
                  tid - kTile < kn);
      issue_g(k, 0);
      cp_async_commit();
      if (ns > 1)
        issue_g(k, 1);
      else
        issue_q(k, 0);
      cp_async_commit();
      float cb[8][4];
      load_cb(cb, 0);
      const float cs_end = csc[len - 1];

      // the state term: B G^T (K = N), 32 columns of G a stage, two stages
      // in flight; the first dy tile takes the buffer freed first
      float dxa[8][4] = {};
      for (int sl = 0; sl < ns; ++sl) {
        cp_async_wait_prev();
        __syncthreads();                       // slice sl landed
        const uint16_t* g_s = buf[sl & 1];
        const int n0 = sl * kGs, nw = min(kGs, nk - n0);
        for (int kk = 0; kk < nw; kk += 16) {
          uint32_t fa[NPI][4];
          frag_a_pl(fa, bk_s, kPsN, kLdN, r0, n0 + kk);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j * 8 < P) {
              uint32_t fb[NPF][2];
              frag_b_pl(fb, g_s, kPsG, kLdG, 8 * j, kk);
              mma_planes(dxa[j], fa, fb);
            }
        }
        __syncthreads();                       // buf[sl & 1] free
        if (sl + 2 < ns)
          issue_g(k, sl + 2);
        else if (sl + 2 == ns)
          issue_q(k, 0);
        cp_async_commit();
      }
      // dw_k = x_k . (B G^T)_k, then dx's state term w_k (B G^T)_k
      float dw[2] = {0.0f, 0.0f}, wk[2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
          float xv = 0.0f;
#pragma unroll
          for (int i = 0; i < NPI; ++i)
            xv += bf16_to_f32(xk_s[i * kPsK + r * kLdK + col]);
          dw[e >> 1] = fmaf(xv, dxa[j][e], dw[e >> 1]);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + g + 8 * hh;
        dw[hh] = quad_sum(dw[hh]);
        wk[hh] = r < kn ? expf(cs_end - ck_s[r]) * dk_s[r] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxa[j][e] *= wk[e >> 1];

      // the dual form, query tiles at and after the key tile; the next
      // tile's copies in flight under each tile's products
      float pddt[2] = {0.0f, 0.0f}, pT[2] = {0.0f, 0.0f};
      for (int qi = 0; qi < ntq; ++qi) {
        const int qt = kt + qi, q0 = qt * kTile, qn = min(kTile, len - q0);
        cp_async_wait();
        __syncthreads();                       // tile qi landed, the other
                                               // buffer and red free
        if (qi + 1 < ntq) issue_q(k, qi + 1);
        const uint16_t* dq_s = buf[(d0 + qi) & 1];
        const float* cq_s = cqb + (qi & 1) * kTile;
        // (dy x^T)^T: [key][query], once per pair and head
        float dm[8][4] = {};
        for (int kk = 0; kk < pm; kk += 16) {
          uint32_t fa[NPI][4];
          frag_a_pl(fa, xk_s, kPsK, kLdK, r0, kk);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            uint32_t fb[NPI][2];
            frag_b_pl(fb, dq_s, kPsK, kLdK, 8 * j, kk);
            mma_planes(dm[j], fa, fb);
          }
        }
        // M^T into cb, dCB_h^T into dm; per key the sums of dM CB L and (off
        // the diagonal) dM M, per query those of dM M. A pair below the
        // diagonal and inside the chunk needs no mask, and its L factors as
        // exp(cs_q - cs_ref) exp(cs_ref - cs_k) with cs_ref the key tile's
        // last (both factors at most 1 where cs falls, as dt >= 0, A < 0)
        float cT[8][2] = {};
        if (qt > kt && q0 + kTile <= len) {
          const float ref = ck_s[kTile - 1];
          float ek[2], dk[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            ek[hh] = expf(ref - ck_s[r0 + g + 8 * hh]);
            dk[hh] = dk_s[r0 + g + 8 * hh];
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const float eq = expf(cq_s[8 * j + 2 * t + h2] - ref);
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int e = 2 * hh + h2;
                const float L = eq * ek[hh];
                const float cbl = cb[j][e] * L;
                const float m = cbl * dk[hh];
                const float T = dm[j][e] * m;
                pddt[hh] += dm[j][e] * cbl;
                pT[hh] += T;
                cT[j][h2] += T;
                cb[j][e] = m;
                dm[j][e] = (dm[j][e] * L) * dk[hh];
              }
            }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kr = r0 + g + 8 * (e >> 1);
              const int qc = 8 * j + 2 * t + (e & 1);
              const int gk = k0 + kr, gq = q0 + qc;
              float m = 0.0f, d = 0.0f;
              if (gk <= gq && gq < len) {
                const float L = expf(cq_s[qc] - ck_s[kr]);
                const float cbl = cb[j][e] * L;
                m = cbl * dk_s[kr];
                d = (dm[j][e] * L) * dk_s[kr];
                pddt[e >> 1] += dm[j][e] * cbl;
                if (gk < gq) {
                  const float T = dm[j][e] * m;
                  pT[e >> 1] += T;
                  cT[j][e & 1] += T;
                }
              }
              cb[j][e] = m;
              dm[j][e] = d;
            }
        }
        // dx += M^T dy, M^T as A fragment planes from the registers, dy read
        // transposed
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          uint32_t fa[NPF][4];
          acc_frag(fa, cb, kb);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j * 8 < P) {
              uint32_t fb[NPI][2];
              frag_bt_pl(fb, dq_s, kPsK, kLdK, 8 * j, 16 * kb);
              mma_planes(dxa[j], fa, fb);
            }
        }
        if (qi + 1 < ntq) load_cb(cb, qi + 1);  // M^T is spent
        // dCB summed over the slice's heads (each thread its own elements)
        float* accp = acc_s + qi * 4096 + tid;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) accp[(j * 4 + e) * 128] += dm[j][e];
        // the query side: column sums over the warp's keys, then the warps
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float v = cT[j][h2];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) red[warp * kTile + 8 * j + 2 * t + h2] = v;
          }
        __syncthreads();
        if (tid < qn)
          w.rowt[(k.scratch * tiles + kt) * chunk + q0 + tid] =
              ((red[tid] + red[kTile + tid]) + red[2 * kTile + tid]) +
              red[3 * kTile + tid];
      }

      // the head's dx, the per-key scalars and the tile's sum of w dw
      In* dxc = dx + k.x_off + k0 * x_stride;
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = r0 + g + 8 * (e >> 1);
        if (r >= kn) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t;
          if (col + 1 < P && vec_x)            // the pair as one store
            store2(dxc + r * x_stride + col, dxa[j][e], dxa[j][e + 1]);
          else if (col < P) {
            dxc[r * x_stride + col] = from_f32<In>(dxa[j][e]);
            if (col + 1 < P)
              dxc[r * x_stride + col + 1] = from_f32<In>(dxa[j][e + 1]);
          }
        }
      }
      float wpart = 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float ddt = quad_sum(pddt[hh]), T = quad_sum(pT[hh]);
        const int r = r0 + g + 8 * hh;
        const float wdw = wk[hh] * dw[hh];
        if (t == 0 && r < kn) {
          const long long o = k.scratch * chunk + k0 + r;
          w.ddt_k[o] = ddt + expf(cs_end - ck_s[r]) * dw[hh];
          w.dself[o] = -T - wdw;
          wpart += wdw;
        }
      }
      wpart = block_sum(wpart, red2);
      if (tid == 0) w.wsum[k.scratch * tiles + kt] = wpart;
    }

    // the group's dCB: the cluster's CTAs summed in rank order, written once
    // as planes of dCB^T [key][query]
    cluster_barrier();
    const int n_el = ntq * 4096, share = (n_el + hs - 1) / hs;
    const int e0 = rank * share, e1 = min(n_el, e0 + share);
    for (int i = e0 + tid; i < e1; i += kBwdThreads) {
      const float s = cluster_sum(cluster, acc_s + i, hs);
      const int qi = i >> 12, je = (i >> 7) & 31, ts = i & 127;
      const int j = je >> 2, e = je & 3, ln = ts & 31;
      const int kr = (ts >> 5) * 16 + (ln >> 2) + 8 * (e >> 1);
      const int qc = 8 * j + 2 * (ln & 3) + (e & 1);
      uint16_t p[NPF];
      split_planes(s, p);
      uint16_t* dst = w.dcb + (static_cast<long long>(unit) * pairs +
                               pair_of(kt + qi, kt)) * NPF * 4096;
#pragma unroll
      for (int q = 0; q < NPF; ++q) dst[q * 4096 + kr * kTile + qc] = p[q];
    }
    cluster_barrier();                         // no CTA leaves while read
  }
}

// ---- pass 3 ---------------------------------------------------------------

template <typename In, int NPI, int NPF>
__global__ void __launch_bounds__(kWideThreads, NPI == 1 ? 2 : 1)
bwd_group(const In* __restrict__ x, const float* __restrict__ dt,
          const In* __restrict__ Bm, const In* __restrict__ Cm,
          const In* __restrict__ dy, BwdWork w, In* __restrict__ dB,
          In* __restrict__ dC, int S, int H, int P, int G, int N, int chunk,
          int nc, int tiles_s, int hs, int hps, int vec_x, int vec_bc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int fold = blockIdx.x / hs, unit = blockIdx.y;
  const int grp = unit % G, c = (unit / G) % nc, b = unit / G / nc;
  const int c0 = c * chunk, len = min(chunk, S - c0);
  // this CTA's tiles: `fold` and its mirror, so that every cluster walks
  // about as many causal tile pairs as any other
  for (int side = 0; side < 2; ++side) {
    const int tt = side == 0 ? fold : tiles_s - 1 - fold, t0 = tt * kTile;
    if ((side == 1 && tt == fold) || t0 >= len) continue;   // whole cluster
    const int rn = min(kTile, len - t0);
    const int ntq = (len - t0 + kTile - 1) / kTile;
    const int tiles = (chunk + kTile - 1) / kTile;
    const int pairs = tiles * (tiles + 1) / 2;
    constexpr int kPsN = kTile * kLdN, kPsK = kTile * kLdK;
    constexpr long long kBuf = group_buf(NPI, NPF);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint16_t* ct_s = reinterpret_cast<uint16_t*>(smem_raw);  // C, tile rows
    unsigned char* region = smem_raw + NPI * plane_bytes(kLdN);
    float* stage = reinterpret_cast<float*>(region);          // 2 x 8192
    float* offr = reinterpret_cast<float*>(region + group_region(NPI, NPF));

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3, wr = warp & 3, wn = warp >> 2;
    const int r0 = wr * 16;
    const long long x_stride = static_cast<long long>(H) * P;
    const long long bc_stride = static_cast<long long>(G) * N;
    const long long pn = static_cast<long long>(P) * N;
    const long long bc_base = (static_cast<long long>(b) * S + c0) * bc_stride +
                              static_cast<long long>(grp) * N;
    const int nk = (N + 15) & ~15, pm = (P + 15) & ~15;
    const bool vec_g = N % 8 == 0;
    const int rep = H / G, h0 = grp * rep + rank * hps;
    const int nh = max(0, min(grp * rep + rep, h0 + hps) - h0);

    // Stage i (of 2 nh) of the heads' state terms, into buffer i & 1: head
    // h0 + i / 2's rows of x and G (even i) or of dy and S_in (odd i)
    const auto issue = [&](int i) {
      if (i >= 2 * nh) return;
      const int h = h0 + (i >> 1);
      const bool odd = i & 1;
      const Chunk k = chunk_of(b, h, c, S, H, P, G, N, chunk, nc);
      unsigned char* buf = region + (i & 1) * kBuf;
      uint16_t* tile = reinterpret_cast<uint16_t*>(buf);
      uint16_t* st = tile + NPI * kPsK;
      float* sc = reinterpret_cast<float*>(st + NPF * kPsN);
      load_tile<NPI>(tile, kPsK, kLdK, (odd ? dy : x) + k.x_off + t0 * x_stride,
                     x_stride, rn, P, kTile, vec_x);
      for (int q = 0; q < NPF; ++q)
        load_rows(st + q * kPsN, kLdN,
                  (odd ? w.sp : w.gp) + (k.scratch * NPF + q) * pn, N, P, N, nk,
                  vec_g);
      const float* csc = w.cs + k.scratch * chunk;
      if (tid < kTile)
        cp_async4(sc + tid, csc + t0 + min(tid, rn - 1), tid < rn);
      else if (tid < 2 * kTile)
        cp_async4(sc + tid,
                  dt + k.dt_off + static_cast<long long>(t0 + min(tid - kTile,
                                                                  rn - 1)) * H,
                  tid - kTile < rn);
      else if (tid == 2 * kTile)
        cp_async4(sc + tid, csc + len - 1, true);
    };

    load_tile<NPI>(ct_s, kPsN, kLdN, Cm + bc_base + t0 * bc_stride, bc_stride,
                   rn, N, nk, vec_bc);
    issue(0);
    cp_async_commit();

    // dB += dCB^T C over the query tiles at and after this tile, dC += dCB B
    // over the key tiles at and before it: one product per pair and group,
    // the pairs dealt over the cluster (their operands in buffer 1)
    float db[8][4] = {}, dc[8][4] = {};
    uint16_t* d_s = reinterpret_cast<uint16_t*>(region + kBuf);  // dCB^T [k][q]
    uint16_t* o_s = d_s + NPF * kPsK;          // C or B, [row][n]
    const int n_items = ntq + tt + 1;
    for (int item = rank; item < n_items; item += hs) {
      const bool side_b = item < ntq;
      const int other = side_b ? tt + item : item - ntq;
      const int pr = side_b ? pair_of(other, tt) : pair_of(tt, other);
      __syncthreads();                         // buffer 1 free
      const uint16_t* src =
          w.dcb + (static_cast<long long>(unit) * pairs + pr) * NPF * 4096;
      for (int i = 0; i < NPF; ++i)
        load_rows(d_s + i * kPsK, kLdK, src + i * 4096, kTile, kTile, kTile,
                  kTile, true);
      load_tile<NPI>(o_s, kPsN, kLdN,
                     (side_b ? Cm : Bm) + bc_base + other * kTile * bc_stride,
                     bc_stride, min(kTile, len - other * kTile), N, nk, vec_bc);
      cp_async_wait();
      __syncthreads();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        uint32_t fa[NPF][4];
        if (side_b)
          frag_a_pl(fa, d_s, kPsK, kLdK, r0, 16 * kb);      // rows: keys
        else
          frag_at_pl(fa, d_s, kPsK, kLdK, r0, 16 * kb);     // rows: queries
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n0 = wn * kTile + 8 * j;
          if (n0 < N) {
            uint32_t fb[NPI][2];
            frag_bt_pl(fb, o_s, kPsN, kLdN, n0, 16 * kb);
            if (side_b)
              mma_planes(db[j], fa, fb);
            else
              mma_planes(dc[j], fa, fb);
          }
        }
      }
    }
    __syncthreads();                           // buffer 1 free
    issue(1);
    cp_async_commit();

    // the state terms of the heads of this CTA's slice, two stages in flight
    for (int i = 0; i < 2 * nh; ++i) {
      cp_async_wait_prev();
      __syncthreads();                         // stage i landed for all
      const bool odd = i & 1;
      const unsigned char* buf = region + (i & 1) * kBuf;
      const uint16_t* tile = reinterpret_cast<const uint16_t*>(buf);
      const uint16_t* st = tile + NPI * kPsK;
      const float* sc = reinterpret_cast<const float*>(st + NPF * kPsN);
      float tmp[8][4] = {};
      for (int kb = 0; kb < pm; kb += 16) {
        uint32_t fa[NPI][4];
        frag_a_pl(fa, tile, kPsK, kLdK, r0, kb);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n0 = wn * kTile + 8 * j;
          if (n0 < N) {
            uint32_t fb[NPF][2];
            frag_bt_pl(fb, st, kPsN, kLdN, n0, kb);
            mma_planes(tmp[j], fa, fb);
          }
        }
      }
      float f[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + g + 8 * hh;
        f[hh] = r >= rn ? 0.0f
                : odd   ? expf(sc[r])                         // exp(cs)
                        : expf(sc[2 * kTile] - sc[r]) * sc[kTile + r];  // w
      }
      float eoff = 0.0f;
      if (!odd) {                              // w (x G) into dB
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) db[j][e] += f[e >> 1] * tmp[j][e];
      } else {                                 // exp(cs) (dy S_in) into dC,
        float od[2] = {0.0f, 0.0f};            // and dcs's C . (dy S_in)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + g + 8 * (e >> 1);
            const int col = wn * kTile + 8 * j + 2 * t + (e & 1);
            dc[j][e] += f[e >> 1] * tmp[j][e];
            if (col >= N) continue;            // C's tile ends at nk
            float cv = 0.0f;
#pragma unroll
            for (int q = 0; q < NPI; ++q)
              cv += bf16_to_f32(ct_s[q * kPsN + r * kLdN + col]);
            od[e >> 1] = fmaf(cv, tmp[j][e], od[e >> 1]);
          }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float v = quad_sum(od[hh]);
          if (t == 0) offr[wn * kTile + r0 + g + 8 * hh] = v;
        }
        if (tid < rn) eoff = expf(sc[tid]);
      }
      __syncthreads();                         // buffer i & 1 read, offr full
      if (odd && tid < rn) {
        const Chunk k = chunk_of(b, h0 + (i >> 1), c, S, H, P, G, N, chunk, nc);
        w.off[k.scratch * chunk + t0 + tid] =
            eoff * (offr[tid] + offr[kTile + tid]);
      }
      issue(i + 2);
      cp_async_commit();
    }

    // dB and dC: the cluster's CTAs summed in rank order
    cp_async_wait();
    __syncthreads();                           // region free
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        stage[(j * 4 + e) * kWideThreads + tid] = db[j][e];
        stage[8192 + (j * 4 + e) * kWideThreads + tid] = dc[j][e];
      }
    cluster_barrier();
    const int share = (16384 + hs - 1) / hs;
    const int e0 = rank * share, e1 = min(16384, e0 + share);
    for (int i = e0 + tid; i < e1; i += kWideThreads) {
      const float s = cluster_sum(cluster, stage + i, hs);
      const int which = i >> 13, je = (i >> 8) & 31, ts = i & 255;
      const int j = je >> 2, e = je & 3, ln = ts & 31, ws = ts >> 5;
      const int row = (ws & 3) * 16 + (ln >> 2) + 8 * (e >> 1);
      const int col = (ws >> 2) * kTile + 8 * j + 2 * (ln & 3) + (e & 1);
      if (row < rn && col < N)
        (which ? dC : dB)[bc_base + (t0 + row) * bc_stride + col] =
            from_f32<In>(s);
    }
    cluster_barrier();                         // no CTA leaves while read
  }
}

// ---- pass 4 ---------------------------------------------------------------

// out[j] = sum of d[j .. len), summed in float64 and rounded once, by one
// warp: each lane sums a run of positions from the end, a shuffle scan
// offsets the runs
__device__ void warp_revsum(const float* d, int len, float* out) {
  const int lane = threadIdx.x & 31;
  const int per = (len + 31) / 32;
  const int hi = max(len - lane * per, 0), lo = max(hi - per, 0);
  double run = 0.0;
  for (int i = lo; i < hi; ++i) run += static_cast<double>(d[i]);
  double incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  double acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.0;
  for (int i = hi - 1; i >= lo; --i) {
    acc += static_cast<double>(d[i]);
    out[i] = static_cast<float>(acc);
  }
  __syncwarp();
}

// Pass 4, a block per head, each warp a (b, chunk) in turn: dcs from the
// passes' parts, its reverse cumsum, ddt, and the chunk's part of dA; dA
// adds each warp's chunks in order, then the warps in order.
__global__ void __launch_bounds__(kWideThreads)
bwd_finish(const float* __restrict__ dt, const float* __restrict__ A,
           BwdWork w, float* __restrict__ ddt, float* __restrict__ dA,
           int batch, int S, int H, int N, int chunk, int nc) {
  __shared__ float red[kWideThreads / 32];
  extern __shared__ float fin_s[];           // 8 warps x 2 x chunk
  const int h = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (chunk + kTile - 1) / kTile;
  const int parts = (N + kPart - 1) / kPart;
  float* dcs_s = fin_s + warp * 2 * chunk;
  float* da_s = dcs_s + chunk;
  const float a = A[h];
  float total = 0.0f;
  for (int i = warp; i < batch * nc; i += kWideThreads / 32) {
    const int b = i / nc, c = i % nc;
    const long long sc = (static_cast<long long>(b) * H + h) * nc + c;
    const int c0 = c * chunk, len = min(chunk, S - c0);
    for (int j = lane; j < len; j += 32) {
      float v = w.dself[sc * chunk + j] + w.off[sc * chunk + j];
      for (int kt = 0; kt <= j / kTile; ++kt)
        v += w.rowt[(sc * tiles + kt) * chunk + j];
      dcs_s[j] = v;
    }
    __syncwarp();
    if (lane == 0) {
      float ws = 0.0f, gs = 0.0f;
      for (int kt = 0; kt * kTile < len; ++kt) ws += w.wsum[sc * tiles + kt];
      for (int q = 0; q < parts; ++q) gs += w.gs[sc * parts + q];
      dcs_s[len - 1] += ws + expf(w.cs[sc * chunk + len - 1]) * gs;
    }
    __syncwarp();
    warp_revsum(dcs_s, len, da_s);
    float part = 0.0f;
    for (int j = lane; j < len; j += 32) {
      const long long o = (static_cast<long long>(b) * S + c0 + j) * H + h;
      ddt[o] = w.ddt_k[sc * chunk + j] + a * da_s[j];
      part = fmaf(dt[o], da_s[j], part);
    }
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    total += part;
    __syncwarp();                            // dcs_s, da_s refill next
  }
  if (lane == 0) red[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < kWideThreads / 32; ++i) s += red[i];
    dA[h] = s;
  }
}

// ---- launch ---------------------------------------------------------------

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    dim3 grid, int threads, long long smem, int hs,
                    cudaStream_t stream) {
  *cfg = {};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = hs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The cluster passes 2 and 3 launch with: the largest number hs of CTAs
// over a group's heads (hps heads each, at most kMaxCluster CTAs) with which
// every one of `clusters` clusters is resident at once, or else the one that
// holds the most CTAs at once; asked of the device once per shape.
template <typename K>
cudaError_t pick_cluster(K* kernel, int threads, long long smem, int rep,
                         int clusters, int* hs, int* hps) {
  struct Entry {
    const void* kernel;
    long long smem;
    int threads, rep, clusters, hs, hps;
  };
  static Entry cache[64];
  static int n_cache = 0;
  for (int i = 0; i < n_cache; ++i) {
    const Entry& e = cache[i];
    if (e.kernel == reinterpret_cast<const void*>(kernel) &&
        e.smem == smem && e.threads == threads && e.rep == rep &&
        e.clusters == clusters) {
      *hs = e.hs;
      *hps = e.hps;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  long long best = -1;
  int prev = 0;
  for (int cmax = kMaxCluster; cmax >= 1; --cmax) {
    const int p = (rep + cmax - 1) / cmax, n = (rep + p - 1) / p;
    if (n == prev) continue;
    prev = n;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(&cfg, &attr, dim3(n), threads, smem, n, nullptr);
    int active = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg)) !=
        cudaSuccess)
      return err;
    const long long live = static_cast<long long>(min(active, clusters)) * n;
    if (active >= clusters) {                // one wave: the largest fitting
      *hs = n;
      *hps = p;
      break;
    }
    if (live > best) {
      best = live;
      *hs = n;
      *hps = p;
    }
  }
  if (n_cache < 64)
    cache[n_cache++] = {reinterpret_cast<const void*>(kernel), smem, threads,
                        rep, clusters, *hs, *hps};
  return cudaSuccess;
}

template <typename In, int NPI, int NPF>
int launch_bwd(const In* x, const float* dt, const float* A, const In* B,
               const In* C, const In* dy, const In* dfinal, In* dx,
               float* ddt, float* dA, In* dB, In* dC, void* work, int batch,
               int S, int H, int P, int G, int N, int chunk,
               cudaStream_t stream) {
  const int nc = (S + chunk - 1) / chunk;
  const int tiles_s = (min(chunk, S) + kTile - 1) / kTile;
  BwdWork w;
  bwd_work_bytes(batch, S, H, P, G, N, chunk, NPF, &w,
                 static_cast<unsigned char*>(work));
  const int rep = H / G;
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = P % 8 == 0 && al(x) && al(dy);
  const int vec_bc = N % 8 == 0 && al(B) && al(C);

  const long long b1 = states_bytes(NPI, NPF, chunk);
  const long long b2 = dual_bytes(NPI, NPF, chunk);
  const long long b3 = group_bytes(NPI, NPF);
  cudaError_t err = allow_shared(bwd_states<In, NPI, NPF>, b1);
  if (err == cudaSuccess) err = allow_shared(bwd_dual<In, NPI, NPF>, b2);
  if (err == cudaSuccess) err = allow_shared(bwd_group<In, NPI, NPF>, b3);
  if (err == cudaSuccess) err = allow_shared(bwd_finish, 64LL * chunk);
  // the group's heads in slices of hps over hs CTAs, per cluster pass
  const int clusters = (tiles_s + 1) / 2 * batch * nc * G;
  int hs2 = 1, hps2 = rep, hs3 = 1, hps3 = rep;
  if (err == cudaSuccess)
    err = pick_cluster(bwd_dual<In, NPI, NPF>, kBwdThreads, b2, rep,
                       clusters, &hs2, &hps2);
  if (err == cudaSuccess)
    err = pick_cluster(bwd_group<In, NPI, NPF>, kWideThreads, b3, rep,
                       clusters, &hs3, &hps3);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int parts = (N + kPart - 1) / kPart;
  const int blocks1 = batch * H * parts + batch * nc * G * tiles_s;
  bwd_states<In, NPI, NPF><<<blocks1, kWideThreads, b1, stream>>>(
      x, dt, A, B, C, dy, dfinal, w, batch, S, H, P, G, N, chunk, nc, parts,
      tiles_s, vec_x, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int folds = (tiles_s + 1) / 2;
  cluster_config(&cfg, &attr, dim3(folds * hs2, batch * nc * G), kBwdThreads,
                 b2, hs2, stream);
  err = cudaLaunchKernelEx(&cfg, bwd_dual<In, NPI, NPF>, x, dt, B, dy, w, dx,
                           S, H, P, G, N, chunk, nc, tiles_s, hs2, hps2, vec_x,
                           vec_bc);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  cluster_config(&cfg, &attr, dim3(folds * hs3, batch * nc * G), kWideThreads,
                 b3, hs3, stream);
  err = cudaLaunchKernelEx(&cfg, bwd_group<In, NPI, NPF>, x, dt, B, C, dy, w,
                           dB, dC, S, H, P, G, N, chunk, nc, tiles_s, hs3, hps3,
                           vec_x, vec_bc);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  bwd_finish<<<H, kWideThreads, 64 * chunk, stream>>>(
      dt, A, w, ddt, dA, batch, S, H, N, chunk, nc);
  return static_cast<int>(cudaGetLastError());
}

// the most shared memory any backward block of the type uses
long long bwd_shared_bytes(int P, int N, int chunk, int dtype) {
  const int npi = dtype == 0 ? 3 : 1, npf = dtype == 0 ? 3 : 2;
  const long long sizes[] = {states_bytes(npi, npf, chunk),
                             dual_bytes(npi, npf, chunk),
                             group_bytes(npi, npf), 64LL * chunk};
  long long m = 0;
  for (long long v : sizes) m = v > m ? v : m;
  return m;
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

// Shared memory the backward's largest block uses for the type (dtype
// codes as ssd_scan)
extern "C" long long ssd_scan_bwd_shared_bytes(int P, int N, int chunk,
                                               int dtype) {
  return bwd_shared_bytes(P, N, chunk, dtype);
}

// The backward: 0 if it takes P, N and chunk in the type, else 1 or 2 (as
// ssd_scan_fits) or 3 (a block of any of its passes would need more
// shared memory than it may opt into).
extern "C" int ssd_scan_bwd_fits(int P, int N, int chunk, int dtype) {
  const int fwd = ssd_scan_fits(P, N, chunk);
  if (fwd != 0) return fwd;
  return bwd_shared_bytes(P, N, chunk, dtype) > kMaxShared ? 3 : 0;
}

// float32 words of workspace the backward needs (the caller allocates it)
extern "C" long long ssd_scan_bwd_workspace(int batch, int S, int H, int P,
                                            int G, int N, int chunk,
                                            int dtype) {
  return (bwd_work_bytes(batch, S, H, P, G, N, chunk, dtype == 0 ? 3 : 2) +
          3) / 4;
}

// The backward (dtype codes as ssd_scan): x, dt, A, B, C as the forward
// took them, dy (B, S, H, P) and dfinal (B, H, P, N) or null in x's type;
// writes dx (x's type), ddt (B, S, H) float32, dA (H,) float32, dB and dC
// (B, S, G, N) in x's type, with `work` (ssd_scan_bwd_workspace words) as
// scratch. Four launches on `stream`; returns the first CUDA error (0 =
// ok). The caller has checked shapes, types, contiguity and
// ssd_scan_bwd_fits, and that batch, S, H, P, N are non-zero.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, const void* dy,
                            const void* dfinal, void* dx, void* ddt,
                            void* dA, void* dB, void* dC, void* work,
                            int batch, int S, int H, int P, int G, int N,
                            int chunk, int dtype, void* stream) {
  if (ssd_scan_bwd_fits(P, N, chunk, dtype) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  if (dtype == 0)
    return launch_bwd<float, 3, 3>(
        static_cast<const float*>(x), dtf, Af, static_cast<const float*>(B),
        static_cast<const float*>(C), static_cast<const float*>(dy),
        static_cast<const float*>(dfinal), static_cast<float*>(dx), ddtf,
        dAf, static_cast<float*>(dB), static_cast<float*>(dC), work, batch,
        S, H, P, G, N, chunk, s);
  if (dtype == 1)
    return launch_bwd<uint16_t, 1, 2>(
        static_cast<const uint16_t*>(x), dtf, Af,
        static_cast<const uint16_t*>(B), static_cast<const uint16_t*>(C),
        static_cast<const uint16_t*>(dy),
        static_cast<const uint16_t*>(dfinal), static_cast<uint16_t*>(dx),
        ddtf, dAf, static_cast<uint16_t*>(dB), static_cast<uint16_t*>(dC),
        work, batch, S, H, P, G, N, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
