// flash_attention — forward attention with an online softmax
//
//   out[b, i, h] = sum_j p_ij v[b, j, h / G] / sum_j p_ij,
//   p_ij = exp(s_ij - m_i) over the visible keys j, 0 elsewhere,
//   s_ij = cap * tanh(scale * (q[b, i, h] . k[b, j, h / G]) / cap)
//
// q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv), out (B, Sq,
// Hq, Dv), all float32 or all bfloat16 and contiguous; G = Hq / Hkv
// (GQA). Query row i sits at global position p_i = q_off + i (q_off > 0
// when the rows are one rank's chunk of a sequence whose keys are all
// given: sequence-parallel attention; q_off + Sq <= Sk). Key j is visible
// from query row i iff j < Sk, when causal j <= p_i or j < prefix[b] (the
// prefix-LM mask of a VLM: the image prefix attends bidirectionally; no
// prefix array means 0), and p_i - j < window when a window is set (the
// last `window` keys including the query itself). The softcap, when set,
// is applied before the mask, as in the reference. Scores, the running
// max/sum and the accumulator are float32. When asked, both kernels also
// write each row's log-sum-exp, lse[b, h, i] = max_j s_ij + log sum_j
// exp(s_ij - max_j s_ij) (float32, natural units), which the backward
// (flash_attention_bwd.cu) reads to
// recompute P without a second pass. The tensor-core kernel is compiled
// once per head-dim tile and per (prefix, lse) pair asked for, so a launch
// without them runs the code it ran before they existed.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (Pallas body _attn_kernel), whose grid ran the KV blocks
// of one (head, query block) in sequence on one core, with the running
// (m, l, acc) in VMEM, and which needed S to be a multiple of its blocks.
//
// What bounds it on this card: operations. A query row does
// 2 (D + Dv) flops per visible key and reads nothing new, so at the
// serving path's shapes (gemma2-2b: D = Dv = 256, S = 4608; zamba2-7b:
// D = Dv = 224) the bound is the flops over the 989 TFLOP/s dense bf16
// tensor-core rate: about 88 us for a 4608-token causal layer of 8 heads.
//
// Two kernels, chosen by dtype (never one after the other's failure):
//
// bfloat16: flash_attention_tc_kernel, on the tensor cores.
//  * One block of 384 threads per (query tile of 128 rows, q head,
//    batch): warpgroup 0 is the producer (one thread issues every load,
//    `setmaxnreg` drops the group to 24 registers), warpgroups 1 and 2
//    are consumers of 64 query rows each (240 registers). blockIdx.x runs
//    over the query tiles in reverse, so the longest causal tiles start
//    first and the short ones fill the tail.
//  * Loads: TMA (cp.async.bulk.tensor) of the Q tile once and of 64-key
//    K and V tiles into a ring of 2 stages, each tile as 64-column boxes
//    of 128-byte swizzled rows, completion on mbarriers ("full" per
//    stage, "empty" released by all 256 consumer threads). The tensor
//    maps are 4-D boxes over (D, H, S, B), encoded on the host with
//    cuTensorMapEncodeTiled fetched through cudaGetDriverEntryPoint (no
//    -lcuda). Rows and keys past S and columns past D load as zeros, so
//    any S and any head dim that is a multiple of 8 up to 256 work: the
//    head dim is padded to 64, 128 or 256 (zeros add exactly nothing).
//    At 256 the shared memory is Q 64 KB + 2 x (K 32 KB + V 32 KB) + P
//    32 KB.
//  * S = Q K^T on wgmma m64n64k16 (both operands K-major from shared
//    memory), then, on the float32 fragments in registers: the scale,
//    the softcap, the causal/window/ragged mask (only on tiles that cross
//    the band's edge), and the online softmax with a float32 running max
//    and sum; the sum adds the unrounded p. The softmax runs in log2
//    units (exp2f), and the softcap as cap - 2 cap / (exp(2 s / cap) + 1)
//    = cap tanh(s / cap) with one exp2f and one fast division (tanhf and
//    the IEEE division are software sequences): at cap = 50 they err by a
//    few 1e-5 in s, which moves p by as much relative, far inside the
//    bf16 output's 2^-8.
//  * O += P V on wgmma m64nDk16, D = 64, 128 or 256 (the padded Dv), with
//    V from shared memory (MN-major: the transpose bit that 16-bit types
//    allow). P is split into bf16 hi = bf16(p) and lo = bf16(p - hi); both
//    go through shared memory as two swizzled 64 x 64 tiles per consumer
//    (K-major A operands) into the one float32 O accumulator (128
//    registers at Dv = 256). In registers the split would need 32 more per
//    thread, and at Dv = 256 ptxas then serialized the products and
//    spilled. The split is 1.5x the tensor-core work of one QK^T and one
//    PV (three products of the tile's size instead of two).
//  * Per tile, the next tile's QK^T and this tile's PV go to the tensor
//    cores back to back, one wait for both; the two consumers interleave,
//    one's softmax beside the other's products.
//  * The band: KV tiles from the first the window reaches to the one
//    holding the block's last diagonal; a consumer only passes on a tile
//    that is wholly masked for its 64 rows (waits for it and frees it).
//  * A query offset (a chunk of the queries against every key) moves the
//    band and the mask to the rows' positions q_off + i: the Q map has Sq
//    rows, the K and V maps Sk, and out and lse are written at the rows
//    themselves. It is a host int, so it costs no read and no branch.
//  * Two traps of bf16 arithmetic, both measured against the float32
//    plain version's 2-ulp gate (tests/test_torch_attention_numerics.py
//    pins them): rounding P once to bf16 before PV is 11-14x over the
//    gate in rows whose output cancels near zero, hence hi + lo; and
//    pre-scaling Q, which as a tensor-core operand would round q * scale
//    to bf16 (exact only for a power-of-two scale such as 256^-0.5), is
//    about 19x over at D = 224, hence the scale on the float32 scores.
//  * No atomics: every output element is written once by one thread;
//    the loads and products are in a fixed order, so two launches give
//    equal bits.
//
// float32: flash_attention_kernel, SIMT. Any tensor-core form (TF32, or
// bf16 inputs) would break float32's rtol 1e-5 against the plain
// version. One block of 128 threads per (16 query rows, q head, batch);
// eight threads own a query row, score 8 of each 64-key tile's keys with
// float32 FMAs and own the row's accumulator split over the head dim;
// K/V tiles go through shared memory.
//
// Neither is built with --use_fast_math, and bf16 is converted only with
// the intrinsics. The SIMT kernel uses the accurate expf, tanhf and
// division; the tensor-core kernel exp2f and the fast division where
// stated above, and the accurate division for the final 1 / l.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// SIMT kernel (float32)
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBQ = 16;            // query rows per block (8 threads each)
constexpr int kBK = 64;            // keys per KV tile (8 per thread)
constexpr int kMaxD = 256;         // largest head dim (accumulator size)
constexpr float kNegInf = -2.0e38f;

// shared memory of one block: the scaled Q tile and P rows, float32 with
// one padding word per row, then the K tile (one padding word per row)
// and the V tile
size_t shared_bytes(int d, int dv) {
  return sizeof(float) * (kBQ * (d + 1) + kBQ * (kBK + 1) + kBK * (d + 1)
                          + kBK * dv);
}

__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       float* __restrict__ out, float* __restrict__ lse,
                       const int* __restrict__ prefix, int Sq, int Sk,
                       int q_off, int Hq, int Hkv, int D, int Dv,
                       float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  float* qs = smem;                                   // kBQ x (D + 1)
  float* ps = qs + kBQ * (D + 1);                     // kBQ x (kBK + 1)
  float* ks = ps + kBQ * (kBK + 1);                   // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);                     // kBK x Dv
  const int kst = D + 1;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 3;          // this thread's query row in the tile
  const int cg = tid & 7;          // its key / head-dim lane in the row
  const int qrow_i = q0 + r;       // the row in q, and its position:
  const int qpos = q_off + qrow_i;
  const int pre = prefix != nullptr ? prefix[b] : 0;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, dd = i - rr * D, s = q0 + rr;
    qs[rr * (D + 1) + dd] =
        s < Sq ? q[((long long)(b * Sq + s) * Hq + h) * D + dd] * scale
               : 0.0f;
  }

  // keys [lo, hi) can be visible from some row of this tile
  int lo = 0, hi = Sk;
  if (window > 0) lo = max(0, q_off + q0 - window + 1);
  if (causal) hi = min(Sk, max(pre, q_off + q0 + kBQ));
  const int first_tile = (lo / kBK) * kBK;

  float m = kNegInf, l = 0.0f;
  float acc[kMaxD / 8];
#pragma unroll
  for (int i = 0; i < kMaxD / 8; ++i) acc[i] = 0.0f;

  for (int kv0 = first_tile; kv0 < hi; kv0 += kBK) {
    __syncthreads();               // the previous tile is no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, dd = i - c * D, t = kv0 + c;
      ks[c * kst + dd] =
          t < Sk ? k[((long long)(b * Sk + t) * Hkv + hk) * D + dd]
                 : 0.0f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int c = i / Dv, dd = i - c * Dv, t = kv0 + c;
      vs[c * Dv + dd] =
          t < Sk ? v[((long long)(b * Sk + t) * Hkv + hk) * Dv + dd]
                 : 0.0f;
    }
    __syncthreads();

    float sc[kBK / 8];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) sc[j] = 0.0f;
    const float* qrow = qs + r * (D + 1);
    for (int dd = 0; dd < D; ++dd) {
      const float qv = qrow[dd];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        sc[j] = fmaf(qv, ks[(cg + 8 * j) * kst + dd], sc[j]);
    }

    float tile_max = kNegInf;
    bool ok[kBK / 8];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const int t = kv0 + cg + 8 * j;
      float s = sc[j];
      if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
      ok[j] = t < Sk && (!causal || t <= qpos || t < pre) &&
              (window <= 0 || qpos - t < window);
      sc[j] = ok[j] ? s : kNegInf;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 4));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);

    float tile_sum = 0.0f;
    float* prow = ps + r * (kBK + 1);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float p = ok[j] ? expf(sc[j] - m_new) : 0.0f;
      prow[cg + 8 * j] = p;
      tile_sum += p;
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 4);
    l = l * corr + tile_sum;
    m = m_new;
    __syncwarp();                  // the row's p, written by its 8 lanes

#pragma unroll
    for (int i = 0; i < kMaxD / 8; ++i) acc[i] *= corr;
    for (int c = 0; c < kBK; ++c) {
      const float p = prow[c];
      const float* vrow = vs + c * Dv;
#pragma unroll
      for (int i = 0; i < kMaxD / 8; ++i) {
        const int dd = cg + 8 * i;
        if (dd < Dv) acc[i] = fmaf(p, vrow[dd], acc[i]);
      }
    }
  }

  if (qrow_i < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = out + ((long long)(b * Sq + qrow_i) * Hq + h) * Dv;
#pragma unroll
    for (int i = 0; i < kMaxD / 8; ++i) {
      const int dd = cg + 8 * i;
      if (dd < Dv) orow[dd] = acc[i] / denom;
    }
    if (lse != nullptr && cg == 0)
      lse[((long long)b * Hq + h) * Sq + qrow_i] = m + logf(denom);
  }
}

int launch_simt(const void* q, const void* k, const void* v, void* out,
                float* lse, const int* prefix, int B, int Sq, int Sk,
                int q_off, int Hq, int Hkv, int D, int Dv, float scale,
                int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = shared_bytes(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, prefix,
      Sq, Sk, q_off, Hq, Hkv, D, Dv, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// Tensor-core kernel (bfloat16)
// ---------------------------------------------------------------------------

constexpr int kBM = 128;            // query rows per block (64 per consumer)
constexpr int kBN = 64;             // keys per KV tile
constexpr int kStages = 2;          // K/V ring depth
constexpr int kTcThreads = 384;     // producer warpgroup + 2 consumer groups
constexpr int kBox = 64;            // bf16 columns per 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 8 * kRowBytes;   // 8 swizzled rows

// Shared memory of one block: every tile 1024-byte aligned (the swizzle
// atom), the mbarriers after them, 1024 bytes of slack to align the base.
template <int kHD> struct TcLayout {
  static constexpr int kBoxes = kHD / kBox;
  static constexpr int kQBytes = kBoxes * kBM * kRowBytes;    // Q tile
  static constexpr int kKVBytes = kBoxes * kBN * kRowBytes;   // a K or V tile
  static constexpr int kPBytes = (kBM / 2) * kBN * 2;         // 64 x 64 bf16
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kP = kV + kStages * kKVBytes;   // hi, lo per consumer
  static constexpr int kBar = kP + 4 * kPBytes;
  static constexpr int kBars = 1 + 3 * kStages;   // Q, K full, V full, empty
  static constexpr int kBytes = kBar + 8 * kBars + 1024;
  static_assert(kBN * 2 == kRowBytes, "a P row is one swizzled row");
  static_assert(kBytes <= 232448, "more shared memory than a block may use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products that own them.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(first, second);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 64, float32) (+)= A (64 x 16) * B (16 x 64), both read from
// 128-byte swizzled tiles in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, float32) (+)= A (64 x 16) * B (16 x 64), both read from
// 128-byte swizzled tiles in shared memory: A K-major, B MN-major (the
// transpose bit is set)
__device__ __forceinline__ void wgmma_ss_tb_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, float32) (+)= A (64 x 16) * B (16 x 128), both read from
// 128-byte swizzled tiles in shared memory: A K-major, B MN-major (the
// transpose bit is set)
__device__ __forceinline__ void wgmma_ss_tb_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 256, float32) (+)= A (64 x 16) * B (16 x 256), both read from
// 128-byte swizzled tiles in shared memory: A K-major, B MN-major (the
// transpose bit is set)
__device__ __forceinline__ void wgmma_ss_tb_n256(float (&d)[128], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}


__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Generic-proxy stores to shared memory made visible to the tensor cores'
// async proxy, then a barrier over the 128 threads of one warpgroup.
__device__ __forceinline__ void warpgroup_publish(int id) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <int kHD>
__device__ __forceinline__ void wgmma_pv(float (&o)[kHD / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (kHD == 64) wgmma_ss_tb_n64(o, da, db, 1);
  else if constexpr (kHD == 128) wgmma_ss_tb_n128(o, da, db, 1);
  else wgmma_ss_tb_n256(o, da, db, 1);
}

constexpr float kLog2e = 1.4426950408889634f;

// kPrefix / kLse: the prefix-LM mask and the lse output, compiled in only
// when asked for: read at run time in every launch, they made the kernel
// 12-27 % slower at the serving shapes on the H100
template <int kHD, bool kPrefix, bool kLse>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse,
                          const int* __restrict__ prefix, int B, int Sq,
                          int Sk, int q_off, int Hq, int Hkv, int Dv,
                          float scale, int causal, int window, float softcap,
                          int n_qtiles) {
  using L = TcLayout<kHD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ;
  const uint32_t bar_q = base + L::kBar;
  auto sk = [&](int s) { return base + L::kK + s * L::kKVBytes; };
  auto sv = [&](int s) { return base + L::kV + s * L::kKVBytes; };
  auto full_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + 2 * kStages + s); };

  // the longest causal query tiles first, over every (head, batch)
  const int hb = Hq * B;
  const int blk = static_cast<int>(blockIdx.x);
  const int q0 = (n_qtiles - 1 - blk / hb) * kBM;
  const int h = blk % hb % Hq;
  const int b = blk % hb / Hq;
  const int hk = h / (Hq / Hkv);
  const int pre = kPrefix ? prefix[b] : 0;

  // KV tiles [first, first + n_tiles) hold every key some row can see;
  // the tile's rows q0 .. sit at positions p0 = q_off + q0 ..
  const int p0 = q_off + q0;
  int lo = 0, hi = Sk;
  if (window > 0) lo = max(0, p0 - window + 1);
  if (causal) hi = min(Sk, kPrefix ? max(pre, p0 + kBM) : p0 + kBM);
  const int first = lo / kBN;
  const int n_tiles = (hi - 1) / kBN - first + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ---------------------------------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_4d(sq + c * kBM * kRowBytes, &tm_q, bar_q, c * kBox, h, q0,
                    b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const int kv0 = (first + it) * kBN;
        mbar_expect_tx(full_k(s), L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_4d(sk(s) + c * kBN * kRowBytes, &tm_k, full_k(s),
                      c * kBox, hk, kv0, b);
        mbar_expect_tx(full_v(s), L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_4d(sv(s) + c * kBN * kRowBytes, &tm_v, full_v(s),
                      c * kBox, hk, kv0, b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----------------------------------------
  setmaxnreg_inc<240>();
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int r_first = q0 + cw * 64;             // this warpgroup's rows
  const int row0 = r_first + (t / 32) * 16 + (t % 32) / 4;   // and + 8
  const int pr_first = q_off + r_first;         // and their positions
  const int prow0 = q_off + row0;
  const int col = 2 * (t % 4);                  // + 8 j + {0, 1}
  const uint32_t sq_wg = sq + cw * 64 * kRowBytes;
  const uint32_t sp_hi = base + L::kP + cw * 2 * L::kPBytes;
  const uint32_t sp_lo = sp_hi + L::kPBytes;
  // this thread's P elements in the swizzled tile: row r, 16-byte chunk j
  // of the row at (j ^ (r % 8)), and r % 8 is the same for both rows
  const uint32_t p_row = ((t / 32) * 16 + (t % 32) / 4) * kRowBytes
                         + (t % 4) * 4;
  const int p_xor = (t % 32) / 4;

  // the warpgroup's own tiles [it_lo, it_hi]; outside them every key of
  // the tile is masked for its 64 rows, and it only keeps the ring going
  int it_lo = 0, it_hi = n_tiles - 1;
  if (window > 0)
    it_lo = max(it_lo, max(0, pr_first - window + 1) / kBN - first);
  if (causal)
    it_hi = min(it_hi, (min(Sk, kPrefix ? max(pre, pr_first + 64)
                                        : pr_first + 64) - 1) / kBN - first);

  // scores in log2 units: s2 = log2(e) * s
  const bool capped = softcap > 0.0f;
  const float s2_scale = scale * kLog2e;
  const float cap_e = 2.0f * kLog2e * scale / softcap;   // exp(2 s / cap)
  const float cap2 = softcap * kLog2e;

  float o[kHD / 2];
#pragma unroll
  for (int i = 0; i < kHD / 2; ++i) o[i] = 0.0f;
  float sc[32];
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float corr[2] = {1.0f, 1.0f};

  auto qk = [&](int it) {       // S = Q K^T of tile it, issued
    const int s = it % kStages;
    mbar_wait(full_k(s), (it / kStages) & 1);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kHD / 16; ++k) {
      const int c = k / 4, kk = k % 4;
      wgmma_ss_n64(sc,
                   smem_desc(sq_wg + c * kBM * kRowBytes + kk * 32, 16,
                             kAtomBytes),
                   smem_desc(sk(s) + c * kBN * kRowBytes + kk * 32, 16,
                             kAtomBytes),
                   k > 0);
    }
    wgmma_commit();
  };

  // scale, softcap, mask; p = 2^(s2 - running max) into sc, its unrounded
  // sum into l, and the factor the accumulator takes into corr
  auto softmax = [&](int it) {
    const int kv0 = (first + it) * kBN;
    // a tile wholly inside the prefix needs no causal mask
    const bool need_mask =
        kv0 + kBN > Sk
        || (causal && kv0 + kBN - 1 > pr_first
            && (!kPrefix || kv0 + kBN > pre))
        || (window > 0 && pr_first + 63 - kv0 >= window);
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      // cap tanh(s / cap) = cap - 2 cap / (exp(2 s / cap) + 1)
      float x = capped
          ? cap2 - __fdividef(2.0f * cap2, exp2f(sc[i] * cap_e) + 1.0f)
          : sc[i] * s2_scale;
      if (need_mask) {
        const int key = kv0 + 8 * (i >> 2) + col + (i & 1);
        const int row = prow0 + 8 * hf;
        const bool ok = key < Sk
                        && (!causal || key <= row || (kPrefix && key < pre))
                        && (window <= 0 || row - key < window);
        if (!ok) x = -INFINITY;
      }
      sc[i] = x;
      mx[hf] = fmaxf(mx[hf], x);
    }
    float base_m[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      // a row with nothing visible yet keeps p = 0 and corr = 0
      base_m[hf] = mx[hf] == -INFINITY ? 0.0f : mx[hf];
      corr[hf] = exp2f(m2[hf] - base_m[hf]);
      m2[hf] = mx[hf];
      l[hf] *= corr[hf];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      sc[i] = exp2f(sc[i] - base_m[hf]);
      l[hf] += sc[i];
    }
  };

  // the accumulator rescaled, and P as bf16 hi + lo into the warpgroup's
  // two swizzled 64 x 64 tiles (the A operand of the PV products)
  auto rescale_store_p = [&]() {
#pragma unroll
    for (int i = 0; i < kHD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * j + 2 * hf;
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(sc[i], sc[i + 1]);
        const float2 back = __bfloat1622float2(h2);
        const uint32_t at = p_row + hf * 8 * kRowBytes + ((j ^ p_xor) << 4);
        st_shared(sp_hi + at, *reinterpret_cast<const uint32_t*>(&h2));
        st_shared(sp_lo + at, pack_bf16(sc[i] - back.x, sc[i + 1] - back.y));
      }
    }
    warpgroup_publish(1 + cw);
  };

  auto pv = [&](int it) {       // O += P_hi V + P_lo V of tile it, issued
    const int s = it % kStages;
    mbar_wait(full_v(s), (it / kStages) & 1);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = smem_desc(sv(s) + kk * 16 * kRowBytes,
                                    kBN * kRowBytes, kAtomBytes);
      wgmma_pv<kHD>(o, smem_desc(sp_hi + kk * 32, 16, kAtomBytes), dv);
      wgmma_pv<kHD>(o, smem_desc(sp_lo + kk * 32, 16, kAtomBytes), dv);
    }
    wgmma_commit();
  };

  auto pass = [&](int it) {     // a tile outside the warpgroup's own
    const int s = it % kStages;
    mbar_wait(full_k(s), (it / kStages) & 1);
    mbar_wait(full_v(s), (it / kStages) & 1);
    mbar_arrive(empty(s));
  };

  mbar_wait(bar_q, 0);
  for (int it = 0; it < min(it_lo, n_tiles); ++it) pass(it);
  if (it_lo <= it_hi) {
    qk(it_lo);
    wgmma_wait_all();
    fence_regs(sc);
    softmax(it_lo);
    rescale_store_p();
    for (int it = it_lo; it <= it_hi; ++it) {
      // the next tile's QK^T and this tile's PV back to back on the tensor
      // cores. (Waiting for the QK^T alone, to run its softmax beside the
      // PV, makes ptxas serialize the products: slower on the H100.)
      if (it < it_hi) qk(it + 1);
      pv(it);
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(o);
      mbar_arrive(empty(it % kStages));
      if (it < it_hi) {
        softmax(it + 1);
        rescale_store_p();
      }
    }
  }
  for (int it = max(it_hi + 1, it_lo); it < n_tiles; ++it) pass(it);

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const int row = row0 + 8 * hf;
    if (row < Sq) {
      const float inv = 1.0f / fmaxf(l[hf], 1e-30f);
      // m2 and l are in log2 units: lse = ln 2 (m2 + log2 l)
      if (kLse && t % 4 == 0)
        lse[(static_cast<long long>(b) * Hq + h) * Sq + row] =
            0.6931471805599453f * (m2[hf] + log2f(fmaxf(l[hf], 1e-30f)));
      __nv_bfloat16* orow =
          out + ((static_cast<long long>(b) * Sq + row) * Hq + h) * Dv;
#pragma unroll
      for (int j = 0; j < kHD / 8; ++j) {
        const int c = 8 * j + col;
        if (c < Dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(o[4 * j + 2 * hf] * inv,
                                    o[4 * j + 2 * hf + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled, fetched through the CUDA runtime's entry-point
// query so that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, H, d) bf16 as a 4-D map (d, H, S, B) with boxes of 64 columns x
// one head x `rows` positions, 128-byte swizzled; out-of-bounds reads as 0.
cudaError_t encode(CUtensorMap* map, const void* ptr, int B, int S, int H,
                   int d, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * d, 2ull * d * H, 2ull * d * H * S};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kHD, bool kPrefix, bool kLse>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, const int* prefix, int B, int Sq, int Sk,
              int q_off, int Hq, int Hkv, int D, int Dv, float scale,
              int causal, int window, float softcap, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode(&tq, q, B, Sq, Hq, D, kBM);
  if (err == cudaSuccess) err = encode(&tk, k, B, Sk, Hkv, D, kBN);
  if (err == cudaSuccess) err = encode(&tv, v, B, Sk, Hkv, Dv, kBN);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = TcLayout<kHD>::kBytes;
  err = cudaFuncSetAttribute(flash_attention_tc_kernel<kHD, kPrefix, kLse>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (Sq + kBM - 1) / kBM;
  const long long blocks = static_cast<long long>(n_qtiles) * Hq * B;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_tc_kernel<kHD, kPrefix, kLse>
      <<<static_cast<unsigned>(blocks), kTcThreads, smem, stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, prefix, B, Sq,
          Sk, q_off, Hq, Hkv, Dv, scale, causal, window, softcap, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for the options asked for (a prefix only when causal)
template <int kHD>
int launch_tc_options(const void* q, const void* k, const void* v, void* out,
                      float* lse, const int* prefix, int B, int Sq, int Sk,
                      int q_off, int Hq, int Hkv, int D, int Dv, float scale,
                      int causal, int window, float softcap,
                      cudaStream_t stream) {
  const bool pre = prefix != nullptr && causal;
  if (pre && lse != nullptr)
    return launch_tc<kHD, true, true>(q, k, v, out, lse, prefix, B, Sq, Sk,
                                      q_off, Hq, Hkv, D, Dv, scale, causal,
                                      window, softcap, stream);
  if (pre)
    return launch_tc<kHD, true, false>(q, k, v, out, lse, prefix, B, Sq, Sk,
                                       q_off, Hq, Hkv, D, Dv, scale, causal,
                                       window, softcap, stream);
  if (lse != nullptr)
    return launch_tc<kHD, false, true>(q, k, v, out, lse, prefix, B, Sq, Sk,
                                       q_off, Hq, Hkv, D, Dv, scale, causal,
                                       window, softcap, stream);
  return launch_tc<kHD, false, false>(q, k, v, out, lse, prefix, B, Sq, Sk,
                                      q_off, Hq, Hkv, D, Dv, scale, causal,
                                      window, softcap, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Why the kernel of `dtype` (0 = float32, the SIMT kernel; 1 = bfloat16,
// the tensor-core kernel) cannot take head dims D, Dv and the tensors at
// q, k, v: 0 = it can; 1 = a head dim above kMaxD; 2 = bfloat16 with a
// head dim not a multiple of 8, or 3 = bfloat16 with a pointer not
// 16-byte aligned (the TMA tensor maps need 16-byte row strides and base
// addresses); 4 = an unknown dtype code.
extern "C" int flash_attention_fits(int D, int Dv, const void* q,
                                    const void* k, const void* v,
                                    int dtype) {
  if (dtype != 0 && dtype != 1) return 4;
  if (D > kMaxD || Dv > kMaxD) return 1;
  if (dtype == 0) return 0;
  if (D % 8 || Dv % 8) return 2;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v)) return 3;
  return 0;
}

extern "C" int flash_attention_max_head_dim() { return kMaxD; }

// dtype code as for flash_attention_fits, which the arguments must pass
// (the bfloat16 kernel also needs `out` 16-byte aligned). Sq query rows
// at positions q_off .. q_off + Sq - 1 against Sk keys (0 <= q_off,
// q_off + Sq <= Sk, else cudaErrorInvalidValue). window <= 0: no window;
// softcap <= 0: no softcap. lse: null, or float32 (B, Hq, Sq) to
// receive each row's log-sum-exp; prefix: null, or int32 (B,) prefix
// lengths of the prefix-LM mask (read only when causal). Launch on
// `stream`; returns the first CUDA error of the tensor maps, the
// attribute call or the launch (0 = ok). The caller has checked shapes
// (Hq a multiple of Hkv), types and contiguity, and that B, Sq and the
// heads are non-zero.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, float* lse, const int* prefix,
                               int B, int Sq, int Sk, int Hq, int Hkv,
                               int D, int Dv, int q_off, float scale,
                               int causal, int window, float softcap,
                               int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int why = flash_attention_fits(D, Dv, q, k, v, dtype);
  if (why == 3 || (dtype == 1 && !aligned16(out)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (why != 0 || q_off < 0 || q_off > Sk - Sq)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_simt(q, k, v, out, lse, prefix, B, Sq, Sk, q_off, Hq, Hkv,
                       D, Dv, scale, causal, window, softcap, s);
  const int hd = D > Dv ? D : Dv;
  if (hd <= 64)
    return launch_tc_options<64>(q, k, v, out, lse, prefix, B, Sq, Sk, q_off,
                                 Hq, Hkv, D, Dv, scale, causal, window,
                                 softcap, s);
  if (hd <= 128)
    return launch_tc_options<128>(q, k, v, out, lse, prefix, B, Sq, Sk,
                                  q_off, Hq, Hkv, D, Dv, scale, causal,
                                  window, softcap, s);
  return launch_tc_options<256>(q, k, v, out, lse, prefix, B, Sq, Sk, q_off,
                                Hq, Hkv, D, Dv, scale, causal, window,
                                softcap, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
