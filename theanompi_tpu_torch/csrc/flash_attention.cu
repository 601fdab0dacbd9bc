// Flash attention for Hopper (sm_90a): forward (B10), dK/dV (B11), dQ (B12).
//
// Replaces the three pallas_calls of JAX's packaged TPU kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0), which
// theanompi_tpu/models/layers.py:459-464 (MultiHeadAttention._attend,
// attn_impl='flash') calls:
//
//   B10  _flash_attention_impl   :589, pallas_call :758   o, and the row stats
//   B11  _flash_attention_bwd_dkv :941, pallas_call :1121  dK, dV
//   B12  _flash_attention_bwd_dq :1287, pallas_call :1456  dQ
//
// Same math, on [B, H, T, D] bfloat16 tensors with f32 accumulation:
//
//   s   = (q k^T) * scale + mask        mask: 0, or -0.7 * FLT_MAX above the
//                                        diagonal (DEFAULT_MASK_VALUE :29)
//   B10 o = softmax(s) v, online over key tiles; p = exp(s - m) is rounded to
//       bf16 before the p v product, as the TPU kernel does (:470-471).  The
//       row stats are kept as lse = m + log l (f32 [B, H, T]): the TPU kernel
//       keeps l and m broadcast over 128 lanes, a TPU layout; one float per
//       row is enough to rebuild p.
//   B11 p = exp(s - lse); dV = sum_q p^T dO; dP = dO v^T;
//       dS = p * (dP - di) * scale; dK = sum_q dS^T q   (p, dS rounded to bf16
//       before their products, :900, :918)
//   B12 dQ = sum_k dS k                                 (:1257)
//
// di = rowsum(o * dO) is computed outside the kernels, as XLA does there
// (:273-275).  The dK/dV vs dQ split is the TPU kernel's own: each output
// tile is owned by one block and summed in a fixed order, so no atomics and
// no run-to-run variation.
//
// Bound.  At the LM's shapes ([16, 8, 512, 64] bf16, causal) B10 must move
// 33.8 MB (q, k, v read, o written, lse) and do 4.30 GFLOP over the causal
// pairs: 10.1 us at 3.35 TB/s against 4.4 us at 989 TFLOP/s bf16.  B11 moves
// 50.9 MB and does 8.61 GFLOP: 15.2 us against 8.7 us.  B12 moves 42.5 MB and
// does 6.46 GFLOP: 12.7 us against 6.5 us.  All three are byte-bound on
// paper, and close enough to the tensor-core line that a kernel which stalls
// its tensor cores on copies or on a shared-memory softmax lands far above
// both.
//
// Hopper design, all three kernels.  One CTA of 160 threads per (b*h,
// 64-row output tile): warps 0-3 are one consumer warpgroup that owns the
// tile's 64 rows (wgmma's M), warp 4 is the producer, one lane of which
// issues every copy.  64 rows and 64-key (or 64-query) tiles, because:
//   * one consumer warpgroup needs no cross-warpgroup ordering, no
//     setmaxnreg and no per-warpgroup causal skips; a 160-thread CTA may use
//     255 registers a thread, and B11 keeps two f32 sums (ptxas: B11 168
//     registers at hd 64, 227 at hd 128; B10 110 and 150; B12 122 and 154;
//     no spills);
//   * a CTA takes 26-133 KB of shared memory; at hd 64, 3 (B10, B12) or 2
//     (B11, by registers) CTAs share an SM, and one CTA's elementwise pass
//     overlaps another's products; at the LM's shape the grid is 1,024 CTAs
//     on 132 SMs;
//   * with T a multiple of 64 no tile is ragged, and the causal diagonal is
//     exactly one tile.
// Copies: the resident tiles (B10 q; B11 k and v; B12 q and dO, and their
// lse and di rows by bulk copy) are loaded once by TMA; the streamed tiles
// (B10 and B12 k, v; B11 q, dO, and their lse and di rows by bulk copy)
// come through a ring in shared memory (B10 and B12 3 stages, B11 2) with a
// full/empty mbarrier pair per stage, so the next tiles' copies run under
// the current tile's products.  The tensor maps are 4-D (hd, T, H, B) over
// each view's own byte strides, with 128-byte swizzle (hd 64 and 128; hd 128
// is two 64-column boxes) or 64-byte swizzle (hd 32), the layouts wgmma
// reads without bank conflicts.  Tensor cores: every product is
// wgmma.mma_async m64nNk16.  The score products (B10 s = q k^T; B11
// s^T = k q^T and dP^T = v dO^T; B12 s = q k^T and dP = dO v^T) take both
// operands from shared memory, K-major.  The softmax (B10) or the p and dS
// pass (B11, B12) runs on the f32 accumulator registers: a thread holds
// parts of two rows, so a row max or sum is two quad shuffles; the causal
// mask is added on the diagonal tile only, from each element's known (row,
// column); tiles above the diagonal are skipped.  B10 rescales its o
// accumulator in registers by exp(m_old - m_new).  p (B10), p^T and dS^T
// (B11) or dS (B12) are rounded to bf16 in registers and fed straight back
// as wgmma's register A operand (the m64nN f32 accumulator layout is the
// k16 A-fragment layout, pairwise), against v, dO, q or k from shared
// memory as an MN-major B operand: no score, p or dS ever goes through
// shared memory.  B10 is software-pipelined: s_j = q k_j^T and
// o += p_{j-1} v_{j-1} are issued together, and the softmax of s_j runs
// while the second product is on the tensor cores.  B11 and B12 are not.
// B11: holding the next tile's s^T and dP^T beside p^T, dS^T, dK and dV
// takes more registers than a thread has at hd 128 (it spills), and
// splitting a tile's products over more waits ran slower on an H100, so it
// issues its four products in two batches per tile.  B12: B10's pipeline
// (s_j and dP_j issued with dQ += dS_{j-1} k_{j-1}, the dS pass under the
// second) fits (ptxas: 177 registers at hd 128, no spills) but was no
// faster on an H100 (700 W) at the LM's shape: chip_smoke.py read 0.0282
// ms for it and 0.0278-0.0282 across runs for the serial loop, a tie, so
// B12 keeps the simpler two batches a tile (s and dP, then dS k).  Epilogue: the f32 sums are converted to
// bf16 into the (now free) resident tile's swizzled shared memory and
// written by one TMA store through the output's strides; B10's lse is
// written per row.  B10 and B12 start the longest rows first.
//
// Inputs may be strided views (the model hands q, k, v as the transpose of a
// [B, T, H, D] product): each tensor comes with its B, H and T strides in
// elements; the last dim is contiguous and every stride a multiple of 8 (the
// wrapper checks), which gives TMA its 16-byte alignment.  Outputs are
// written through their strides the same way.  Head dims 32, 64 and 128; T a
// multiple of 64.  Each C entry encodes its tensor maps (cuTensorMapEncodeTiled,
// found through cudaGetDriverEntryPoint, so no link against libcuda), launches
// on the caller's stream, allocates nothing, and returns the CUDA error of
// the launch (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                  // rows of a q or k/v tile
constexpr float kMask = -0.7f * 3.402823466e38f;   // DEFAULT_MASK_VALUE
constexpr unsigned kFull = 0xffffffffu;

struct Strided {                           // element strides of [B, H, T, D]
  long long b, h, t;
};

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

// depth of the streamed-tile rings: B10's pipelined loop holds two stages
// while a third is loading; B12 takes B10's ring
constexpr int kFwdStages = 3;
constexpr int kBwdStages = 2;
constexpr int kDqStages = 3;
constexpr int kHopperThreads = 160;        // consumer warpgroup + producer warp
constexpr int kConsumers = 128;

// Shared-memory layout of a 64-row bf16 tile of head dim D, as TMA writes it
// with the swizzle wgmma reads: boxes of kCW columns (64, or 32 for D = 32),
// kRB bytes a row, 8-row swizzle atoms of kAtom bytes, one box after another.
template <int D>
struct Lay {
  static constexpr int kCW = D < 64 ? D : 64;
  static constexpr int kRB = 2 * kCW;
  static constexpr int kBoxes = D / kCW;
  static constexpr uint32_t kBoxBytes = kTile * kRB;
  static constexpr uint32_t kTileBytes = kTile * D * 2;
  static constexpr uint32_t kAtom = 8 * kRB;
  static constexpr uint64_t kDescType = kRB == 128 ? 1 : 2;   // 128B / 64B
  static constexpr uint32_t kSwizzle = kRB == 128 ? 0x70 : 0x30;
  static constexpr CUtensorMapSwizzle kMapSwizzle =
      kRB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
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

// One box of a 4-D tensor map (hd, T, H, B) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int t, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(t), "r"(h),
      "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c, int t, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(t), "r"(h), "r"(b)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Every box of a 64-row tile at rows t.. of head (b, h).
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map,
                                              uint32_t bar, int t, int h, int b) {
#pragma unroll
  for (int x = 0; x < Lay<D>::kBoxes; ++x)
    tma_load(dst + x * Lay<D>::kBoxBytes, map, bar, x * Lay<D>::kCW, t, h, b);
}

// The f32 pairs of a 64 x D wgmma accumulator (rows r0 and r0 + 8 of the
// thread) as bf16 into a swizzled tile, then one TMA store of it.  Called by
// the 128 consumer threads; the first one issues the store and waits until
// shared memory has been read.
template <int D>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2], float f0,
                                           float f1, unsigned char* tile,
                                           const CUtensorMap* map, int t,
                                           int h, int b) {
  using L = Lay<D>;
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half, col = 8 * j + cq;
      const float f = half ? f1 : f0;
      const uint32_t off = (col / L::kCW) * L::kBoxBytes + r * L::kRB +
                           (col % L::kCW) * 2;
      *reinterpret_cast<__nv_bfloat162*>(
          tile + (off ^ ((off >> 3) & L::kSwizzle))) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * f,
                                acc[4 * j + 2 * half + 1] * f);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  if (tid == 0) {
#pragma unroll
    for (int x = 0; x < L::kBoxes; ++x)
      tma_store(map, smem_addr(tile) + x * L::kBoxBytes, x * L::kCW, t, h, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode.
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(Lay<D>::kAtom >> 4) << 32) |
         (Lay<D>::kDescType << 62);
}

// The tile [64 rows][D] as a K-major operand (D is the reduction), at k-step
// kk (columns 16kk..16kk+15): 32 bytes into a swizzled row.
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  using L = Lay<D>;
  return make_desc<D>(tile + (16 * kk / L::kCW) * L::kBoxBytes +
                          (16 * kk % L::kCW) * 2,
                      16);
}

// The tile [64 rows][D] as an MN-major B operand (the rows are the
// reduction, D is N), at k-step kk (rows 16kk..16kk+15: two swizzle atoms);
// the boxes of D follow each other kBoxBytes apart.
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  using L = Lay<D>;
  return make_desc<D>(tile + 16 * kk * L::kRB, L::kBoxBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N committed groups of wgmma are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64n64 f32 accumulator s (thread's n8 block j: s[4j], s[4j+1] in row
// r0, s[4j+2], s[4j+3] in row r0 + 8, columns 8j + 2(lane % 4) + {0, 1}) as
// four k16 A fragments of bf16 pairs: k-step kk takes blocks 2kk and 2kk+1.
__device__ __forceinline__ void to_a_frags(const float (&s)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// B10's online softmax over a 64 x 64 score tile s (the thread's rows r0 and
// r0 + 8; columns 8 jb + cq + {0, 1} of n8 block jb): scales s, adds the mask
// above the diagonal on the diagonal tile, moves the row maxima m on, leaves
// p = exp(s - m) in s, folds its sum into the thread's part of l, and returns
// the factors exp(m_old - m_new) that rescale the running output.
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               float scale, bool diag, int r0,
                                               int cq) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {               // i = 4 jb + 2 half + e
    const int half = (i >> 1) & 1;
    float x = s[i] * scale;
    if (diag && 8 * (i >> 2) + cq + (i & 1) > r0 + 8 * half) x += kMask;
    s[i] = x;
    mx[half] = fmaxf(mx[half], x);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {             // the row's 4 threads agree
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 2));
    alpha[hf] = __expf(m[hf] - mx[hf]);
    m[hf] = mx[hf];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int half = (i >> 1) & 1;
    s[i] = __expf(s[i] - m[half]);
    sum[half] += s[i];
  }
  l[0] = alpha[0] * l[0] + sum[0];
  l[1] = alpha[1] * l[1] + sum[1];
}

// d[32] (+)= A B, m64n64k16: A and B from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[16] += A B, m64n32k16: A (bf16 pairs) from registers, B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[32] += A B, m64n64k16: A (bf16 pairs) from registers, B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64] += A B, m64n128k16: A (bf16 pairs) from registers, B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B with N = D (the o, dK and dV sums): A from registers, B MN-major.
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t* a,
                                         uint64_t b) {
  if constexpr (D == 32) {
    wgmma_rs_n32(d, a, b);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(d, a, b);
  } else {
    wgmma_rs_n128(d, a, b);
  }
}

// The dynamic shared memory rounded up to 1024 bytes: the swizzle patterns
// that TMA writes and wgmma reads are those of the address bits.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

template <int D>
constexpr size_t fwd_smem() {
  // q (then o), kFwdStages x (k, v), the q barrier and a full/empty pair a
  // stage
  return 1024 + Lay<D>::kTileBytes * (1 + 2 * kFwdStages) +
         8 * (1 + 2 * kFwdStages);
}

// B10: o and lse of the 64 query rows of tile qi of head (b, h).
template <int D>
__global__ void __launch_bounds__(kHopperThreads)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o,
                     float* __restrict__ lse, int H, int T, float scale,
                     int causal) {
  using L = Lay<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sq = smem_addr(smem);                      // q, then o
  const uint32_t ring = sq + L::kTileBytes;                 // stage s: k, v
  const uint32_t bars = ring + kFwdStages * 2 * L::kTileBytes;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kFwdStages + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nt = T / kTile;
  const int qi = nt - 1 - blockIdx.y;          // the longest rows start first
  const int n_kv = causal ? qi + 1 : nt;       // key tiles above the diagonal skipped
  if (tid == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                     // the producer warp
    if (tid == kConsumers) {
      mbar_expect(bars, L::kTileBytes);
      tma_load_tile<D>(sq, &map_q, bars, qi * kTile, h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kFwdStages;
        if (j >= kFwdStages) mbar_wait(empty(s), (j / kFwdStages - 1) & 1);
        const uint32_t kt = ring + s * 2 * L::kTileBytes;
        mbar_expect(full(s), 2 * L::kTileBytes);
        tma_load_tile<D>(kt, &map_k, full(s), j * kTile, h, b);
        tma_load_tile<D>(kt + L::kTileBytes, &map_v, full(s), j * kTile, h, b);
      }
    }
    return;
  }

  // consumer warpgroup: the thread's rows r0 and r0 + 8 of the tile; its
  // columns of n8 block jb are 8 jb + cq + {0, 1}
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4, cq = 2 * (lane % 4);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};   // per row; l per thread

  // Software pipeline over the key tiles: while p_{j-1} v_{j-1} runs on the
  // tensor cores, the softmax of s_j = q k_j^T runs on the registers.
  auto kv = [&](int j) { return ring + (j % kFwdStages) * 2 * L::kTileBytes; };
  float sc[32], alpha[2];                      // s = q k^T, 64 x 64
  uint32_t pa[16];                             // p in bf16, wgmma's A
  mbar_wait(bars, 0);
  mbar_wait(full(0), 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(sc, desc_kmajor<D>(sq, kk), desc_kmajor<D>(kv(0), kk), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  online_softmax(sc, m, l, alpha, scale, causal && qi == 0, r0, cq);
  to_a_frags(sc, pa);
  for (int j = 1; j < n_kv; ++j) {
    mbar_wait(full(j % kFwdStages), (j / kFwdStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, desc_kmajor<D>(sq, kk), desc_kmajor<D>(kv(j), kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_rs<D>(o, pa + 4 * kk, desc_mnmajor<D>(kv(j - 1) + L::kTileBytes, kk));
    wgmma_commit();
    wgmma_wait<1>();                           // s_j is in
    fence_regs(sc);
    online_softmax(sc, m, l, alpha, scale, causal && j == qi, r0, cq);
    wgmma_wait<0>();                           // o += p_{j-1} v_{j-1} is in
    fence_regs(o);
    mbar_arrive(empty((j - 1) % kFwdStages));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    to_a_frags(sc, pa);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_rs<D>(o, pa + 4 * kk, desc_mnmajor<D>(kv(n_kv - 1) + L::kTileBytes, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(kFull, l[hf], 1);
    l[hf] += __shfl_xor_sync(kFull, l[hf], 2);
  }
  store_tile<D>(o, 1.f / l[0], 1.f / l[1], smem, &map_o, qi * kTile, h, b);
  if (lane % 4 == 0) {
    float* out = lse + static_cast<long long>(bh) * T + qi * kTile + r0;
    out[0] = m[0] + logf(l[0]);
    out[8] = m[1] + logf(l[1]);
  }
}

template <int D>
constexpr size_t bwd_dkv_smem() {
  // k, v, kBwdStages x (q, dO, lse and di rows), the k/v barrier and a
  // full/empty pair a stage
  return 1024 + Lay<D>::kTileBytes * (2 + 2 * kBwdStages) +
         kBwdStages * 2 * kTile * sizeof(float) + 8 * (1 + 2 * kBwdStages);
}

// B11: dK and dV of the 64 keys of tile kj of head (b, h).
template <int D>
__global__ void __launch_bounds__(kHopperThreads)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_dk,
                         const __grid_constant__ CUtensorMap map_dv,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, int H, int T,
                         float scale, int causal) {
  using L = Lay<D>;
  constexpr uint32_t kStatBytes = kTile * sizeof(float);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sk = smem_addr(smem);                      // k, then dK
  const uint32_t sv = sk + L::kTileBytes;                   // v, then dV
  const uint32_t ring = sv + L::kTileBytes;                 // stage s: q, dO
  const uint32_t stats = ring + kBwdStages * 2 * L::kTileBytes;  // s: lse, di
  const uint32_t bars = stats + kBwdStages * 2 * kStatBytes;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kBwdStages + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nt = T / kTile;
  const int kj = blockIdx.y;                   // key tile 0 has the most rows
  const int q_begin = causal ? kj : 0;         // query tiles before it skipped
  if (tid == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                     // the producer warp
    if (tid == kConsumers) {
      mbar_expect(bars, 2 * L::kTileBytes);
      tma_load_tile<D>(sk, &map_k, bars, kj * kTile, h, b);
      tma_load_tile<D>(sv, &map_v, bars, kj * kTile, h, b);
      for (int qi = q_begin, j = 0; qi < nt; ++qi, ++j) {
        const int s = j % kBwdStages;
        if (j >= kBwdStages) mbar_wait(empty(s), (j / kBwdStages - 1) & 1);
        const uint32_t qt = ring + s * 2 * L::kTileBytes;
        const uint32_t st = stats + s * 2 * kStatBytes;
        const long long row = static_cast<long long>(bh) * T + qi * kTile;
        mbar_expect(full(s), 2 * L::kTileBytes + 2 * kStatBytes);
        tma_load_tile<D>(qt, &map_q, full(s), qi * kTile, h, b);
        tma_load_tile<D>(qt + L::kTileBytes, &map_do, full(s), qi * kTile, h, b);
        bulk_load(st, lse + row, kStatBytes, full(s));
        bulk_load(st + kStatBytes, di + row, kStatBytes, full(s));
      }
    }
    return;
  }

  // consumer warpgroup: the thread's keys r0 and r0 + 8 of the tile; its
  // queries of n8 block jb are 8 jb + cq + {0, 1}
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4, cq = 2 * (lane % 4);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bars, 0);
  for (int qi = q_begin, j = 0; qi < nt; ++qi, ++j) {
    const int s = j % kBwdStages;
    const uint32_t qt = ring + s * 2 * L::kTileBytes, dot = qt + L::kTileBytes;
    const float* ls = reinterpret_cast<const float*>(
        smem + (stats - sk) + s * 2 * kStatBytes);
    const float* dis = ls + kTile;
    mbar_wait(full(s), (j / kBwdStages) & 1);
    float st[32], dp[32];                      // s^T = k q^T, dP^T = v dO^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, desc_kmajor<D>(sk, kk), desc_kmajor<D>(qt, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor<D>(sv, kk), desc_kmajor<D>(dot, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dp);

    const bool diag = causal && qi == kj;
#pragma unroll
    for (int i = 0; i < 32; ++i) {             // i = 4 jb + 2 half + e
      const int key = r0 + 8 * ((i >> 1) & 1);
      const int c = 8 * (i >> 2) + cq + (i & 1);   // the query
      float x = st[i] * scale;
      if (diag && key > c) x += kMask;
      const float p = __expf(x - ls[c]);
      st[i] = p;
      dp[i] = p * (dp[i] - dis[c]) * scale;
    }
    uint32_t pa[16], da[16];                   // p^T and dS^T in bf16
    to_a_frags(st, pa);
    to_a_frags(dp, da);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_rs<D>(dv, pa + 4 * kk, desc_mnmajor<D>(dot, kk));
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_rs<D>(dk, da + 4 * kk, desc_mnmajor<D>(qt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(empty(s));
  }
  store_tile<D>(dk, 1.f, 1.f, smem, &map_dk, kj * kTile, h, b);
  store_tile<D>(dv, 1.f, 1.f, smem + L::kTileBytes, &map_dv, kj * kTile, h, b);
}

template <int D>
constexpr size_t bwd_dq_smem() {
  // q (then dQ), dO, kDqStages x (k, v), the lse and di rows, the q/dO
  // barrier and a full/empty pair a stage
  return 1024 + Lay<D>::kTileBytes * (2 + 2 * kDqStages) +
         2 * kTile * sizeof(float) + 8 * (1 + 2 * kDqStages);
}

// B12's s = q k^T and dP = dO v^T of the key tile at kt (k, then v): both
// operands K-major along hd.
template <int D>
__device__ __forceinline__ void dq_scores(float (&sc)[32], float (&dp)[32],
                                          uint32_t sq, uint32_t sdo,
                                          uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(sc, desc_kmajor<D>(sq, kk), desc_kmajor<D>(kt, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(dp, desc_kmajor<D>(sdo, kk),
                 desc_kmajor<D>(kt + Lay<D>::kTileBytes, kk), kk);
}

// B12's elementwise pass on the accumulators (the thread's rows r0 and
// r0 + 8, with their lse and di; keys 8 jb + cq + {0, 1} of n8 block jb):
// p = exp(s scale + mask - lse), the mask on the diagonal tile only, and
// dS = p (dP - di) scale, left in dp.
__device__ __forceinline__ void dq_ds(const float (&sc)[32], float (&dp)[32],
                                      const float (&ls)[2],
                                      const float (&ds)[2], float scale,
                                      bool diag, int r0, int cq) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {               // i = 4 jb + 2 half + e
    const int half = (i >> 1) & 1;
    float x = sc[i] * scale;
    if (diag && 8 * (i >> 2) + cq + (i & 1) > r0 + 8 * half) x += kMask;
    const float p = __expf(x - ls[half]);
    dp[i] = p * (dp[i] - ds[half]) * scale;
  }
}

// dQ += dS k: dS (bf16 pairs) from registers, the k tile at kt as the
// MN-major B operand; B10's p v with k for v.
template <int D>
__device__ __forceinline__ void dq_product(float (&dq)[D / 2],
                                           const uint32_t (&da)[16],
                                           uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_rs<D>(dq, da + 4 * kk, desc_mnmajor<D>(kt, kk));
}

// B12: dQ of the 64 query rows of tile qi of head (b, h).
template <int D>
__global__ void __launch_bounds__(kHopperThreads)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_dq,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, int H, int T,
                        float scale, int causal) {
  using L = Lay<D>;
  constexpr uint32_t kStatBytes = kTile * sizeof(float);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sq = smem_addr(smem);                      // q, then dQ
  const uint32_t sdo = sq + L::kTileBytes;                  // dO
  const uint32_t ring = sdo + L::kTileBytes;                // stage s: k, v
  const uint32_t stats = ring + kDqStages * 2 * L::kTileBytes;   // lse, di
  const uint32_t bars = stats + 2 * kStatBytes;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kDqStages + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nt = T / kTile;
  const int qi = nt - 1 - blockIdx.y;          // the longest rows start first
  const int n_kv = causal ? qi + 1 : nt;       // key tiles above the diagonal skipped
  if (tid == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                     // the producer warp
    if (tid == kConsumers) {
      const long long row = static_cast<long long>(bh) * T + qi * kTile;
      mbar_expect(bars, 2 * L::kTileBytes + 2 * kStatBytes);
      tma_load_tile<D>(sq, &map_q, bars, qi * kTile, h, b);
      tma_load_tile<D>(sdo, &map_do, bars, qi * kTile, h, b);
      bulk_load(stats, lse + row, kStatBytes, bars);
      bulk_load(stats + kStatBytes, di + row, kStatBytes, bars);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kDqStages;
        if (j >= kDqStages) mbar_wait(empty(s), (j / kDqStages - 1) & 1);
        const uint32_t kt = ring + s * 2 * L::kTileBytes;
        mbar_expect(full(s), 2 * L::kTileBytes);
        tma_load_tile<D>(kt, &map_k, full(s), j * kTile, h, b);
        tma_load_tile<D>(kt + L::kTileBytes, &map_v, full(s), j * kTile, h, b);
      }
    }
    return;
  }

  // consumer warpgroup: the thread's rows r0 and r0 + 8 of the tile; its
  // keys of n8 block jb are 8 jb + cq + {0, 1}
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4, cq = 2 * (lane % 4);
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(bars, 0);
  const float* st = reinterpret_cast<const float*>(smem + (stats - sq));
  const float ls[2] = {st[r0], st[r0 + 8]};                   // the rows' lse
  const float ds[2] = {st[kTile + r0], st[kTile + r0 + 8]};   // and di

  auto kv = [&](int j) { return ring + (j % kDqStages) * 2 * L::kTileBytes; };
  float sc[32], dp[32];                        // s = q k^T, dP = dO v^T
  uint32_t da[16];                             // dS in bf16, wgmma's A
  for (int j = 0; j < n_kv; ++j) {
    mbar_wait(full(j % kDqStages), (j / kDqStages) & 1);
    wgmma_fence();
    dq_scores<D>(sc, dp, sq, sdo, kv(j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    dq_ds(sc, dp, ls, ds, scale, causal && j == qi, r0, cq);
    to_a_frags(dp, da);
    fence_regs(dq);
    wgmma_fence();
    dq_product<D>(dq, da, kv(j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(empty(j % kDqStages));
  }
  store_tile<D>(dq, 1.f, 1.f, smem, &map_dq, qi * kTile, h, b);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

Strided strided(const long long* s, int i) {
  return Strided{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The 4-D map (hd, T, H, B) of a bf16 tensor of element strides st, in
// boxes of Lay<D>::kCW columns x 64 rows with the swizzle wgmma reads.
// Rows past T would be zero-filled on load and clipped on store.
template <int D>
int make_map(CUtensorMap* map, const void* ptr, Strided st, int B, int H,
             int T) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.t) * sizeof(bf16),
                                 static_cast<cuuint64_t>(st.h) * sizeof(bf16),
                                 static_cast<cuuint64_t>(st.b) * sizeof(bf16)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Lay<D>::kCW),
                             static_cast<cuuint32_t>(kTile), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, Lay<D>::kMapSwizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const long long* s, int B, int H, int T,
               float scale, int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  if (int e = make_map<D>(&mq, q, strided(s, 0), B, H, T)) return e;
  if (int e = make_map<D>(&mk, k, strided(s, 1), B, H, T)) return e;
  if (int e = make_map<D>(&mv, v, strided(s, 2), B, H, T)) return e;
  if (int e = make_map<D>(&mo, o, strided(s, 3), B, H, T)) return e;
  constexpr size_t smem = fwd_smem<D>();
  if (int e = prepare(flash_fwd_kernel<D>, smem)) return e;
  const dim3 grid(B * H, T / kTile);
  flash_fwd_kernel<D><<<grid, kHopperThreads, smem, stream>>>(
      mq, mk, mv, mo, static_cast<float*>(lse), H, T, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, void* dk, void* dv,
               const long long* s, int B, int H, int T, float scale,
               int causal, cudaStream_t stream) {
  // the stat rows come in by bulk copy: 16-byte aligned
  if ((reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(di)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (int e = make_map<D>(&mq, q, strided(s, 0), B, H, T)) return e;
  if (int e = make_map<D>(&mk, k, strided(s, 1), B, H, T)) return e;
  if (int e = make_map<D>(&mv, v, strided(s, 2), B, H, T)) return e;
  if (int e = make_map<D>(&mdo, dout, strided(s, 3), B, H, T)) return e;
  if (int e = make_map<D>(&mdk, dk, strided(s, 4), B, H, T)) return e;
  if (int e = make_map<D>(&mdv, dv, strided(s, 5), B, H, T)) return e;
  constexpr size_t smem = bwd_dkv_smem<D>();
  if (int e = prepare(flash_bwd_dkv_kernel<D>, smem)) return e;
  const dim3 grid(B * H, T / kTile);
  flash_bwd_dkv_kernel<D><<<grid, kHopperThreads, smem, stream>>>(
      mq, mk, mv, mdo, mdk, mdv, static_cast<const float*>(lse),
      static_cast<const float*>(di), H, T, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, void* dq, const long long* s,
              int B, int H, int T, float scale, int causal,
              cudaStream_t stream) {
  // the stat rows come in by bulk copy: 16-byte aligned
  if ((reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(di)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (int e = make_map<D>(&mq, q, strided(s, 0), B, H, T)) return e;
  if (int e = make_map<D>(&mk, k, strided(s, 1), B, H, T)) return e;
  if (int e = make_map<D>(&mv, v, strided(s, 2), B, H, T)) return e;
  if (int e = make_map<D>(&mdo, dout, strided(s, 3), B, H, T)) return e;
  if (int e = make_map<D>(&mdq, dq, strided(s, 4), B, H, T)) return e;
  constexpr size_t smem = bwd_dq_smem<D>();
  if (int e = prepare(flash_bwd_dq_kernel<D>, smem)) return e;
  const dim3 grid(B * H, T / kTile);
  flash_bwd_dq_kernel<D><<<grid, kHopperThreads, smem, stream>>>(
      mq, mk, mv, mdo, mdq, static_cast<const float*>(lse),
      static_cast<const float*>(di), H, T, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: B, H, T element strides of q, k, v, o (12 values).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, const long long* strides, int B, int H,
                         int T, int D, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || T == 0) return 0;
  switch (D) {
    case 32: return launch_fwd<32>(q, k, v, o, lse, strides, B, H, T, scale, causal, st);
    case 64: return launch_fwd<64>(q, k, v, o, lse, strides, B, H, T, scale, causal, st);
    case 128: return launch_fwd<128>(q, k, v, o, lse, strides, B, H, T, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: q, k, v, dO, dK, dV (18 values).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* di, void* dk, void* dv,
                             const long long* strides, int B, int H, int T,
                             int D, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || T == 0) return 0;
  switch (D) {
    case 32: return launch_dkv<32>(q, k, v, dout, lse, di, dk, dv, strides, B, H, T, scale, causal, st);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, di, dk, dv, strides, B, H, T, scale, causal, st);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, di, dk, dv, strides, B, H, T, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: q, k, v, dO, dQ (15 values).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* di,
                            void* dq, const long long* strides, int B, int H,
                            int T, int D, float scale, int causal,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || T == 0) return 0;
  switch (D) {
    case 32: return launch_dq<32>(q, k, v, dout, lse, di, dq, strides, B, H, T, scale, causal, st);
    case 64: return launch_dq<64>(q, k, v, dout, lse, di, dq, strides, B, H, T, scale, causal, st);
    case 128: return launch_dq<128>(q, k, v, dout, lse, di, dq, strides, B, H, T, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
