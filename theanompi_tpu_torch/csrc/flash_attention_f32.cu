// Flash attention in float32 for Hopper (sm_90a): forward (B10), dK/dV (B11),
// dQ (B12), the float32 instantiation of csrc/flash_attention.cu.
//
// Replaces the same three pallas_calls of JAX's packaged TPU kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0) as the
// bf16 kernels, for the case the JAX package also runs: q, k and v handed
// over in float32 (theanompi_tpu/models/layers.py:457-467 passes them in
// compute_dtype).
//
//   B10  _flash_attention_impl   :589, pallas_call :758   o, and the row stats
//   B11  _flash_attention_bwd_dkv :941, pallas_call :1121  dK, dV
//   B12  _flash_attention_bwd_dq :1287, pallas_call :1456  dQ
//
// Same math as the bf16 kernels, on [B, H, T, D] float32 tensors:
//
//   s   = (q k^T) * scale + mask        mask: 0, or -0.7 * FLT_MAX above the
//                                        diagonal (DEFAULT_MASK_VALUE :29)
//   B10 o = softmax(s) v, online over key tiles; lse = m + log l per row
//   B11 p = exp(s - lse); dV = sum_q p^T dO; dP = dO v^T;
//       dS = p * (dP - di) * scale; dK = sum_q dS^T q
//   B12 dQ = sum_k dS k
//
// In float32 the TPU kernel's p.astype(v.dtype) (:471, :900, :918, :1258) is
// the identity: nothing is rounded below float32 here either.  Every product
// is split TF32 on the tensor cores (below), float32-accurate.  So the
// kernels agree with the float32 plain versions (ops/flash_attention.py) up
// to the order and the last bits of float32 sums.  expf and logf are the
// accurate ones (no fast-math flag).
//
// Bound.  At the LM's shape ([16, 8, 512, 64] f32, causal) one causal product
// is T^2/2 * D * B * H multiply-adds, 2.15 GFLOP: B10 does two (q k^T, p v),
// B11 four, B12 three.  At the H100's 67 TFLOP/s of float32 (no tensor
// cores) that is 0.064, 0.128 and 0.096 ms, against 0.020-0.030 ms for their
// bytes at 3.35 TB/s: all three are bound by operations.  Done in split TF32
// (three TF32 products each, 495 TFLOP/s dense: 165 TFLOP/s of
// float32-accurate work) the same work takes at least 0.026, 0.052 and 0.039
// ms, still above the bytes (0.020, 0.030, 0.025 ms): all three are bound by
// the tensor cores' operations.
//
// B10, B11 and B12: split TF32 on wgmma, fed by a TMA ring.
//
// The split.  A TF32 product keeps 10 bits of each mantissa: ~1e-3 off, far
// outside chip_smoke.py's F32_FLASH_TOL (2^-14 of max|plain|).  Each float32
// operand is written x = hi + lo, hi = x rounded to TF32 (to nearest, ties
// away) and lo = x - hi rounded to TF32: |lo| <= 2^-11 |x| and |x - hi -
// lo| <= 2^-22 |x|, of either sign.  A product is summed as lo.hi + hi.lo +
// hi.hi; the dropped lo.lo is below 2^-22 of it.  PyTorch's float32
// memory-efficient attention splits the same way (CUTLASS's
// OpMultiplyAddFastF32).  tests/test_torch_flash_f32.py holds this
// arithmetic on the CPU at hd 64: three passes within 2^-14 of float64, one
// pass outside.
//
// Unbiased, because the float32 LM's gradient check (chip_smoke.py,
// LM_F32_GRAD_RATIO) sums each kernel's errors over every token of a
// weight's gradient: there an error that always leans one way adds up where
// FFMA's rounding errors cancel.  On an H100 80GB HBM3 (700 W), with the
// last layer's wq and wk leaves the worst (card vs CPU, against the same
// leaves with the reference attention on both sides; limit 2.0; kernels of
// true float32 FMAs, the first build of all three, 1.72):
//   * The tensor core reads a float32 bit pattern as its truncation to TF32
//     (chip_smoke.py's TF32 probe).  Handing it the raw tile as hi and x -
//     trunc(x) as lo, which it truncates too, cost no conversion but
//     shrinks every operand by ~2^-21 on average: 4.31 (B11 0.144 and B12
//     0.107 ms).  Rounded parts alone still failed.
//   * The tensor core's own float32 sums truncate too, so a long chain of
//     wgmma adds into one accumulator leans toward zero: dK, dV and dQ take
//     192 adds over T = 512.  Each row-reduction product now sums one
//     streamed tile into a fresh accumulator (12 adds, small terms first)
//     and the thread adds it to its float32 sum in registers; each k-step of
//     a score product (3 adds) likewise: 1.75, the FMA kernels' level (the
//     control, bf16-rounded probabilities, 15,630), at B11 0.184 and B12
//     0.148 ms.  B10 built the same way keeps it there (1.72).
//
// Shape of a CTA.  160 threads per (b*h, 64-row output tile), the bf16
// kernels' grid and causal skips (B10 and B12 start the longest rows first):
// warps 0-3 are one consumer warpgroup that owns the tile's 64 rows (wgmma's
// M), warp 4 the producer, one lane of which issues every copy.  Resident
// tiles (B10 q; B11 k and v; B12 q and dO) come in once by TMA; streamed
// tiles of 32 rows (B10 and B12 k and v; B11 q and dO with their lse and di
// rows by bulk copy) through
// a ring slot with a full/empty mbarrier pair, released as soon as its last
// reader is done, so the next tile's copy runs under the row-reduction
// products.  TMA writes a float32 tile in boxes of 32 columns (128 bytes a
// row) with 128-byte swizzle, from 4-D maps (hd, T, H, B) over each view's
// byte strides.  B12 reads its rows' lse and di into registers; outputs are
// written from the accumulators through their strides, a quad of threads 32
// contiguous bytes.  At hd 64 two CTAs share an SM, and one CTA's
// conversion and elementwise passes run under the other's products: on an
// H100 that beat 64-row tiles in a 2-stage ring at one CTA an SM, where
// the consumers' conversion pass took about half of each kernel's time.
//
// Products: every one is wgmma.mma_async m64nNk8 .f32.tf32.tf32, A from
// registers, B from shared memory; TF32 wgmma reads operands K-major only
// (imm-trans exists for f16/bf16 alone).
//   * Score products (B10 s = q k^T; B11 s^T = k q^T and dP^T = v dO^T; B12
//     s = q k^T and dP = dO v^T) reduce over hd, contiguous on both sides.
//     A, the
//     resident tile, is read into the thread's fragment (rows r0, r0 + 8;
//     columns t, t + 4) a k8 step at a time and split in registers: no
//     A-side lo tile.  (Holding B12's fragments for every k-step took 64
//     more registers, which spilled at two CTAs an SM and ran slower.)  B,
//     the streamed tile: the consumers write its hi part over the raw TMA
//     tile and its lo tile beside it.  Each k-step (three wgmmas, B12 six:
//     both its products together) goes into fresh accumulators, folded into
//     the float32 sums in registers.
//   * Row-reduction products (B10 o = p v; B11 dV = p^T dO and dK = dS^T q;
//     B12 dQ = dS k) reduce over the streamed rows.  A is p, p^T, dS^T or
//     dS, split in registers straight from the score accumulators; B needs
//     a transposed copy ([hd][rows], rows contiguous, 128-byte swizzle) as
//     hi and lo, which the consumers write once a streamed tile (B10 v's
//     alone: v is read by no other product).  A tile's product goes into a
//     fresh accumulator, folded into o, dK, dV or dQ in registers.
//   Accumulator to A.  The m64nN f32 accumulator gives a thread columns 2t,
//   2t+1 of each 8-column block (t = lane % 4); the TF32 k8 A fragment
//   wants t, t+4.  No shuffle: the fragment takes column 2t as k = t and
//   2t+1 as k = t+4, and the transposed copy permutes its rows the same way
//   (position 8g + j + 4 par holds row 8g + 2j + par): a sum over k does not
//   care about its order.  One warp store covers rows 8g + {0, 2, 4, 6} +
//   par and 8 consecutive hd rows of the copy: 32 different banks, as the
//   read of the raw tile and the lo store.  No score, p or dS goes through
//   shared memory.
//
// B10's online softmax runs on the score accumulator: the thread holds rows
// r0 and r0 + 8 (8 of a streamed tile's 32 keys each), scales the scores,
// adds the mask on the diagonal tiles (B12's test for each (row, key) pair),
// takes the row max over its quad (two xor-shuffles), keeps m per row and l
// per thread (its keys' share; the quad's four added at the end) in float32,
// and rescales o by exp(m_old - m_new) in registers before the tile's p v is
// folded in: the rescale comes every 32 keys.  l sums the float32 p; the
// product takes hi + lo, within 2^-22 of it.  o = acc / l goes out through
// q's strides, lse = m + log l to [B, H, T].
//
// Shared memory is the binding budget (KB, 1 KB of alignment besides;
// streamed tiles of 32 rows, one ring stage):
//   B10 hd 64: q 16; k, v 16; k lo 8; v^T hi and lo 16: 56, three CTAs an
//       SM.  hd 128: 112, one CTA.  hd 32: 28.
//   B11 hd 64: k, v 32; q, dO 16; q lo, dO lo 16; q^T and dO^T hi and lo
//       32; lse and di rows 0.25: 96.25, two CTAs an SM (a second stage,
//       112.25, does not leave room for two).
//   B11 hd 128: 64 + 32 + 32 + 64 + 0.25 = 192.25, one CTA (64-row tiles
//       would need 385).
//   B11 hd 32: 16 + 8 + 8 + 16 + 0.25 = 48.25.
//   B12 hd 64: q, dO 32; k, v 16; k lo, v lo 16; k^T hi and lo 16: 80.
//   B12 hd 128: 64 + 32 + 32 + 32 = 160.  B12 hd 32: 16 + 8 + 8 + 8 = 40.
// Registers (ptxas -v, sm_90a; no spills, no wgmma serialized): B11 168,
// 168 and 252 at hd 32, 64 and 128; B12 155, 147 and 211.  Two CTAs of 160
// threads an SM cap a thread at 168 (three of their ten warps share one
// quarter of the register file): B11 issues its two score products' k-step
// one after the other, with one temporary accumulator, where issuing them
// together spilled.  B10 uses 128, 128 and 201: three CTAs an SM cap it at
// 136 at hd <= 64.  On an H100 80GB HBM3 (700 W), [16, 8, 512, 64] causal
// (`chip_smoke.py --flash-f32-times` on copies of this file that differ in
// one choice, one call, each twice), B10 took 0.108 ms at three CTAs an
// SM, 0.125 at two and 0.112 at three with a second ring stage.  It does
// not pipeline s_j against p_{j-1} v_{j-1} as the bf16 B10 does: its folds
// wait on every k-step, and the SM's other CTAs fill those waits.
//
// Each output entry is owned by one thread of one CTA and summed in a fixed
// order: no atomics, the same bits every run.
//
// Inputs may be strided views: each tensor comes with its B, H and T strides
// in elements, the last dim contiguous (the wrapper checks; the kernels also
// need every stride a multiple of 4 and 16-byte aligned bases for TMA, which
// the wrapper's multiple-of-8 rule gives).  Outputs are written through
// their strides the same way.  Each C entry launches on the caller's stream,
// allocates nothing and returns the CUDA error of the launch (0 on success).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                  // rows of a q or k/v tile
constexpr float kMask = -0.7f * 3.402823466e38f;   // DEFAULT_MASK_VALUE

struct Strided {                           // element strides of [B, H, T, D]
  long long b, h, t;
};

Strided strided(const long long* s, int i) {
  return Strided{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// rows [row0, row0 + 64) of (b, h) of a strided [B, H, T, D] tensor
__device__ __forceinline__ long long base(const Strided& st, int b, int h,
                                          int row0) {
  return b * st.b + h * st.h + static_cast<long long>(row0) * st.t;
}

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, split-TF32 wgmma
// ---------------------------------------------------------------------------

constexpr int kHopperThreads = 160;        // consumer warpgroup + producer warp
constexpr int kConsumers = 128;
constexpr uint32_t kHiMask = 0xffffe000u;  // the 19 bits a TF32 keeps

// The kernels stream tiles of 32 rows through a ring of one stage, so that
// at hd <= 64 two CTAs share an SM (at most 96 KB and 168 registers each):
// one CTA's conversion and elementwise passes run under the other's
// products.
constexpr int kRows = 32;                  // rows of a streamed tile
constexpr int kStages = 1;                 // ring slots
template <int D>
constexpr int min_blocks() {               // CTAs an SM
  return D == 128 ? 1 : 2;
}
// B10 keeps fewer tiles and values (56 KB, 128 registers at hd 64): three
// of its CTAs share an SM
template <int D>
constexpr int fwd_min_blocks() {
  return D == 128 ? 1 : 3;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes: the swizzle patterns
// that TMA writes and wgmma reads are those of the address bits.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
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

// `bytes` (a multiple of 16) of contiguous global memory into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Byte offset of element (r, c) of a float32 tile of `rows` rows as TMA
// writes it with 128-byte swizzle: boxes of 32 columns (128 bytes a row,
// rows x 128 bytes a box) one after another; in a box, the 16-byte chunk
// c / 4 of row r sits at chunk (c / 4) ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  const uint32_t off = (c >> 5) * rows * 128 + r * 128 + (c & 31) * 4;
  return off ^ ((off >> 3) & 0x70);
}

// Every box of a tile of `rows` rows at rows t.. of head (b, h).
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int t, int h, int b,
                                         int rows) {
#pragma unroll
  for (int x = 0; x < D / 32; ++x)
    tma_load(dst + x * rows * 128, map, bar, 32 * x, t, h, b);
}

// wgmma shared-memory descriptor of a K-major operand with 128-byte
// swizzle: start address, leading byte offset (unused by this layout), 1024
// bytes from one 8-row atom to the next.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// The tile [rows][K] at `tile` as a K-major operand at k-step kk (columns
// 8kk..8kk+7: 32 bytes into a swizzled row).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk, int rows) {
  return desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32);
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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// A float32 bit pattern rounded to TF32 (to nearest, ties away from zero),
// its low 13 bits zero: cvt.rna.tf32.f32 on finite values, in two integer
// instructions.
__device__ __forceinline__ uint32_t tf32_bits(uint32_t u) {
  return (u + 0x1000u) & kHiMask;
}

// x = hi + lo + e: hi x rounded to TF32, lo the rest rounded to TF32;
// |lo| <= 2^-11 |x| and |e| <= 2^-22 |x|, of either sign.
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)));
}

// d[16] (+)= A B, m64n32k8 TF32: A from registers, B a K-major descriptor;
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[32] (+)= A B, m64n64k8 TF32.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[64] (+)= A B, m64n128k8 TF32.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= A B with N = 2 x (d's length) columns.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  if constexpr (N == 32) {
    wgmma_n32(d, a, b, accumulate);
  } else if constexpr (N == 64) {
    wgmma_n64(d, a, b, accumulate);
  } else {
    wgmma_n128(d, a, b, accumulate);
  }
}

// The consumer warpgroup's pass over a streamed tile of R rows as TMA wrote
// it at `raw` (offsets from sm): each x is split; when kRow, hi is written
// back in place and lo to `lo` in the same layout; when kT, hi and lo go
// transposed to `thi` and `tlo` ([D][R], 128-byte swizzle) with the row
// index permuted
// within each group of 8: position 8g + j + 4 par holds row 8g + 2j + par
// (the note).  Warp w takes the row groups g = w, w + 4, ...; one warp
// instruction takes rows 8g + {0, 2, 4, 6} + par (lane / 8 = j) and columns
// 8m..8m+7 (lane % 8 = dd): 32 different banks on the read, the lo store
// and both transposed stores.
template <int D, int R, bool kT, bool kRow = true>
__device__ __forceinline__ void split_tile(unsigned char* sm, uint32_t raw,
                                           uint32_t lo, uint32_t thi,
                                           uint32_t tlo, int warp, int lane) {
  const int j = lane >> 3, dd = lane & 7;
#pragma unroll
  for (int g = warp; g < R / 8; g += 4) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      const int r = 8 * g + 2 * j + par, pos = 8 * g + j + 4 * par;
      const uint32_t row = r * 128 + (dd & 3) * 4;
      const uint32_t trow = (pos >> 5) * D * 128 + (pos & 3) * 4;
      const int tchunk = (pos & 31) >> 2;
#pragma unroll
      for (int m = 0; m < D / 8; ++m) {
        // element (r, 8m + dd): box m / 4, chunk (2 (m % 4) + dd / 4) ^ (r % 8)
        const uint32_t o = (m >> 2) * R * 128 + row +
                           (((2 * (m & 3) + (dd >> 2)) ^ (r & 7)) << 4);
        uint32_t x = *reinterpret_cast<const uint32_t*>(sm + raw + o), l;
        split(x, x, l);
        if constexpr (kRow) {
          *reinterpret_cast<uint32_t*>(sm + raw + o) = x;   // hi in place
          *reinterpret_cast<uint32_t*>(sm + lo + o) = l;
        }
        if constexpr (kT) {
          // element (8m + dd, pos) of the copy: chunk tchunk ^ dd
          const uint32_t ot = trow + (8 * m + dd) * 128 + ((tchunk ^ dd) << 4);
          *reinterpret_cast<uint32_t*>(sm + thi + ot) = x;
          *reinterpret_cast<uint32_t*>(sm + tlo + ot) = l;
        }
      }
    }
  }
}

// One k-step of a score product into a fresh accumulator, small terms
// first: t = lo.hi + hi.lo + hi.hi against B (hi and lo tiles at shared
// addresses bhi, blo).
template <int R>
__device__ __forceinline__ void score_step(float (&t)[R / 2],
                                           const uint32_t (&h)[4],
                                           const uint32_t (&l)[4], int kk,
                                           uint32_t bhi, uint32_t blo) {
  wgmma_fence();
  wgmma_tf32<R>(t, l, desc_k(bhi, kk, R), 0);
  wgmma_tf32<R>(t, h, desc_k(blo, kk, R), 1);
  wgmma_tf32<R>(t, h, desc_k(bhi, kk, R), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(t);
}

// c (+)= t, in float32 registers (round to nearest).
template <int N>
__device__ __forceinline__ void fold(float (&c)[N], const float (&t)[N],
                                     bool first) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i] = first ? t[i] : c[i] + t[i];
}

// The two score products of a streamed tile, c1 = A1 B1^T and c2 = A2 B2^T
// over the head dim, in split TF32: A1 and A2 the resident 64-row tiles at
// a1 and a2 (offsets from sm), read a k8 step at a time into the thread's
// fragments (rows r0, r0 + 8; columns t, t + 4) and split in registers; B1
// and B2 the streamed tiles of R rows, hi and lo (offsets from sm).  Each
// k-step runs on the tensor cores into fresh accumulators and is added to
// c1 and c2 in float32 registers (the note: the tensor core's own sums
// truncate).  kPaired issues both products' k-step together (six wgmmas a
// wait); otherwise one after the other, which needs half the temporaries
// (B11: 168 registers without a spill).  Without kSecond, c1 alone
// (score_product).
template <int D, int R, bool kPaired, bool kSecond = true>
__device__ __forceinline__ void score_products(
    float (&c1)[R / 2], float (&c2)[R / 2], const unsigned char* sm,
    uint32_t a1, uint32_t b1hi, uint32_t b1lo, uint32_t a2, uint32_t b2hi,
    uint32_t b2lo, int r0, int t) {
  const uint32_t s0 = smem_addr(sm);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t h1[4], l1[4], h2[4], l2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t o = swz(r0 + 8 * (i & 1), 8 * kk + t + 4 * (i >> 1), kTile);
      split(*reinterpret_cast<const uint32_t*>(sm + a1 + o), h1[i], l1[i]);
      if constexpr (kSecond)
        split(*reinterpret_cast<const uint32_t*>(sm + a2 + o), h2[i], l2[i]);
    }
    if constexpr (kPaired) {
      float t1[R / 2], t2[R / 2];
      wgmma_fence();
      wgmma_tf32<R>(t1, l1, desc_k(s0 + b1hi, kk, R), 0);
      wgmma_tf32<R>(t2, l2, desc_k(s0 + b2hi, kk, R), 0);
      wgmma_tf32<R>(t1, h1, desc_k(s0 + b1lo, kk, R), 1);
      wgmma_tf32<R>(t2, h2, desc_k(s0 + b2lo, kk, R), 1);
      wgmma_tf32<R>(t1, h1, desc_k(s0 + b1hi, kk, R), 1);
      wgmma_tf32<R>(t2, h2, desc_k(s0 + b2hi, kk, R), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t1);
      fence_regs(t2);
      fold(c1, t1, kk == 0);
      fold(c2, t2, kk == 0);
    } else {
      float t[R / 2];
      score_step<R>(t, h1, l1, kk, s0 + b1hi, s0 + b1lo);
      fold(c1, t, kk == 0);
      if constexpr (kSecond) {
        score_step<R>(t, h2, l2, kk, s0 + b2hi, s0 + b2lo);
        fold(c2, t, kk == 0);
      }
    }
  }
}

// One score product, c = A B^T, as score_products computes each of two.
template <int D, int R>
__device__ __forceinline__ void score_product(float (&c)[R / 2],
                                              const unsigned char* sm,
                                              uint32_t a, uint32_t bhi,
                                              uint32_t blo, int r0, int t) {
  score_products<D, R, false, false>(c, c, sm, a, bhi, blo, 0, 0, 0, r0, t);
}

// acc = A B over the R streamed rows, in split TF32, into a fresh
// accumulator (the caller adds it to its float32 sum): A a score tile's
// accumulator, split (hi, lo), as the k8 fragments {x[4j], x[4j+2],
// x[4j+1], x[4j+3]} of its n8 block j (columns 2t and 2t+1 taken as k = t
// and t + 4); B the transposed copies [D][R] at thi and tlo (shared
// addresses), whose permuted rows match that order.  The small terms of
// every k-step go first, then the hi.hi ones.
template <int D, int R>
__device__ __forceinline__ void row_product(float (&acc)[D / 2],
                                            const uint32_t (&hi)[R / 2],
                                            const uint32_t (&lo)[R / 2],
                                            uint32_t thi, uint32_t tlo) {
  uint32_t ah[R / 8][4], al[R / 8][4];
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * j + ((i & 1) << 1) + (i >> 1);   // 4j, 4j+2, 4j+1, 4j+3
      ah[j][i] = hi[e];
      al[j][i] = lo[e];
    }
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
    wgmma_tf32<D>(acc, al[j], desc_k(thi, j, D), j > 0);
    wgmma_tf32<D>(acc, ah[j], desc_k(tlo, j, D), 1);
  }
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
    wgmma_tf32<D>(acc, ah[j], desc_k(thi, j, D), 1);
}

// Rows r0 and r0 + 8 of a 64 x D accumulator (columns 8j + cq + {0, 1} of
// n8 block j) to rows row0.. of head (b, h) of a strided output.
template <int D>
__device__ __forceinline__ void store_rows(float* out, const Strided& st,
                                           int b, int h, int row0,
                                           const float (&acc)[D / 2], int r0,
                                           int cq) {
  float* p = out + base(st, b, h, row0);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(p + (r0 + 8 * half) * st.t + 8 * j + cq) =
          make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
}

// ---------------------------------------------------------------------------
// B10: o and lse (one CTA per 64-row q tile, k/v tiles streamed)
// ---------------------------------------------------------------------------

template <int D>
constexpr uint32_t fwd_bytes() {
  // q; kStages x (k, v); k lo; v^T hi and lo; the q barrier and a
  // full/empty pair a stage
  constexpr uint32_t res = kTile * D * 4, str = kRows * D * 4;
  return res + kStages * 2 * str + str + 2 * str + 8 * (1 + 2 * kStages);
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, fwd_min_blocks<D>())
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         float* __restrict__ o, float* __restrict__ lse,
                         Strided so, int H, int T, float scale, int causal) {
  constexpr int R = kRows, S = kStages;
  constexpr uint32_t kRes = kTile * D * 4, kStr = R * D * 4;
  constexpr uint32_t oQ = 0, oRing = kRes;                  // stage: k, v
  constexpr uint32_t oLo = oRing + S * 2 * kStr;            // k lo
  constexpr uint32_t oT = oLo + kStr;                       // v^T hi, lo
  constexpr uint32_t oBar = oT + 2 * kStr;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t s0 = smem_addr(sm);
  auto full = [&](int s) { return s0 + oBar + 8 * (1 + s); };
  auto empty = [&](int s) { return s0 + oBar + 8 * (1 + S + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qi = T / kTile - 1 - blockIdx.y;   // the longest rows start first
  const int n_kv = causal ? (qi + 1) * kTile / R : T / R;   // above skipped
  if (tid == 0) {
    mbar_init(s0 + oBar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                     // the producer warp
    if (tid == kConsumers) {
      mbar_expect(s0 + oBar, kRes);
      tma_tile<D>(s0 + oQ, &map_q, s0 + oBar, qi * kTile, h, b, kTile);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty(s), (j / S - 1) & 1);
        const uint32_t st = s0 + oRing + s * 2 * kStr;
        mbar_expect(full(s), 2 * kStr);
        tma_tile<D>(st, &map_k, full(s), j * R, h, b, R);
        tma_tile<D>(st + kStr, &map_v, full(s), j * R, h, b, R);
      }
    }
    return;
  }

  // consumer warpgroup: the thread's rows r0 and r0 + 8 of the tile; its
  // keys of n8 block jb are 8 jb + cq + {0, 1}
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), t = lane & 3, cq = 2 * t;
  float oa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oa[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: the thread's

  mbar_wait(s0 + oBar, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % S;
    const uint32_t ok = oRing + s * 2 * kStr, ov = ok + kStr;
    mbar_wait(full(s), (j / S) & 1);
    consumers_sync();                          // the last tile's product read
    split_tile<D, R, false>(sm, ok, oLo, 0, 0, warp, lane);
    split_tile<D, R, true, false>(sm, ov, 0, oT, oT + kStr, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync();

    float sc[R / 2];                           // s = q k^T
    score_product<D, R>(sc, sm, oQ, ok, oLo, r0, t);
    mbar_arrive(empty(s));                     // k and v read

    const bool diag = causal && (j + 1) * R > qi * kTile;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {          // i = 4 jb + 2 half + e
      const int half = (i >> 1) & 1;
      float x = sc[i] * scale;
      if (diag && j * R + 8 * (i >> 2) + cq + (i & 1) > qi * kTile + r0 + 8 * half)
        x += kMask;
      sc[i] = x;
      mx[half] = fmaxf(mx[half], x);
    }
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {     // the row max over the quad
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      const float m_new = fmaxf(m[half], mx[half]);
      alpha[half] = expf(m[half] - m_new);
      m[half] = m_new;
      l[half] *= alpha[half];
    }
    uint32_t ph[R / 2], pl[R / 2];             // p, split
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int half = (i >> 1) & 1;
      const float p = expf(sc[i] - m[half]);
      l[half] += p;
      split(__float_as_uint(p), ph[i], pl[i]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oa[i] *= alpha[(i >> 1) & 1];
    float tmp[D / 2];                          // this tile's p v
    wgmma_fence();
    row_product<D, R>(tmp, ph, pl, s0 + oT, s0 + oT + kStr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tmp);
    fold(oa, tmp, false);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {       // the row's l over the quad
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oa[i] = oa[i] / l[(i >> 1) & 1];
  store_rows<D>(o, so, b, h, qi * kTile, oa, r0, cq);
  if (t == 0) {
    float* out = lse + static_cast<long long>(bh) * T + qi * kTile + r0;
    out[0] = m[0] + logf(l[0]);
    out[8] = m[1] + logf(l[1]);
  }
}

// ---------------------------------------------------------------------------
// B11: dK, dV (one CTA per 64-row k/v tile, q tiles streamed)
// ---------------------------------------------------------------------------

template <int D>
constexpr uint32_t dkv_bytes() {
  // k, v; kStages x (q, dO); q lo, dO lo; q^T and dO^T hi and lo;
  // kStages x (lse, di rows); the k/v barrier and a full/empty pair a stage
  constexpr uint32_t res = kTile * D * 4, str = kRows * D * 4;
  return 2 * res + kStages * 2 * str + 2 * str + 4 * str +
         kStages * 2 * kRows * 4 + 8 * (1 + 2 * kStages);
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, min_blocks<D>())
    flash_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ di,
                             float* __restrict__ dk, float* __restrict__ dv,
                             Strided sdk, Strided sdv, int H, int T,
                             float scale, int causal) {
  constexpr int R = kRows, S = kStages;
  constexpr uint32_t kRes = kTile * D * 4, kStr = R * D * 4, kStat = R * 4;
  constexpr uint32_t oK = 0, oV = kRes, oRing = 2 * kRes;   // stage: q, dO
  constexpr uint32_t oLo = oRing + S * 2 * kStr;            // q lo, dO lo
  constexpr uint32_t oT = oLo + 2 * kStr;   // q^T hi, q^T lo, dO^T hi, lo
  constexpr uint32_t oStat = oT + 4 * kStr;                 // stage: lse, di
  constexpr uint32_t oBar = oStat + S * 2 * kStat;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t s0 = smem_addr(sm);
  auto full = [&](int s) { return s0 + oBar + 8 * (1 + s); };
  auto empty = [&](int s) { return s0 + oBar + 8 * (1 + S + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kj = blockIdx.y;                   // key tile 0 has the most rows
  const int nq = T / R;
  const int q_begin = causal ? kj * kTile / R : 0;   // tiles above skipped
  if (tid == 0) {
    mbar_init(s0 + oBar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                     // the producer warp
    if (tid == kConsumers) {
      mbar_expect(s0 + oBar, 2 * kRes);
      tma_tile<D>(s0 + oK, &map_k, s0 + oBar, kj * kTile, h, b, kTile);
      tma_tile<D>(s0 + oV, &map_v, s0 + oBar, kj * kTile, h, b, kTile);
      for (int qi = q_begin, j = 0; qi < nq; ++qi, ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty(s), (j / S - 1) & 1);
        const uint32_t st = s0 + oRing + s * 2 * kStr;
        const uint32_t stat = s0 + oStat + s * 2 * kStat;
        const long long row = static_cast<long long>(bh) * T + qi * R;
        mbar_expect(full(s), 2 * kStr + 2 * kStat);
        tma_tile<D>(st, &map_q, full(s), qi * R, h, b, R);
        tma_tile<D>(st + kStr, &map_do, full(s), qi * R, h, b, R);
        bulk_load(stat, lse + row, kStat, full(s));
        bulk_load(stat + kStat, di + row, kStat, full(s));
      }
    }
    return;
  }

  // consumer warpgroup: the thread's keys r0 and r0 + 8 of the tile; its
  // queries of n8 block jb are 8 jb + cq + {0, 1}
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), t = lane & 3, cq = 2 * t;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(s0 + oBar, 0);
  for (int qi = q_begin, j = 0; qi < nq; ++qi, ++j) {
    const int s = j % S;
    const uint32_t oq = oRing + s * 2 * kStr, odo = oq + kStr;
    const float* ls = reinterpret_cast<const float*>(sm + oStat + s * 2 * kStat);
    const float* dis = ls + R;
    mbar_wait(full(s), (j / S) & 1);
    consumers_sync();                          // the last tile's products read
    split_tile<D, R, true>(sm, oq, oLo, oT, oT + kStr, warp, lane);
    split_tile<D, R, true>(sm, odo, oLo + kStr, oT + 2 * kStr, oT + 3 * kStr,
                           warp, lane);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync();

    float st[R / 2], dp[R / 2];                // s^T = k q^T, dP^T = v dO^T
    score_products<D, R, false>(st, dp, sm, oK, oq, oLo, oV, odo, oLo + kStr,
                                r0, t);

    const bool diag = causal && qi * R < (kj + 1) * kTile;
    uint32_t hi[R / 2], lo[R / 2];             // p^T, then dS^T, split
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {          // i = 4 jb + 2 half + e
      const int key = r0 + 8 * ((i >> 1) & 1);
      const int c = 8 * (i >> 2) + cq + (i & 1);   // the query
      float x = st[i] * scale;
      if (diag && kj * kTile + key > qi * R + c) x += kMask;
      const float p = expf(x - ls[c]);
      split(__float_as_uint(p), hi[i], lo[i]);
      dp[i] = p * (dp[i] - dis[c]) * scale;   // dS^T
    }
    mbar_arrive(empty(s));                     // q, dO, lse and di read
    float tmp[D / 2];                          // this tile's dV, then dK
    wgmma_fence();
    row_product<D, R>(tmp, hi, lo, s0 + oT + 2 * kStr, s0 + oT + 3 * kStr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tmp);
    fold(dva, tmp, false);
#pragma unroll
    for (int i = 0; i < R / 2; ++i) split(__float_as_uint(dp[i]), hi[i], lo[i]);
    wgmma_fence();
    row_product<D, R>(tmp, hi, lo, s0 + oT, s0 + oT + kStr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tmp);
    fold(dka, tmp, false);
  }
  store_rows<D>(dk, sdk, b, h, kj * kTile, dka, r0, cq);
  store_rows<D>(dv, sdv, b, h, kj * kTile, dva, r0, cq);
}

// ---------------------------------------------------------------------------
// B12: dQ (one CTA per 64-row q tile, k/v tiles streamed)
// ---------------------------------------------------------------------------

template <int D>
constexpr uint32_t dq_bytes() {
  // q, dO; kStages x (k, v); k lo, v lo; k^T hi and lo; the q/dO barrier
  // and a full/empty pair a stage
  constexpr uint32_t res = kTile * D * 4, str = kRows * D * 4;
  return 2 * res + kStages * 2 * str + 2 * str + 2 * str +
         8 * (1 + 2 * kStages);
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, min_blocks<D>())
    flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ di,
                            float* __restrict__ dq, Strided sdq, int H, int T,
                            float scale, int causal) {
  constexpr int R = kRows, S = kStages;
  constexpr uint32_t kRes = kTile * D * 4, kStr = R * D * 4;
  constexpr uint32_t oQ = 0, oDo = kRes, oRing = 2 * kRes;  // stage: k, v
  constexpr uint32_t oLo = oRing + S * 2 * kStr;            // k lo, v lo
  constexpr uint32_t oT = oLo + 2 * kStr;                   // k^T hi, lo
  constexpr uint32_t oBar = oT + 2 * kStr;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t s0 = smem_addr(sm);
  auto full = [&](int s) { return s0 + oBar + 8 * (1 + s); };
  auto empty = [&](int s) { return s0 + oBar + 8 * (1 + S + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qi = T / kTile - 1 - blockIdx.y;   // the longest rows start first
  const int n_kv = causal ? (qi + 1) * kTile / R : T / R;   // above skipped
  if (tid == 0) {
    mbar_init(s0 + oBar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                     // the producer warp
    if (tid == kConsumers) {
      mbar_expect(s0 + oBar, 2 * kRes);
      tma_tile<D>(s0 + oQ, &map_q, s0 + oBar, qi * kTile, h, b, kTile);
      tma_tile<D>(s0 + oDo, &map_do, s0 + oBar, qi * kTile, h, b, kTile);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty(s), (j / S - 1) & 1);
        const uint32_t st = s0 + oRing + s * 2 * kStr;
        mbar_expect(full(s), 2 * kStr);
        tma_tile<D>(st, &map_k, full(s), j * R, h, b, R);
        tma_tile<D>(st + kStr, &map_v, full(s), j * R, h, b, R);
      }
    }
    return;
  }

  // consumer warpgroup: the thread's rows r0 and r0 + 8 of the tile; its
  // keys of n8 block jb are 8 jb + cq + {0, 1}
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), t = lane & 3, cq = 2 * t;
  const long long row = static_cast<long long>(bh) * T + qi * kTile + r0;
  const float ls[2] = {lse[row], lse[row + 8]};
  const float ds[2] = {di[row], di[row + 8]};
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  mbar_wait(s0 + oBar, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % S;
    const uint32_t ok = oRing + s * 2 * kStr, ov = ok + kStr;
    mbar_wait(full(s), (j / S) & 1);
    consumers_sync();                          // the last tile's product read
    split_tile<D, R, true>(sm, ok, oLo, oT, oT + kStr, warp, lane);
    split_tile<D, R, false>(sm, ov, oLo + kStr, 0, 0, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync();

    float sc[R / 2], dp[R / 2];                // s = q k^T, dP = dO v^T
    score_products<D, R, true>(sc, dp, sm, oQ, ok, oLo, oDo, ov, oLo + kStr,
                               r0, t);
    mbar_arrive(empty(s));                     // k and v read

    const bool diag = causal && (j + 1) * R > qi * kTile;
    uint32_t dh[R / 2], dl[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {          // i = 4 jb + 2 half + e
      const int half = (i >> 1) & 1;
      float x = sc[i] * scale;
      if (diag && j * R + 8 * (i >> 2) + cq + (i & 1) > qi * kTile + r0 + 8 * half)
        x += kMask;
      const float p = expf(x - ls[half]);
      split(__float_as_uint(p * (dp[i] - ds[half]) * scale), dh[i], dl[i]);
    }
    float tmp[D / 2];                          // this tile's dQ
    wgmma_fence();
    row_product<D, R>(tmp, dh, dl, s0 + oT, s0 + oT + kStr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tmp);
    fold(dqa, tmp, false);
  }
  store_rows<D>(dq, sdq, b, h, qi * kTile, dqa, r0, cq);
}

// ---------------------------------------------------------------------------
// The TF32 probe: how the tensor core reads a float32 bit pattern
// ---------------------------------------------------------------------------

// d [64][32] = a [64][8] b^T ([32][8]) by one m64n32k8 TF32 wgmma, the bits
// of a (registers) and b (shared memory, the kernels' swizzled layout)
// handed over as they are.  chip_smoke.py sets the result beside the
// products of their truncations and of their roundings to TF32.
__global__ void __launch_bounds__(kConsumers)
    tf32_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < 32 * 32; i += kConsumers) {
    const int n = i >> 5, c = i & 31;
    *reinterpret_cast<float*>(sm + swz(n, c, 32)) = c < 8 ? b[n * 8 + c] : 0.f;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const int r0 = 16 * warp + (lane >> 2), t = lane & 3;
  uint32_t fa[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    fa[i] = __float_as_uint(a[(r0 + 8 * (i & 1)) * 8 + t + 4 * (i >> 1)]);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  wgmma_fence();
  wgmma_n32(acc, fa, desc_k(smem_addr(sm), 0, 32), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    d[(r0 + 8 * ((i >> 1) & 1)) * 32 + 8 * (i >> 2) + 2 * t + (i & 1)] = acc[i];
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
int prepare(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
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

// The 4-D map (hd, T, H, B) of a float32 tensor of element strides st, in
// boxes of 32 columns x `rows` rows with the 128-byte swizzle wgmma reads.
template <int D>
int make_map(CUtensorMap* map, const void* ptr, Strided st, int B, int H,
             int T, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.t) * sizeof(float),
                                 static_cast<cuuint64_t>(st.h) * sizeof(float),
                                 static_cast<cuuint64_t>(st.b) * sizeof(float)};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, const long long* s, int B, int H, int T,
               float scale, int causal, cudaStream_t stream) {
  constexpr int R = kRows;
  CUtensorMap mq, mk, mv;
  if (int e = make_map<D>(&mq, q, strided(s, 0), B, H, T, kTile)) return e;
  if (int e = make_map<D>(&mk, k, strided(s, 1), B, H, T, R)) return e;
  if (int e = make_map<D>(&mv, v, strided(s, 2), B, H, T, R)) return e;
  constexpr size_t smem = 1024 + fwd_bytes<D>();
  if (int e = prepare(flash_fwd_f32_kernel<D>, smem)) return e;
  const dim3 grid(B * H, T / kTile);
  flash_fwd_f32_kernel<D><<<grid, kHopperThreads, smem, stream>>>(
      mq, mk, mv, o, lse, strided(s, 3), H, T, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* di,
               float* dk, float* dv, const long long* s, int B, int H, int T,
               float scale, int causal, cudaStream_t stream) {
  // the stat rows come in by bulk copy: 16-byte aligned
  if ((reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(di)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int R = kRows;
  CUtensorMap mq, mk, mv, mdo;
  if (int e = make_map<D>(&mq, q, strided(s, 0), B, H, T, R)) return e;
  if (int e = make_map<D>(&mk, k, strided(s, 1), B, H, T, kTile)) return e;
  if (int e = make_map<D>(&mv, v, strided(s, 2), B, H, T, kTile)) return e;
  if (int e = make_map<D>(&mdo, dout, strided(s, 3), B, H, T, R)) return e;
  constexpr size_t smem = 1024 + dkv_bytes<D>();
  if (int e = prepare(flash_bwd_dkv_f32_kernel<D>, smem)) return e;
  const dim3 grid(B * H, T / kTile);
  flash_bwd_dkv_f32_kernel<D><<<grid, kHopperThreads, smem, stream>>>(
      mq, mk, mv, mdo, lse, di, dk, dv, strided(s, 4), strided(s, 5), H, T,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* di,
              float* dq, const long long* s, int B, int H, int T, float scale,
              int causal, cudaStream_t stream) {
  constexpr int R = kRows;
  CUtensorMap mq, mk, mv, mdo;
  if (int e = make_map<D>(&mq, q, strided(s, 0), B, H, T, kTile)) return e;
  if (int e = make_map<D>(&mk, k, strided(s, 1), B, H, T, R)) return e;
  if (int e = make_map<D>(&mv, v, strided(s, 2), B, H, T, R)) return e;
  if (int e = make_map<D>(&mdo, dout, strided(s, 3), B, H, T, kTile)) return e;
  constexpr size_t smem = 1024 + dq_bytes<D>();
  if (int e = prepare(flash_bwd_dq_f32_kernel<D>, smem)) return e;
  const dim3 grid(B * H, T / kTile);
  flash_bwd_dq_f32_kernel<D><<<grid, kHopperThreads, smem, stream>>>(
      mq, mk, mv, mdo, lse, di, dq, strided(s, 4), H, T, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

#define F(p) static_cast<const float*>(p)
#define W(p) static_cast<float*>(p)

}  // namespace

// strides: B, H, T element strides of q, k, v, o (12 values).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, const long long* strides,
                             int B, int H, int T, int D, float scale,
                             int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || T == 0) return 0;
  switch (D) {
    case 32: return launch_fwd<32>(F(q), F(k), F(v), W(o), W(lse), strides, B, H, T, scale, causal, st);
    case 64: return launch_fwd<64>(F(q), F(k), F(v), W(o), W(lse), strides, B, H, T, scale, causal, st);
    case 128: return launch_fwd<128>(F(q), F(k), F(v), W(o), W(lse), strides, B, H, T, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: q, k, v, dO, dK, dV (18 values).
extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* di, void* dk, void* dv,
                                 const long long* strides, int B, int H,
                                 int T, int D, float scale, int causal,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || T == 0) return 0;
  switch (D) {
    case 32: return launch_dkv<32>(F(q), F(k), F(v), F(dout), F(lse), F(di), W(dk), W(dv), strides, B, H, T, scale, causal, st);
    case 64: return launch_dkv<64>(F(q), F(k), F(v), F(dout), F(lse), F(di), W(dk), W(dv), strides, B, H, T, scale, causal, st);
    case 128: return launch_dkv<128>(F(q), F(k), F(v), F(dout), F(lse), F(di), W(dk), W(dv), strides, B, H, T, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: q, k, v, dO, dQ (15 values).
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, void* dq,
                                const long long* strides, int B, int H, int T,
                                int D, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || T == 0) return 0;
  switch (D) {
    case 32: return launch_dq<32>(F(q), F(k), F(v), F(dout), F(lse), F(di), W(dq), strides, B, H, T, scale, causal, st);
    case 64: return launch_dq<64>(F(q), F(k), F(v), F(dout), F(lse), F(di), W(dq), strides, B, H, T, scale, causal, st);
    case 128: return launch_dq<128>(F(q), F(k), F(v), F(dout), F(lse), F(di), W(dq), strides, B, H, T, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The TF32 probe: d [64][32] = a [64][8] b^T for b [32][8], float32 bit
// patterns handed to one TF32 wgmma as they are (one CTA, 128 threads).
extern "C" int tf32_probe(const void* a, const void* b, void* d, void* stream) {
  tf32_probe_kernel<<<1, kConsumers, 32 * 128 + 1024,
                      static_cast<cudaStream_t>(stream)>>>(F(a), F(b), W(d));
  return static_cast<int>(cudaGetLastError());
}
