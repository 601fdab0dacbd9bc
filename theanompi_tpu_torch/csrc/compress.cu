// Compressed-wire kernels for Hopper (sm_90a).  Onebit: sign pack (B3),
// weighted decode (B4), fused encode (B5) and residual (B6).  Topk: fused
// encode (B7) and decode (B8), described at their kernels below.
//
// Replace the TPU kernels of theanompi_tpu/ops/compress.py:
//   B3 pack_signs           <- _pack_pallas        (compress.py:200)
//   B4 unpack_signs_wsum    <- _unpack_wsum_pallas (compress.py:234)
//   B5 pack_signs_encode    <- _encode_pallas      (compress.py:268)
//   B6 signed_residual      <- _residual_pallas    (compress.py:307)
//   B7 topk_encode          <- _topk_encode_pallas (compress.py:362)
//   B8 topk_decode          <- _topk_decode_pallas (compress.py:402)
//
// Wire layout (compress.py:35-48): a float32 vector of n elements,
// n % 32768 == 0, is viewed as blocks of 256 rows x 128 lanes.  Packed word
// [r, l] of a block (r < 8) holds in bit b the sign bit of row 8b + r, lane
// l, so a block packs to 8 x 128 words and the packed array is
// [n / 4096, 128].  The bit is (c >= 0): +0.0 and -0.0 both give 1, NaN 0,
// as pack_signs_jnp.  Words travel as int32 with the same bits.
//
// Bound: device-memory bytes.  Every kernel does one to a few operations per
// element it moves (a compare and a shift, an add and an abs, a subtract),
// far under the ~20 flops per byte at which the H100's f32 rate would
// start to limit.  So each kernel makes one pass over device memory:
//
//   * One block of 1024 threads owns one 256 x 128 tile; thread (r, l),
//     r = threadIdx.y < 8, l = threadIdx.x < 128, owns word [r, l] and
//     walks b = 0..31 over the rows 8b + r of lane l.  A warp is 32
//     consecutive lanes of one row, so each of its loads and stores is 128
//     contiguous bytes, and each word is read or written exactly once.
//   * B5 forms c = flat + state in a register and writes |c| and the word:
//     c itself never reaches device memory, as in the TPU kernel.
//   * B6 reads its word once and writes 32 residuals; the scale is read
//     from device memory (a pointer), so the host never waits for it.
//   * B4 reads the W words of its position and the W scales once, and
//     writes 32 outputs.  The loop over b is unrolled in part, so each
//     thread keeps several loads in flight.
//
// Arithmetic is the Pallas kernels', operation for operation, with every
// add and subtract rounded on its own (__fadd_rn / __fsub_rn: no FMA
// contraction), so B3, B5 and B6 equal pack_signs_jnp, pack_signs_encode_jnp
// and signed_residual_jnp bit for bit.  B4 computes
//     out = sum_w bit_w * (2 s_w)  -  sum_w s_w        (worker order)
// as _make_unpack_wsum_kernel does; it reassociates the plain
// sum_w s_w * (2 bit_w - 1), exactly at W = 1.
//
// Each C entry launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWordRows = 8;                     // words per lane per tile
constexpr int kBits = 32;                        // rows per word
constexpr int kTile = kLanes * kWordRows * kBits;  // 32768 elements

// element offset of bit b of word [r, l] inside its tile
__device__ __forceinline__ int elem(int b, int r, int l) {
  return (b * kWordRows + r) * kLanes + l;
}

__global__ void __launch_bounds__(1024)
pack_kernel(const float* __restrict__ c, uint32_t* __restrict__ words) {
  const int r = threadIdx.y, l = threadIdx.x;
  const float* t = c + static_cast<size_t>(blockIdx.x) * kTile;
  uint32_t w = 0;
#pragma unroll 8
  for (int b = 0; b < kBits; ++b)
    w |= static_cast<uint32_t>(t[elem(b, r, l)] >= 0.f) << b;
  words[(static_cast<size_t>(blockIdx.x) * kWordRows + r) * kLanes + l] = w;
}

__global__ void __launch_bounds__(1024)
encode_kernel(const float* __restrict__ flat, const float* __restrict__ state,
              uint32_t* __restrict__ words, float* __restrict__ absc) {
  const int r = threadIdx.y, l = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  uint32_t w = 0;
#pragma unroll 8
  for (int b = 0; b < kBits; ++b) {
    const size_t i = base + elem(b, r, l);
    const float v = __fadd_rn(flat[i], state[i]);
    w |= static_cast<uint32_t>(v >= 0.f) << b;
    absc[i] = fabsf(v);
  }
  words[(static_cast<size_t>(blockIdx.x) * kWordRows + r) * kLanes + l] = w;
}

__global__ void __launch_bounds__(1024)
residual_kernel(const float* __restrict__ absc,
                const uint32_t* __restrict__ words,
                const float* __restrict__ scale, float* __restrict__ out) {
  const int r = threadIdx.y, l = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  const uint32_t w =
      words[(static_cast<size_t>(blockIdx.x) * kWordRows + r) * kLanes + l];
  const float s = *scale;
#pragma unroll 8
  for (int b = 0; b < kBits; ++b) {
    const size_t i = base + elem(b, r, l);
    const float a = absc[i];
    out[i] = ((w >> b) & 1u) ? __fsub_rn(a, s) : __fsub_rn(s, a);
  }
}

// packed [W, m, 128] words, scales [W] -> out [32 m 128]
__global__ void __launch_bounds__(1024)
unpack_wsum_kernel(const uint32_t* __restrict__ packed,
                   const float* __restrict__ scales, float* __restrict__ out,
                   int n_workers, size_t m) {
  constexpr int kMaxW = 8;   // workers whose words a thread holds at once
  const int r = threadIdx.y, l = threadIdx.x;
  const size_t pos =
      (static_cast<size_t>(blockIdx.x) * kWordRows + r) * kLanes + l;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  float total = 0.f;
  for (int w = 0; w < n_workers; ++w) total = __fadd_rn(total, scales[w]);
  float* o = out + base;
  for (int w0 = 0; w0 < n_workers; w0 += kMaxW) {
    // workers in chunks of kMaxW: the first chunk starts from 0, later ones
    // from the partial sums already stored, so the order stays w = 0..W-1
    const int nw = min(kMaxW, n_workers - w0);
    uint32_t wd[kMaxW];
    float s2[kMaxW];
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      if (k < nw) {
        wd[k] = packed[static_cast<size_t>(w0 + k) * m * kLanes + pos];
        s2[k] = 2.f * scales[w0 + k];
      }
    }
    const bool last = w0 + nw == n_workers;
#pragma unroll 8
    for (int b = 0; b < kBits; ++b) {
      const int i = elem(b, r, l);
      float acc = w0 == 0 ? 0.f : o[i];
#pragma unroll
      for (int k = 0; k < kMaxW; ++k)
        if (k < nw)
          acc = __fadd_rn(acc, static_cast<float>((wd[k] >> b) & 1u) * s2[k]);
      o[i] = last ? __fsub_rn(acc, total) : acc;
    }
  }
}

// ---------------------------------------------------------------------------
// Topk (B7, B8).  The flat error-fed vector is viewed as [rows, chunk]
// (chunk <= 32768, so offsets fit int16); each row ships its k largest |c|
// as bf16 values and int16 offsets.
//
// B7, encode: a radix select.  Oracle topk_encode_jnp: slots in descending
// |c|, the lower offset first on ties (lax.top_k), values rounded to bf16 to
// nearest even, and the state is c with v - float(bf16(v)) written at each
// selected offset.  One block of 256 threads per row.  The row is read from
// device memory once, into shared memory (one spare word after every 32, so
// that thread t, which owns the contiguous offsets t E .. t E + E - 1 with
// E = ceil(chunk / 256), reads them without bank conflicts), and written
// back once, as the new state.  In between:
//   * The key of an element is the bits of |c| (bits(c) & 0x7fffffff),
//     which order like |c|: +0.0 and -0.0 both give 0, and every NaN is
//     given one key above +inf, so NaN ranks first and NaNs tie, as in the
//     plain version's stable descending sort.
//   * Radix select over the 31 key bits in digits of 11, 11 and 9 bits from
//     the top: a pass counts the digits of the elements whose higher digits
//     equal the threshold's so far into a shared histogram, then a suffix
//     scan finds the digit that holds the k-th largest key.  Each
//     candidate adds one shared-memory atomic, even where a warp's lanes
//     hit one bin: at VGG-16's [16890, 8192], k = 82 on an H100 (700 W)
//     `chip_smoke.py --topk-times` read 0.593 ms on the topk phase's rows,
//     0.728 on all-zero rows and 0.701 on rows whose |c| share their top 16
//     bits, where aggregating a warp's equal bins through __match_any_sync
//     read 0.949, 0.974 and 1.202 (the first digit holds the exponent and 3
//     mantissa bits, so a gradient row spreads over tens of bins).  The
//     times here compare copies of this file that differ only in the path
//     named, run in one call, each twice.  The passes stop early once
//     every element left in that digit is selected.  This gives a key prefix P and the count `need` of
//     elements with prefix P to take (the others above P are all taken).
//   * Tie-break: an ordered prefix count over the threads (one block scan)
//     takes, of the elements with prefix P, the `need` lowest offsets.  So
//     the k winners are known, and compacted into a list in offset order.
//   * Slots: the list is ordered by (key desc, offset asc): for k <= 256
//     each winner counts the winners ahead of it (its slot) from a copy of
//     their keys, for larger k a bitonic sort of the list in shared memory
//     (the bitonic sort alone read 0.743 ms on the topk phase's rows at
//     k = 82, against 0.593 with the rank count).
//   * The values and offsets are written once; the residual
//     __fsub_rn(x, bf16(x)) goes into the shared row at the winners, and
//     the row is stored as the new state.
//
// The row moves as float4 where chunk % 4 == 0 and both row pointers are
// 16-byte aligned (the main path's case), else word by word (which alone
// read 0.608 ms there, against 0.593).
//
// Bound: the row is read once and the state written once (8 bytes per
// element), plus 4 bytes a slot; the select does a few shared-memory passes
// over the row, and other blocks resident on the SM cover one block's
// passes with their loads.
//
// B8, decode.  Oracle topk_decode_jnp: dense[r·chunk + off] += val over
// workers in order, then / size when size != 1.  One block per row: the
// row accumulates in shared memory worker by worker (a worker's offsets in
// a row are distinct, so its adds never collide; a barrier separates
// workers), then each element is stored once, divided by size with an
// IEEE division (__fdiv_rn), as the oracle divides.  Every element sees
// the plain version's sequence of roundings, so B8 equals it bit for bit
// at any worker count.  Bound: the dense output's 4 bytes per element.
// ---------------------------------------------------------------------------

constexpr int kTopkThreads = 256;
constexpr int kTopkWarps = kTopkThreads / 32;
constexpr int kSelBins = 2048;                   // the widest digit: 11 bits
constexpr int kRankSortMax = kTopkThreads;       // k up to this: rank counting
constexpr uint16_t kNoSlot = 0xffff;             // bitonic padding

// |c|'s bits as an unsigned key that orders like |c|; every NaN one key
// above +inf
__device__ __forceinline__ uint32_t mag_key(float x) {
  const uint32_t a = __float_as_uint(x) & 0x7fffffffu;
  return a > 0x7f800000u ? 0x7fc00000u : a;
}

// shared-memory position of row offset j (a spare word after every 32),
// and back
__device__ __forceinline__ int row_pos(int j) { return j + (j >> 5); }
__device__ __forceinline__ int row_offset(int p) { return p - p / 33; }

// Exclusive prefix sum of v over the block's threads in thread order.
// Every thread calls it; `scratch` holds kTopkWarps words.
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t v,
                                                        uint32_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  uint32_t before = 0;
#pragma unroll
  for (int w = 0; w < kTopkWarps; ++w) before += w < warp ? scratch[w] : 0u;
  __syncthreads();                 // scratch is free for the next call
  return before + x - v;
}

// Slot order of two winners at shared positions a and b (kNoSlot last):
// the larger key first, then the lower offset (positions order like
// offsets).
__device__ __forceinline__ bool slot_before(const float* row, uint32_t a,
                                            uint32_t b) {
  if (b == kNoSlot) return a != kNoSlot;
  if (a == kNoSlot) return false;
  const uint32_t ka = mag_key(row[a]), kb = mag_key(row[b]);
  return ka > kb || (ka == kb && a < b);
}

// c2 [rows, chunk] -> vals, idx [rows, k], state [rows, chunk].  Dynamic
// shared memory: the padded row (row_pos(chunk - 1) + 1 floats), the
// histogram (kSelBins words), the winners' positions (list_len uint16).
__global__ void __launch_bounds__(kTopkThreads)
topk_encode_kernel(const float* __restrict__ c2, __nv_bfloat16* __restrict__ vals,
                   int16_t* __restrict__ idx, float* __restrict__ state,
                   int chunk, int k, int list_len, int vec4) {
  extern __shared__ float smem[];
  const int row_len = row_pos(chunk - 1) + 1;
  float* row = smem;
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem + row_len);
  uint16_t* list = reinterpret_cast<uint16_t*>(hist + kSelBins);
  __shared__ uint32_t scratch[kTopkWarps];
  __shared__ uint32_t found[2];                  // the digit, the count above it
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * chunk;
  const size_t slot0 = static_cast<size_t>(blockIdx.x) * k;

  if (vec4) {                                    // chunk % 4 == 0, aligned
    const float4* src = reinterpret_cast<const float4*>(c2 + base);
#pragma unroll 4
    for (int v = t; v < chunk / 4; v += kTopkThreads) {
      const float4 x = src[v];
      float* d = row + row_pos(4 * v);           // 4 v .. 4 v + 3: one group
      d[0] = x.x;
      d[1] = x.y;
      d[2] = x.z;
      d[3] = x.w;
    }
  } else {
    for (int j = t; j < chunk; j += kTopkThreads) row[row_pos(j)] = c2[base + j];
  }
  __syncthreads();

  const int per = (chunk + kTopkThreads - 1) / kTopkThreads;   // E
  const int j0 = t * per, j1 = min(j0 + per, chunk);
  uint32_t prefix = 0, mask = 0;                 // the threshold's digits so far
  uint32_t need = k;                             // winners left among them
#pragma unroll 1
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = pass == 0 ? 20 : pass == 1 ? 9 : 0;
    const int bins = pass == 2 ? 512 : kSelBins;
    for (int i = t; i < bins; i += kTopkThreads) hist[i] = 0u;
    __syncthreads();
    for (int j = j0; j < j1; ++j) {
      const uint32_t key = mag_key(row[row_pos(j)]);
      if ((key & mask) == prefix)
        atomicAdd(hist + ((key >> shift) & (bins - 1)), 1u);
    }
    __syncthreads();
    // thread u scans bins [bins - (u+1) w, bins - u w), w = bins / 256: the
    // block's exclusive sum gives the count above them
    const int w = bins / kTopkThreads, hi = bins - t * w;
    uint32_t mine = 0;
    for (int b = hi - w; b < hi; ++b) mine += hist[b];
    uint32_t above = block_exclusive_sum(mine, scratch);
    if (above < need && need <= above + mine) {  // exactly one thread
      for (int b = hi - 1;; --b) {
        if (above + hist[b] >= need) {
          found[0] = b;
          found[1] = above;
          break;
        }
        above += hist[b];
      }
    }
    __syncthreads();
    const uint32_t digit = found[0];
    need -= found[1];
    prefix |= digit << shift;
    mask |= static_cast<uint32_t>(bins - 1) << shift;
    const bool done = hist[digit] == need;       // all of the digit is taken
    __syncthreads();                             // found and hist are reused
    if (done) break;
  }

  // winners: every key whose masked prefix is above P, and of those equal to
  // P the `need` lowest offsets; their positions into the list, in offset
  // order
  uint32_t n_gt = 0, n_eq = 0;
  for (int j = j0; j < j1; ++j) {
    const uint32_t m = mag_key(row[row_pos(j)]) & mask;
    n_gt += m > prefix;
    n_eq += m == prefix;
  }
  const uint32_t ex = block_exclusive_sum((n_gt << 16) | n_eq, scratch);
  const uint32_t eq_before = ex & 0xffffu;
  uint32_t pos = (ex >> 16) + min(eq_before, need);
  uint32_t eq_seen = eq_before;
  for (int j = j0; j < j1; ++j) {
    const uint32_t m = mag_key(row[row_pos(j)]) & mask;
    if (m > prefix || (m == prefix && eq_seen++ < need))
      list[pos++] = static_cast<uint16_t>(row_pos(j));
  }
  for (int i = k + t; i < list_len; i += kTopkThreads) list[i] = kNoSlot;
  __syncthreads();

  if (k <= kRankSortMax) {
    // each winner's slot: the winners ahead of it (the list is in offset
    // order, so a tie is ahead when it comes earlier in the list); their
    // keys go into the histogram's words, free now
    uint32_t* keys = hist;
    if (t < k) keys[t] = mag_key(row[list[t]]);
    __syncthreads();
    if (t < k) {
      const uint32_t p = list[t], kt = keys[t];
      uint32_t slot = 0;
      for (int u = 0; u < k; ++u) {
        const uint32_t ku = keys[u];
        slot += ku > kt || (ku == kt && u < t);
      }
      const float x = row[p];
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      vals[slot0 + slot] = h;
      idx[slot0 + slot] = static_cast<int16_t>(row_offset(p));
      row[p] = __fsub_rn(x, __bfloat162float(h));
    }
  } else {
    // bitonic sort of the list (list_len a power of two) into slot order
    for (int size = 2; size <= list_len; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = t; i < list_len / 2; i += kTopkThreads) {
          const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
          const uint32_t a = list[lo], b = list[hi];
          if ((lo & size) == 0 ? slot_before(row, b, a) : slot_before(row, a, b)) {
            list[lo] = b;
            list[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int s = t; s < k; s += kTopkThreads) {
      const uint32_t p = list[s];
      const float x = row[p];
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      vals[slot0 + s] = h;
      idx[slot0 + s] = static_cast<int16_t>(row_offset(p));
      row[p] = __fsub_rn(x, __bfloat162float(h));
    }
  }
  __syncthreads();

  if (vec4) {
    float4* dst = reinterpret_cast<float4*>(state + base);
#pragma unroll 4
    for (int v = t; v < chunk / 4; v += kTopkThreads) {
      const float* s = row + row_pos(4 * v);
      dst[v] = make_float4(s[0], s[1], s[2], s[3]);
    }
  } else {
    for (int j = t; j < chunk; j += kTopkThreads) state[base + j] = row[row_pos(j)];
  }
}

__global__ void __launch_bounds__(kTopkThreads)
topk_decode_kernel(const __nv_bfloat16* __restrict__ vals,
                   const int16_t* __restrict__ idx, float* __restrict__ out,
                   int n_workers, size_t rows, int k, int chunk, int size) {
  extern __shared__ float acc[];                             // [chunk]
  const int t = threadIdx.x;
  const size_t r = blockIdx.x;
  for (int j = t; j < chunk; j += kTopkThreads) acc[j] = 0.f;
  __syncthreads();
  for (int w = 0; w < n_workers; ++w) {
    const size_t o = (static_cast<size_t>(w) * rows + r) * k;
    for (int s = t; s < k; s += kTopkThreads) {
      const int j = idx[o + s];
      acc[j] = __fadd_rn(acc[j], __bfloat162float(vals[o + s]));
    }
    __syncthreads();
  }
  float* dst = out + r * chunk;
  if (size != 1) {
    const float d = static_cast<float>(size);
    for (int j = t; j < chunk; j += kTopkThreads) dst[j] = __fdiv_rn(acc[j], d);
  } else {
    for (int j = t; j < chunk; j += kTopkThreads) dst[j] = acc[j];
  }
}

// dynamic shared memory past the default 48 KB needs the opt-in
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

inline int finish() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// n % 32768 == 0 (the wrapper checks)
int pack_signs(const float* c, uint32_t* words, long long n,
               cudaStream_t stream) {
  if (n > 0)
    pack_kernel<<<static_cast<unsigned>(n / kTile), dim3(kLanes, kWordRows),
                  0, stream>>>(c, words);
  return finish();
}

int pack_signs_encode(const float* flat, const float* state, uint32_t* words,
                      float* absc, long long n, cudaStream_t stream) {
  if (n > 0)
    encode_kernel<<<static_cast<unsigned>(n / kTile), dim3(kLanes, kWordRows),
                    0, stream>>>(flat, state, words, absc);
  return finish();
}

int signed_residual(const float* absc, const uint32_t* words,
                    const float* scale, float* out, long long n,
                    cudaStream_t stream) {
  if (n > 0)
    residual_kernel<<<static_cast<unsigned>(n / kTile),
                      dim3(kLanes, kWordRows), 0, stream>>>(absc, words, scale,
                                                            out);
  return finish();
}

// m = packed rows per worker (m % 8 == 0); out has 32 * m * 128 elements
int unpack_signs_wsum(const uint32_t* packed, const float* scales, float* out,
                      int n_workers, long long m, cudaStream_t stream) {
  if (m > 0 && n_workers > 0)
    unpack_wsum_kernel<<<static_cast<unsigned>(m / kWordRows),
                         dim3(kLanes, kWordRows), 0, stream>>>(
        packed, scales, out, n_workers, static_cast<size_t>(m));
  return finish();
}

// c2 [rows, chunk] -> vals bf16 [rows, k], idx int16 [rows, k], state
// [rows, chunk]; 1 <= k <= chunk <= 32768 (the wrapper checks)
int topk_encode(const float* c2, __nv_bfloat16* vals, int16_t* idx,
                float* state, long long rows, int chunk, int k,
                cudaStream_t stream) {
  // the winners' list: k entries, or k rounded up to a power of two for the
  // bitonic sort
  int list_len = k;
  if (k > kRankSortMax) {
    list_len = 1;
    while (list_len < k) list_len <<= 1;
  }
  const size_t smem = static_cast<size_t>(chunk + (chunk - 1) / 32 + 1) * 4 +
                      kSelBins * 4 + static_cast<size_t>(list_len) * 2;
  const int vec4 = chunk % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(c2) |
                     reinterpret_cast<uintptr_t>(state)) & 15) == 0;
  if (const int rc = allow_smem(topk_encode_kernel, smem)) return rc;
  if (rows > 0)
    topk_encode_kernel<<<static_cast<unsigned>(rows), kTopkThreads, smem,
                         stream>>>(c2, vals, idx, state, chunk, k, list_len,
                                   vec4);
  return finish();
}

// vals bf16 / idx int16 [W, rows, k] -> out [rows * chunk]
int topk_decode(const __nv_bfloat16* vals, const int16_t* idx, float* out,
                int n_workers, long long rows, int k, int chunk, int size,
                cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(chunk) * 4;
  if (const int rc = allow_smem(topk_decode_kernel, smem)) return rc;
  if (rows > 0)
    topk_decode_kernel<<<static_cast<unsigned>(rows), kTopkThreads, smem,
                         stream>>>(vals, idx, out, n_workers,
                                   static_cast<size_t>(rows), k, chunk, size);
  return finish();
}

}  // extern "C"
