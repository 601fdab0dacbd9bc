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
#include <limits.h>
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
// B7, encode.  Oracle topk_encode_jnp: slots in descending |c|, the lower
// offset first on ties (lax.top_k), values rounded to bf16 to nearest
// even, and the state is c with v - float(bf16(v)) written at each
// selected offset.  One block of 256 threads per row; the row sits in
// shared memory (chunk floats) with one "taken" bit per element.  Thread t
// owns the elements t, t + 256, ... and keeps in registers the best
// (|c|, offset) among its untaken ones.  Each of the k passes is one
// block-wide argmax over those 256 candidates (warp shuffles, then the 8
// warp winners through shared memory, double-buffered so one barrier per
// pass suffices); the winner's owner alone writes the slot, the residual
// and the taken bit, and rescans its own elements.  A taken element never
// competes again, whatever its residual (an all-zero row would otherwise
// pick offset 0 k times).  Comparisons on (|c| desc, offset asc) equal the
// stable descending sort of the plain version.
//
// Bound: the row is read once and the state written once (8 bytes per
// element); the k passes add k block reductions per row, latency that the
// other resident blocks of the SM hide in part.  This simple design
// serializes the passes within a row; a radix select on the float bits is
// the faster design a later change can take.
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

// (va, ia) before (vb, ib): larger magnitude, then lower offset
__device__ __forceinline__ bool ahead(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// best untaken (|row[j]|, j) over the elements j = t, t + 256, ...
__device__ __forceinline__ void rescan(const float* row, const uint32_t* taken,
                                       int chunk, int t, float& bv, int& bi) {
  bv = -1.f;                     // below every |c|: some element stays untaken
  bi = INT_MAX;
  for (int j = t; j < chunk; j += kTopkThreads) {
    if ((taken[j >> 5] >> (j & 31)) & 1u) continue;
    const float a = fabsf(row[j]);
    if (a > bv) {                // strict: the lowest offset among equals
      bv = a;
      bi = j;
    }
  }
}

__global__ void __launch_bounds__(kTopkThreads)
topk_encode_kernel(const float* __restrict__ c2, __nv_bfloat16* __restrict__ vals,
                   int16_t* __restrict__ idx, float* __restrict__ state,
                   int chunk, int k) {
  extern __shared__ float smem[];
  float* row = smem;                                         // [chunk]
  uint32_t* taken = reinterpret_cast<uint32_t*>(smem + chunk);  // [chunk/32]
  __shared__ float wv[2][kTopkWarps];
  __shared__ int wi[2][kTopkWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * chunk;
  const size_t slot0 = static_cast<size_t>(blockIdx.x) * k;
  for (int j = t; j < chunk; j += kTopkThreads) row[j] = c2[base + j];
  for (int j = t; j < (chunk + 31) / 32; j += kTopkThreads) taken[j] = 0u;
  __syncthreads();
  float bv;
  int bi;
  rescan(row, taken, chunk, t, bv, bi);
  for (int s = 0; s < k; ++s) {
    float v = bv;
    int i = bi;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, i, o);
      if (ahead(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    // buffer s & 1 is rewritten only at pass s + 2, after every thread
    // passed pass s + 1's barrier, so it has read this pass's entries
    const int b = s & 1;
    if (lane == 0) {
      wv[b][warp] = v;
      wi[b][warp] = i;
    }
    __syncthreads();
    v = wv[b][0];
    i = wi[b][0];
#pragma unroll
    for (int w = 1; w < kTopkWarps; ++w)
      if (ahead(wv[b][w], wi[b][w], v, i)) {
        v = wv[b][w];
        i = wi[b][w];
      }
    if ((i & (kTopkThreads - 1)) == t) {       // this thread owns the winner
      const float x = row[i];
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      vals[slot0 + s] = h;
      idx[slot0 + s] = static_cast<int16_t>(i);
      row[i] = __fsub_rn(x, __bfloat162float(h));
      taken[i >> 5] |= 1u << (i & 31);
      rescan(row, taken, chunk, t, bv, bi);
    }
  }
  __syncthreads();
  for (int j = t; j < chunk; j += kTopkThreads) state[base + j] = row[j];
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
  const size_t smem = (static_cast<size_t>(chunk) + (chunk + 31) / 32) * 4;
  if (const int rc = allow_smem(topk_encode_kernel, smem)) return rc;
  if (rows > 0)
    topk_encode_kernel<<<static_cast<unsigned>(rows), kTopkThreads, smem,
                         stream>>>(c2, vals, idx, state, chunk, k);
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
