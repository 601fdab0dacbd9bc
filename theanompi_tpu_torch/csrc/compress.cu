// Onebit compressed-wire kernels for Hopper (sm_90a): sign pack (B3),
// weighted decode (B4), fused encode (B5) and residual (B6).
//
// Replace the TPU kernels of theanompi_tpu/ops/compress.py:
//   B3 pack_signs           <- _pack_pallas        (compress.py:200)
//   B4 unpack_signs_wsum    <- _unpack_wsum_pallas (compress.py:234)
//   B5 pack_signs_encode    <- _encode_pallas      (compress.py:268)
//   B6 signed_residual      <- _residual_pallas    (compress.py:307)
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

}  // extern "C"
