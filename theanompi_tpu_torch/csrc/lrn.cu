// Cross-channel LRN forward (B1) and backward (B2) for Hopper (sm_90a).
//
// Replaces the TPU kernels of theanompi_tpu/ops/lrn.py: _lrn_fwd_pallas
// (lrn.py:130, pallas_call at :134) and _lrn_bwd_pallas (lrn.py:152,
// pallas_call at :159).  Same math, over NHWC pixel rows of C channels:
//
//     d  = k + (alpha/n) * BandSum(x^2)      s = d^-beta      y = x * s
//     t  = dy * x * s / d
//     dx = s * dy - 2 (alpha/n) beta * x * BandSum(t)
//
// BandSum at channel c sums channels max(0, c-n/2) .. min(C-1, c+n/2), the
// window of _band_np (lrn.py:54), truncated at both channel edges.
//
// Bound: device-memory bytes.  Forward reads x and writes y, backward reads x
// and dy and writes dx; in bf16 that is 4 or 6 bytes per element against
// ~15-35 flops, two orders of magnitude under the ~295 flop/byte at which an
// H100's compute would start to limit.  So the design aims at one pass over
// device memory and little work per element:
//
//   * The TPU kernels summed the window as a matmul against a C x C band
//     matrix on the MXU (C/n times the needed work).  Here each output sums
//     its 2*(n/2)+1 taps directly.
//   * One block takes a tile of whole pixel rows, so no window crosses a
//     block.  The tile is copied into shared memory as it is, 16 bytes a
//     thread.
//   * Each thread then owns VEC consecutive channels of a row (8 bf16 or 4
//     f32: one 16-byte vector).  It reads them as one vector and only the
//     n/2 neighbours on each side one by one, slides the window over them in
//     registers (n/2 is a template parameter, so the window is unrolled),
//     and stores its VEC results as one 16-byte vector.  The math is f32.
//   * Backward needs each neighbour's t, and each t needs that neighbour's
//     d: phase 1 writes s and t of the whole tile to shared memory,
//     __syncthreads(), phase 2 slides the window over t the same way.
//   * Channel counts that are not a multiple of VEC, or unaligned tensors,
//     run the same kernel with VEC = 1.
//
// d^-0.75 is rsqrt(d) * sqrt(rsqrt(d)), as _scale_of (lrn.py:62); any other
// beta uses exp(-beta * log d).  The output is in the input's type.
//
// Each C entry launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  n/2 may be 0..4 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// tile elements: forward kThreads*VEC*2 (8 KB of x), backward kThreads*VEC
// (x, dy in their type + s, t in f32: 24 KB in bf16, 16 KB in f32)
constexpr int kFwdChunksPerThread = 2;
constexpr int kBwdChunksPerThread = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC values of T moved as one load or store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__host__ __device__ __forceinline__ size_t align16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

template <typename T, int VEC>
__device__ __forceinline__ void copy_tile(const T* __restrict__ src,
                                          T* __restrict__ dst, int n) {
  using P = Pack<T, VEC>;
  const P* s = reinterpret_cast<const P*>(src);
  P* d = reinterpret_cast<P*>(dst);
  for (int v = threadIdx.x; v < n / VEC; v += blockDim.x) d[v] = s[v];
}

// VEC f32 values at p (16-byte aligned when VEC % 4 == 0).
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = f.x, out[4 * q + 1] = f.y;
      out[4 * q + 2] = f.z, out[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = p[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* in) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(in[4 * q], in[4 * q + 1], in[4 * q + 2], in[4 * q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = in[i];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_own(const T* row, int c0, float* out) {
  const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(row + c0);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(p.v[i]);
}

// w[j] = row[c0 - HALF + j] for j < VEC + 2*HALF, 0 outside [0, C): the
// thread's VEC channels as one vector, the halo one by one.  Zeros add
// nothing to a window sum, which is exactly the truncated window.
template <typename T, int VEC, int HALF>
__device__ __forceinline__ void load_window(const T* row, int c0, int C,
                                            float* w) {
  load_own<T, VEC>(row, c0, w + HALF);
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const int cl = c0 - HALF + j, cr = c0 + VEC + j;
    w[j] = cl >= 0 ? to_f32(row[cl]) : 0.f;
    w[VEC + HALF + j] = cr < C ? to_f32(row[cr]) : 0.f;
  }
}

template <int VEC, int HALF>
__device__ __forceinline__ void load_window_f32(const float* row, int c0,
                                                int C, float* w) {
  load_f32<VEC>(row + c0, w + HALF);
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const int cl = c0 - HALF + j, cr = c0 + VEC + j;
    w[j] = cl >= 0 ? row[cl] : 0.f;
    w[VEC + HALF + j] = cr < C ? row[cr] : 0.f;
  }
}

// out[i] = sum of v[i .. i + 2*HALF], lowest channel first.
template <int VEC, int HALF>
__device__ __forceinline__ void window_sums(const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j <= 2 * HALF; ++j) s += v[i + j];
    out[i] = s;
  }
}

__device__ __forceinline__ float scale_of(float d, float beta, int b075) {
  if (b075) {
    const float inv = rsqrtf(d);
    return inv * sqrtf(inv);
  }
  return expf(-beta * logf(d));
}

// Rows of the tile starting at row0 (the last tile may be short).
__device__ __forceinline__ int rows_in_tile(int64_t rows, int64_t row0,
                                            int tile_rows) {
  const int64_t left = rows - row0;
  return left < tile_rows ? static_cast<int>(left) : tile_rows;
}

template <typename T, int VEC, int HALF>
__global__ void __launch_bounds__(kThreads)
    lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                   int C, int tile_rows, float k, float a_n, float beta,
                   int b075) {
  constexpr int W = VEC + 2 * HALF;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int n = rows_in_tile(rows, row0, tile_rows) * C;
  const int per_row = C / VEC;

  copy_tile<T, VEC>(x + row0 * C, xs, n);
  __syncthreads();
  Pack<T, VEC>* yv = reinterpret_cast<Pack<T, VEC>*>(y + row0 * C);
  for (int v = threadIdx.x; v < n / VEC; v += blockDim.x) {
    const int r = v / per_row, c0 = (v - r * per_row) * VEC;
    float w[W], sq[W], ssum[VEC];
    load_window<T, VEC, HALF>(xs + r * C, c0, C, w);
#pragma unroll
    for (int j = 0; j < W; ++j) sq[j] = w[j] * w[j];
    window_sums<VEC, HALF>(sq, ssum);
    Pack<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = k + a_n * ssum[i];
      out.v[i] = from_f32<T>(w[HALF + i] * scale_of(d, beta, b075));
    }
    yv[v] = out;
  }
}

template <typename T, int VEC, int HALF>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   T* __restrict__ dx, int64_t rows, int C, int tile_rows,
                   float k, float a_n, float c2b, float beta, int b075) {
  constexpr int W = VEC + 2 * HALF;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = tile_rows * C;
  const size_t tb = align16(tile * sizeof(T)), fb = align16(tile * 4);
  T* xs = reinterpret_cast<T*>(smem);                         // x
  T* gs = reinterpret_cast<T*>(smem + tb);                    // dy
  float* ss = reinterpret_cast<float*>(smem + 2 * tb);        // s = d^-beta
  float* ts = reinterpret_cast<float*>(smem + 2 * tb + fb);   // dy x s / d
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int n = rows_in_tile(rows, row0, tile_rows) * C;
  const int per_row = C / VEC;

  copy_tile<T, VEC>(x + row0 * C, xs, n);
  copy_tile<T, VEC>(dy + row0 * C, gs, n);
  __syncthreads();
  // phase 1: s and t of every element of the tile
  for (int v = threadIdx.x; v < n / VEC; v += blockDim.x) {
    const int r = v / per_row, c0 = (v - r * per_row) * VEC;
    const int e0 = r * C + c0;
    float w[W], sq[W], ssum[VEC], g[VEC], s[VEC], t[VEC];
    load_window<T, VEC, HALF>(xs + r * C, c0, C, w);
    load_own<T, VEC>(gs, e0, g);
#pragma unroll
    for (int j = 0; j < W; ++j) sq[j] = w[j] * w[j];
    window_sums<VEC, HALF>(sq, ssum);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = k + a_n * ssum[i];
      s[i] = scale_of(d, beta, b075);
      t[i] = g[i] * w[HALF + i] * s[i] / d;
    }
    store_f32<VEC>(ss + e0, s);
    store_f32<VEC>(ts + e0, t);
  }
  __syncthreads();
  // phase 2: the window of the neighbours' t
  Pack<T, VEC>* dxv = reinterpret_cast<Pack<T, VEC>*>(dx + row0 * C);
  for (int v = threadIdx.x; v < n / VEC; v += blockDim.x) {
    const int r = v / per_row, c0 = (v - r * per_row) * VEC;
    const int e0 = r * C + c0;
    float tw[W], back[VEC], xv[VEC], g[VEC], s[VEC];
    load_window_f32<VEC, HALF>(ts + r * C, c0, C, tw);
    window_sums<VEC, HALF>(tw, back);
    load_own<T, VEC>(xs, e0, xv);
    load_own<T, VEC>(gs, e0, g);
    load_f32<VEC>(ss + e0, s);
    Pack<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      out.v[i] = from_f32<T>(s[i] * g[i] - c2b * xv[i] * back[i]);
    dxv[v] = out;
  }
}

inline int tile_rows_for(int C, int tile_elems) {
  const int r = tile_elems / C;
  return r > 0 ? r : 1;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int VEC>
int launch_fwd_vec(const T* x, T* y, int64_t rows, int C, int half, float k,
                   float a_n, float beta, int b075, cudaStream_t stream) {
  const int tr = tile_rows_for(C, kThreads * VEC * kFwdChunksPerThread);
  const unsigned blocks = static_cast<unsigned>((rows + tr - 1) / tr);
  const size_t smem = align16(static_cast<size_t>(tr) * C * sizeof(T));
#define LRN_FWD(H)                                                 \
  lrn_fwd_kernel<T, VEC, H><<<blocks, kThreads, smem, stream>>>( \
      x, y, rows, C, tr, k, a_n, beta, b075)
  switch (half) {
    case 0: LRN_FWD(0); break;
    case 1: LRN_FWD(1); break;
    case 2: LRN_FWD(2); break;
    case 3: LRN_FWD(3); break;
    case 4: LRN_FWD(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LRN_FWD
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_bwd_vec(const T* x, const T* dy, T* dx, int64_t rows, int C,
                   int half, float k, float a_n, float c2b, float beta,
                   int b075, cudaStream_t stream) {
  const int tr = tile_rows_for(C, kThreads * VEC * kBwdChunksPerThread);
  const unsigned blocks = static_cast<unsigned>((rows + tr - 1) / tr);
  const size_t tile = static_cast<size_t>(tr) * C;
  const size_t smem = 2 * align16(tile * sizeof(T)) + 2 * align16(tile * 4);
#define LRN_BWD(H)                                                 \
  lrn_bwd_kernel<T, VEC, H><<<blocks, kThreads, smem, stream>>>( \
      x, dy, dx, rows, C, tr, k, a_n, c2b, beta, b075)
  switch (half) {
    case 0: LRN_BWD(0); break;
    case 1: LRN_BWD(1); break;
    case 2: LRN_BWD(2); break;
    case 3: LRN_BWD(3); break;
    case 4: LRN_BWD(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LRN_BWD
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* x, void* y, int64_t rows, int C, int half, float k,
               float a_n, float beta, int b075, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (C % V == 0 && aligned16(x) && aligned16(y))
    return launch_fwd_vec<T, V>(xp, yp, rows, C, half, k, a_n, beta, b075,
                                stream);
  return launch_fwd_vec<T, 1>(xp, yp, rows, C, half, k, a_n, beta, b075,
                              stream);
}

template <typename T>
int launch_bwd(const void* x, const void* dy, void* dx, int64_t rows, int C,
               int half, float k, float a_n, float c2b, float beta, int b075,
               cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  if (C % V == 0 && aligned16(x) && aligned16(dy) && aligned16(dx))
    return launch_bwd_vec<T, V>(xp, dyp, dxp, rows, C, half, k, a_n, c2b,
                                beta, b075, stream);
  return launch_bwd_vec<T, 1>(xp, dyp, dxp, rows, C, half, k, a_n, c2b,
                              beta, b075, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  rows * C elements, rows contiguous.
extern "C" int lrn_fwd(const void* x, void* y, long long rows, int C,
                       int dtype, int half, float k, float a_n, float beta,
                       int b075, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  return dtype == 1 ? launch_fwd<__nv_bfloat16>(x, y, rows, C, half, k, a_n,
                                                beta, b075, s)
                    : launch_fwd<float>(x, y, rows, C, half, k, a_n, beta,
                                        b075, s);
}

extern "C" int lrn_bwd(const void* x, const void* dy, void* dx,
                       long long rows, int C, int dtype, int half, float k,
                       float a_n, float c2b, float beta, int b075,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  return dtype == 1 ? launch_bwd<__nv_bfloat16>(x, dy, dx, rows, C, half, k,
                                                a_n, c2b, beta, b075, s)
                    : launch_bwd<float>(x, dy, dx, rows, C, half, k, a_n,
                                        c2b, beta, b075, s);
}
