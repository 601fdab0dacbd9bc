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
//   * A tile is whole pixel rows, so no window crosses a tile.
//   * Each thread owns VEC consecutive channels of a row (8 bf16 or 4 f32:
//     one 16-byte vector).  It reads them as one vector and the n/2
//     neighbours on each side (one load a side where n/2 is a power of two),
//     and stores its VEC results as one 16-byte vector.  The math is f32.
//   * Channel counts that are not a multiple of VEC, or unaligned tensors,
//     run the same kernels with VEC = 1.
//
// B1 (forward): one block a tile, copied into shared memory 16 bytes a
// thread; the window of x^2 slides over it in registers.
//
// B2 (backward).  Its first design was B1's: one tile a block, a plain copy,
// s and t of the whole tile written to shared memory, both phases reading
// them back.  It reached half its bound (51% at AlexNet's shapes, 47% at
// GoogLeNet's), held back by three things: no bytes in flight while a block
// computed (each block copied, waited and computed once; HBM3 needs ~15-20
// KB in flight an SM at all times), shared memory carrying what registers
// could hold (24 KB a bf16 tile, which limited the blocks an SM held), and
// an IEEE division and an integer division an element.  The design now:
//
//   * Persistent grid: SMs x resident blocks, each walking the tiles
//     blockIdx.x, blockIdx.x + gridDim.x, ...  A tile is kBwdTile = 2048
//     elements of whole rows (8 a thread); each thread's (row, channel) in a
//     tile is computed once, before the loop.
//   * A 2-stage ring of x and dy in shared memory, filled by 1-D bulk copies
//     (cp.async.bulk ... mbarrier::complete_tx::bytes, SASS UBLKCP) that one
//     thread issues: tile i+1 is in flight while tile i is computed (8 KB a
//     block in bf16, 4 blocks an SM).  Deeper rings (3 or 4 stages, or the
//     next copy issued earlier) measured slower at AlexNet's and GoogLeNet's
//     shapes on an H100, by 2-5%.  A bulk copy spends no thread's registers
//     or instructions on addresses, and its barrier wait needs no
//     __syncthreads; a tile in the vector path is whole 16-byte multiples
//     at 16-byte-aligned addresses, so it always qualifies, and the short
//     last tile is copied by its real byte count.  The VEC = 1 path keeps a
//     plain copy into one stage (correct, not fast).
//   * Registers, not shared memory, for what a thread owns: phase 1 keeps
//     its x, dy and s; only t, whose neighbours other threads read, goes to
//     shared memory (f32, double-buffered by tile parity, so one
//     __syncthreads a tile orders both the t buffers and the ring: a stage
//     is refilled only once every thread is past phase 1 of its tile).  In
//     bf16 a thread's 8 values of t are stored as two planes of float4s, so
//     a warp's accesses meet no bank conflict (see store_t).
//   * No division: for beta = 0.75, inv = rsqrt(d), s = inv * sqrt(inv) (as
//     _scale_of, lrn.py:62, in the approximate MUFU forms), and s/d = s *
//     inv^2; any other beta takes s = exp(-beta log d) and s/d = s *
//     __frcp_rn(d).
//   * Each window is summed once and then slid: out[i] = out[i-1] +
//     (v[i+2h] - v[i-1]) across a thread's VEC outputs.
//
// The output is in the input's type.  No atomics: a rerun is bit-equal.
//
// Each C entry launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  n/2 may be 0..4 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// forward tile: kThreads*VEC*2 elements (8 KB of x)
constexpr int kFwdChunksPerThread = 2;
// backward tile: 8 elements a thread in every type and VEC; a ring of
// kBwdStages (x, dy) tiles in their type, then two f32 tiles of t
constexpr int kBwdElemsPerThread = 8;
constexpr int kBwdTile = kThreads * kBwdElemsPerThread;
constexpr int kBwdStages = 2;
constexpr int kMaxDevices = 64;

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

// ---------------------------------------------------------------------------
// B2's pieces: the ring's barriers and bulk copies, the division-free scale,
// vector halos, sliding window sums
// ---------------------------------------------------------------------------

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

// `bytes` (a multiple of 16) of contiguous global memory into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// MUFU forms: d >= k > 0 is never a denormal, and the approximations' few
// ulps are far inside the gradient's tolerance
__device__ __forceinline__ float rsqrt_approx(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float sqrt_approx(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// s = d^-beta and s/d without a division.
__device__ __forceinline__ void scale_and_ratio(float d, float beta, int b075,
                                                float& s, float& s_over_d) {
  if (b075) {
    const float inv = rsqrt_approx(d);
    s = inv * sqrt_approx(inv);
    s_over_d = s * (inv * inv);
  } else {
    s = expf(-beta * logf(d));
    s_over_d = s * __frcp_rn(d);
  }
}

// load_window's w, for rows whose C is a multiple of VEC: each side's halo
// then lies wholly inside the row or wholly outside it, and a power-of-two
// HALF reads it as one aligned load.
template <typename T, int VEC, int HALF>
__device__ __forceinline__ void load_window_vec(const T* row, int c0, int C,
                                                float* w) {
  static_assert(HALF <= 4, "n/2 is 0..4");
  // HALF <= 4 <= VEC: a power-of-two halo is one aligned Pack
  constexpr bool kPacked = VEC > 1 && HALF > 0 && (HALF & (HALF - 1)) == 0;
  if constexpr (!kPacked) {
    load_window<T, VEC, HALF>(row, c0, C, w);
  } else {
    using H = Pack<T, HALF>;
    load_own<T, VEC>(row, c0, w + HALF);
    const bool left = c0 > 0, right = c0 + VEC < C;
    H l, r;
    if (left) l = *reinterpret_cast<const H*>(row + c0 - HALF);
    if (right) r = *reinterpret_cast<const H*>(row + c0 + VEC);
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      w[j] = left ? to_f32(l.v[j]) : 0.f;
      w[VEC + HALF + j] = right ? to_f32(r.v[j]) : 0.f;
    }
  }
}

// window_sums, with the first window summed and then slid one channel at a
// time: out[i] = out[i-1] + (v[i + 2*HALF] - v[i-1]).
template <int VEC, int HALF>
__device__ __forceinline__ void sliding_sums(const float* v, float* out) {
  if constexpr (HALF == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = v[i];
    return;
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j <= 2 * HALF; ++j) s += v[j];
  out[0] = s;
#pragma unroll
  for (int i = 1; i < VEC; ++i) {
    s += v[i + 2 * HALF] - v[i - 1];
    out[i] = s;
  }
}

// Where t lives in shared memory.  Thread vector v's VEC values of t sit at
// v * VEC of a contiguous tile, except for VEC = 8: there a warp's 16-byte
// accesses would fall 32 bytes apart (two-way bank conflicts), so the tile
// is split into two planes, channels 0-3 of every vector in the first and
// 4-7 in the second, each plane's float4s contiguous by vector.  A vector's
// left halo (the last n/2 values of the vector before it) is then in the
// second plane just below its own, and its right halo in the first plane
// just above.
// (st.shared.v4 spelled out: nvcc split a float4 store of these values into
// four scalar stores)
__device__ __forceinline__ void sts128(float* p, float a, float b, float c,
                                       float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(smem_addr(p)),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

template <int VEC>
__device__ __forceinline__ void store_t(float* ts, int v, const float* t) {
  if constexpr (VEC == 8) {
    sts128(ts + 4 * v, t[0], t[1], t[2], t[3]);
    sts128(ts + kBwdTile / 2 + 4 * v, t[4], t[5], t[6], t[7]);
  } else {
    store_f32<VEC>(ts + v * VEC, t);
  }
}

// load_window_vec's w over t, for thread vector v at channel c0.
template <int VEC, int HALF>
__device__ __forceinline__ void load_t_window(const float* ts, int v, int c0,
                                              int C, float* w) {
  if constexpr (VEC != 8) {
    load_window_vec<float, VEC, HALF>(ts + v * VEC - c0, c0, C, w);
  } else {
    const float* a = ts + 4 * v;                  // channels c0 .. c0 + 3
    const float* b = ts + kBwdTile / 2 + 4 * v;   // c0 + 4 .. c0 + 7
    const float4 lo = *reinterpret_cast<const float4*>(a);
    const float4 hi = *reinterpret_cast<const float4*>(b);
    w[HALF] = lo.x, w[HALF + 1] = lo.y, w[HALF + 2] = lo.z, w[HALF + 3] = lo.w;
    w[HALF + 4] = hi.x, w[HALF + 5] = hi.y, w[HALF + 6] = hi.z;
    w[HALF + 7] = hi.w;
    const bool left = c0 > 0, right = c0 + VEC < C;
    if constexpr (HALF > 0 && (HALF & (HALF - 1)) == 0) {
      using H = Pack<float, HALF>;
      H l, r;
      if (left) l = *reinterpret_cast<const H*>(b - HALF);
      if (right) r = *reinterpret_cast<const H*>(a + 4);
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        w[j] = left ? l.v[j] : 0.f;
        w[VEC + HALF + j] = right ? r.v[j] : 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        w[j] = left ? b[j - HALF] : 0.f;
        w[VEC + HALF + j] = right ? a[4 + j] : 0.f;
      }
    }
  }
}

// Shared memory of B2: `stages` (x, dy) tiles in T, two f32 tiles of t, one
// mbarrier a stage.
template <typename T>
__host__ __device__ constexpr size_t bwd_smem_bytes(int stages) {
  return 2 * static_cast<size_t>(stages) * kBwdTile * sizeof(T) +
         2 * static_cast<size_t>(kBwdTile) * 4 + 8 * static_cast<size_t>(stages);
}

// B2.  ASYNC: x and dy through the kBwdStages ring of bulk copies; else a
// plain copy into one stage (the VEC = 1 path).
template <typename T, int VEC, int HALF, bool ASYNC>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   T* __restrict__ dx, int64_t rows, int C, int tile_rows,
                   float k, float a_n, float c2b, float beta, int b075) {
  constexpr int NV = kBwdElemsPerThread / VEC;   // vectors a thread owns
  constexpr int S = ASYNC ? kBwdStages : 1;
  constexpr int W = VEC + 2 * HALF;
  extern __shared__ __align__(16) unsigned char smem[];
  // stage st: x at st * 2 * kBwdTile elements, dy after it
  T* ring = reinterpret_cast<T*>(smem);
  float* tbuf = reinterpret_cast<float*>(smem + 2 * S * kBwdTile * sizeof(T));
  uint64_t* bars = reinterpret_cast<uint64_t*>(tbuf + 2 * kBwdTile);

  const int per_row = C / VEC;
  const int64_t ntiles = (rows + tile_rows - 1) / tile_rows;
  const int mine = static_cast<int>(
      (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  // the thread's vectors: row r[q] (tile_rows when it has none), channel c0[q]
  int r[NV], c0[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int v = threadIdx.x + q * kThreads;
    r[q] = v < tile_rows * per_row ? v / per_row : tile_rows;
    c0[q] = v < tile_rows * per_row ? (v - r[q] * per_row) * VEC : 0;
  }
  auto tile_row0 = [&](int i) -> int64_t {
    return (static_cast<int64_t>(i) * gridDim.x + blockIdx.x) * tile_rows;
  };

  // thread 0: the i-th tile of this block into its stage, x and dy by one
  // barrier, expecting both copies' real bytes
  auto issue = [&](int i) {
    const int64_t row0 = tile_row0(i);
    const uint32_t bytes = static_cast<uint32_t>(
        rows_in_tile(rows, row0, tile_rows) * C * sizeof(T));
    const int st = i % S;
    const uint32_t bar = smem_addr(bars + st);
    mbar_expect(bar, 2 * bytes);
    bulk_load(smem_addr(ring + st * 2 * kBwdTile), x + row0 * C, bytes, bar);
    bulk_load(smem_addr(ring + (st * 2 + 1) * kBwdTile), dy + row0 * C, bytes,
              bar);
  };
  if constexpr (ASYNC) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int st = 0; st < S; ++st) mbar_init(smem_addr(bars + st), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int i = 0; i < S - 1 && i < mine; ++i) issue(i);
    }
    __syncthreads();
  }

  for (int i = 0; i < mine; ++i) {
    const int st = i % S;
    const T* xs = ring + st * 2 * kBwdTile;
    const T* gs = xs + kBwdTile;
    const int64_t row0 = tile_row0(i);
    const int nrows = rows_in_tile(rows, row0, tile_rows);
    if constexpr (ASYNC) {
      // stage (i-1) % S is free: every thread passed phase 1 of tile i-1
      if (threadIdx.x == 0 && i + S - 1 < mine) issue(i + S - 1);
      mbar_wait(smem_addr(bars + st), (i / S) & 1);
    } else {
      copy_tile<T, VEC>(x + row0 * C, ring, nrows * C);
      copy_tile<T, VEC>(dy + row0 * C, ring + kBwdTile, nrows * C);
      __syncthreads();
    }
    float* ts = tbuf + (i & 1) * kBwdTile;

    // phase 1: s and t of the thread's own elements; x, dy, s stay here
    float xr[NV][VEC], gr[NV][VEC], sr[NV][VEC];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      if (r[q] >= nrows) continue;
      float w[W], sq[W], ssum[VEC], t[VEC];
      load_window_vec<T, VEC, HALF>(xs + r[q] * C, c0[q], C, w);
      load_own<T, VEC>(gs, r[q] * C + c0[q], gr[q]);
#pragma unroll
      for (int j = 0; j < W; ++j) sq[j] = w[j] * w[j];
      sliding_sums<VEC, HALF>(sq, ssum);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float s_over_d;
        scale_and_ratio(k + a_n * ssum[e], beta, b075, sr[q][e], s_over_d);
        xr[q][e] = w[HALF + e];
        t[e] = gr[q][e] * xr[q][e] * s_over_d;
      }
      store_t<VEC>(ts, threadIdx.x + q * kThreads, t);
    }
    __syncthreads();

    // phase 2: the window of the neighbours' t
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      if (r[q] >= nrows) continue;
      float tw[W], back[VEC];
      load_t_window<VEC, HALF>(ts, threadIdx.x + q * kThreads, c0[q], C, tw);
      sliding_sums<VEC, HALF>(tw, back);
      Pack<T, VEC> out;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        out.v[e] = from_f32<T>(
            fmaf(-c2b * xr[q][e], back[e], sr[q][e] * gr[q][e]));
      *reinterpret_cast<Pack<T, VEC>*>(dx + (row0 + r[q]) * C + c0[q]) = out;
    }
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

// dynamic shared memory past the default 48 KB needs the opt-in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int VEC, int HALF, bool ASYNC>
int launch_bwd_half(const T* x, const T* dy, T* dx, int64_t rows, int C,
                    int tr, float k, float a_n, float c2b, float beta,
                    int b075, cudaStream_t stream) {
  const auto kernel = lrn_bwd_kernel<T, VEC, HALF, ASYNC>;
  constexpr size_t smem = bwd_smem_bytes<T>(ASYNC ? kBwdStages : 1);
  cudaError_t rc = allow_smem(kernel, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // the persistent grid: SMs x resident blocks of this instantiation, read
  // from the device once for each
  static int resident[kMaxDevices] = {};
  int dev = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(rc);
  int blocks = dev < kMaxDevices ? resident[dev] : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev)) != cudaSuccess ||
        (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return static_cast<int>(rc);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) resident[dev] = blocks;
  }
  const int64_t ntiles = (rows + tr - 1) / tr;
  const unsigned grid =
      static_cast<unsigned>(ntiles < blocks ? ntiles : blocks);
  kernel<<<grid, kThreads, smem, stream>>>(x, dy, dx, rows, C, tr, k, a_n, c2b,
                                           beta, b075);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_bwd_vec(const T* x, const T* dy, T* dx, int64_t rows, int C,
                   int half, float k, float a_n, float c2b, float beta,
                   int b075, cudaStream_t stream) {
  const int tr = tile_rows_for(C, kBwdTile);
#define LRN_BWD(H)                                                        \
  return launch_bwd_half<T, VEC, H, (VEC > 1)>(x, dy, dx, rows, C, tr, k, \
                                               a_n, c2b, beta, b075, stream)
  switch (half) {
    case 0: LRN_BWD(0);
    case 1: LRN_BWD(1);
    case 2: LRN_BWD(2);
    case 3: LRN_BWD(3);
    case 4: LRN_BWD(4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LRN_BWD
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
