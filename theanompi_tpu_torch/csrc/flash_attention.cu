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
// Bound.  At the LM's shapes ([16, 8, 512, 64], causal) each kernel reads and
// writes 34-51 MB and does 4.3-8.6 GFLOP: ~10-15 us of device memory against
// ~4-9 us of bf16 tensor-core time at the card's peaks, so the bytes bound
// them on paper.  This first version is not near either: it is written to be
// right and simple.
//
// Design.  One block of 4 warps per (64-row tile, b*h); each warp owns 16 rows
// of the block's tile.  Tiles come from device memory into shared memory
// (16 bytes a thread, rows padded by 16 bytes so ldmatrix-style fragment loads
// do not collide in banks).  Products run on the tensor cores through
// nvcuda::wmma (m16n16k16, bf16 in, f32 accumulate).  Scores go through a
// shared f32 scratch, where each warp runs the softmax over its own rows, one
// row at a time, a lane per two columns (warp shuffles for the row max and
// sum).  The outputs' f32 sums live in wmma accumulator fragments for the
// whole loop; B10 rescales them by exp(m_old - m_new) per row by multiplying
// with a fragment loaded from a 16x16 tile of that row factor (fragments of
// one type map elements alike).  The causal loop skips tiles above the
// diagonal and masks only the diagonal tile; row 0 always has one valid key,
// so l > 0 and the finite mask keeps exp from ever seeing inf - inf.  Blocks
// with the most tiles start first.
//
// Inputs may be strided views (the model hands q, k, v as the transpose of a
// [B, T, H, D] product): each tensor comes with its B, H and T strides in
// elements; the last dim is contiguous and every stride a multiple of 8 (the
// wrapper checks).  Outputs are written through their strides the same way.
// Head dims 32, 64 and 128; T a multiple of 64.  Each C entry launches on the
// caller's stream, allocates nothing, and returns the CUDA error of the
// launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                  // rows of a q or k/v tile
constexpr int kWarps = 4;                  // a warp owns 16 rows of the tile
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;                    // bf16 row padding (16 bytes)
constexpr float kMask = -0.7f * 3.402823466e38f;   // DEFAULT_MASK_VALUE
constexpr unsigned kFull = 0xffffffffu;

struct Strided {                           // element strides of [B, H, T, D]
  long long b, h, t;
};

template <int D>
struct Cfg {
  static constexpr int kQLd = D + kPad;                      // bf16 tile rows
  static constexpr int kPLd = kTile + kPad;                  // bf16 64-wide rows
  static constexpr int kSLd = (D > kTile ? D : kTile) + 4;   // f32 scratch rows
  static constexpr size_t kTileBytes = sizeof(bf16) * kTile * kQLd;
  static constexpr size_t kPBytes = sizeof(bf16) * kTile * kPLd;
  static constexpr size_t kSBytes = sizeof(float) * kTile * kSLd;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// 64 rows x D of src (rows st elements apart) into dst (rows kQLd apart),
// 16 bytes a thread, all threads of the block.
template <int D>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          long long st, bf16* dst) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * Cfg<D>::kQLd + col) =
        *reinterpret_cast<const uint4*>(src + r * st + col);
  }
}

// 64 floats of a [B, H, T] row-stat tensor into shared memory.
__device__ __forceinline__ void load_stat(const float* __restrict__ src,
                                          float* dst) {
  if (threadIdx.x < kTile) dst[threadIdx.x] = src[threadIdx.x];
}

// The warp's 16 x D f32 rows of src (rows kSLd apart) to bf16 rows of dst
// (rows st elements apart), 8 values (16 bytes) a lane.
template <int D>
__device__ __forceinline__ void store_rows(const float* src, bf16* dst,
                                           long long st, int lane) {
  constexpr int kChunks = D / 8;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const float* s = src + r * Cfg<D>::kSLd + col;
    uint4 out;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) o2[i] = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst + r * st + col) = out;
  }
}

// acc (16 x D, D/16 fragments) into the warp's f32 scratch rows, then to
// global bf16 rows.
template <int D>
__device__ __forceinline__ void write_acc(FragC* acc, float* sw, bf16* dst,
                                          long long st, int lane) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(sw + n * 16, acc[n], Cfg<D>::kSLd,
                            wmma::mem_row_major);
  __syncwarp();
  store_rows<D>(sw, dst, st, lane);
}

// out (16 x 64, f32 scratch rows of the warp) = A_w B^T, where A_w is the
// warp's 16 rows of tile a and B is the 64 rows of tile b, both [., D] bf16.
template <int D>
__device__ __forceinline__ void rows_times_tile_t(const bf16* a_rows,
                                                  const bf16* b, float* out) {
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) {
    FragC s;
    wmma::fill_fragment(s, 0.f);
#pragma unroll
    for (int d = 0; d < D; d += 16) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a_rows + d, Cfg<D>::kQLd);
      wmma::load_matrix_sync(fb, b + n * 16 * Cfg<D>::kQLd + d, Cfg<D>::kQLd);
      wmma::mma_sync(s, fa, fb, s);
    }
    wmma::store_matrix_sync(out + n * 16, s, Cfg<D>::kSLd, wmma::mem_row_major);
  }
}

// acc[n] += P_w (16 x 64 bf16, rows kPLd apart) x tile[:, 16n:16n+16].
template <int D>
__device__ __forceinline__ void accumulate_rows_tile(FragC* acc,
                                                     const bf16* p_rows,
                                                     const bf16* tile) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, p_rows + kk, Cfg<D>::kPLd);
      wmma::load_matrix_sync(fb, tile + kk * Cfg<D>::kQLd + n * 16,
                             Cfg<D>::kQLd);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// The 16 x 16 tile bw[r][c] = value of row r, where lane r (< 16) holds it,
// loaded as an accumulator fragment; acc[n] *= it element by element.
template <int D>
__device__ __forceinline__ void scale_rows(FragC* acc, float row_value,
                                           float* bw, int lane) {
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const float v = __shfl_sync(kFull, row_value, rr);
    if (lane < 16) bw[rr * 16 + lane] = v;
  }
  __syncwarp();
  FragC f;
  wmma::load_matrix_sync(f, bw, 16, wmma::mem_row_major);
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
#pragma unroll
    for (int e = 0; e < f.num_elements; ++e) acc[n].x[e] *= f.x[e];
  __syncwarp();
}

template <int D>
size_t fwd_smem() {
  using C = Cfg<D>;
  return 3 * C::kTileBytes + C::kPBytes + C::kSBytes +
         sizeof(float) * kWarps * 256;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, Strided sq, Strided sk,
                     Strided sv, Strided so, int H, int T, float scale,
                     int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + C::kTileBytes);
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * C::kTileBytes);
  bf16* ps = reinterpret_cast<bf16*>(smem + 3 * C::kTileBytes);
  float* ss = reinterpret_cast<float*>(smem + 3 * C::kTileBytes + C::kPBytes);
  float* bc = reinterpret_cast<float*>(smem + 3 * C::kTileBytes + C::kPBytes +
                                       C::kSBytes);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nt = T / kTile;
  const int qi = nt - 1 - blockIdx.y;          // the longest rows start first
  const int r0 = warp * 16;                    // the warp's rows of the tile
  float* sw = ss + r0 * C::kSLd;
  bf16* pw = ps + r0 * C::kPLd;
  float* bw = bc + warp * 256;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_tile<D>(q + b * sq.b + h * sq.h + static_cast<long long>(qi) * kTile * sq.t,
               sq.t, qs);
  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  // running max and sum of row r0 + lane, held by lanes 0..15
  float m_run = kMask, l_run = 0.f;

  const int kend = causal ? qi + 1 : nt;
  for (int kj = 0; kj < kend; ++kj) {
    __syncthreads();                           // the last tiles are consumed
    load_tile<D>(kb + static_cast<long long>(kj) * kTile * sk.t, sk.t, ks);
    load_tile<D>(vb + static_cast<long long>(kj) * kTile * sv.t, sv.t, vs);
    __syncthreads();
    rows_times_tile_t<D>(qs + r0 * C::kQLd, ks, sw);
    __syncwarp();
    const bool diag = causal && kj == qi;
    float alpha_mine = 0.f;
    for (int rr = 0; rr < 16; ++rr) {
      const int row = r0 + rr;
      float x0 = sw[rr * C::kSLd + lane] * scale;
      float x1 = sw[rr * C::kSLd + lane + 32] * scale;
      if (diag) {
        if (lane > row) x0 += kMask;
        if (lane + 32 > row) x1 += kMask;
      }
      const float m_old = __shfl_sync(kFull, m_run, rr);
      const float l_old = __shfl_sync(kFull, l_run, rr);
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = __expf(x0 - m_new), p1 = __expf(x1 - m_new);
      const float sum = warp_sum(p0 + p1);
      const float alpha = __expf(m_old - m_new);
      if (lane == rr) {
        m_run = m_new;
        l_run = alpha * l_old + sum;
        alpha_mine = alpha;
      }
      pw[rr * C::kPLd + lane] = __float2bfloat16(p0);
      pw[rr * C::kPLd + lane + 32] = __float2bfloat16(p1);
    }
    // o = diag(alpha) o + p v
    scale_rows<D>(acc, alpha_mine, bw, lane);
    accumulate_rows_tile<D>(acc, pw, vs);
  }
  scale_rows<D>(acc, lane < 16 ? 1.f / l_run : 0.f, bw, lane);
  const long long row0 = static_cast<long long>(qi) * kTile + r0;
  write_acc<D>(acc, sw, o + b * so.b + h * so.h + row0 * so.t, so.t, lane);
  if (lane < 16)
    lse[static_cast<long long>(bh) * T + row0 + lane] = m_run + logf(l_run);
}

template <int D>
size_t bwd_dkv_smem() {
  using C = Cfg<D>;
  return 4 * C::kTileBytes + 2 * C::kPBytes + 2 * C::kSBytes +
         2 * sizeof(float) * kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, Strided sq, Strided sk,
                         Strided sv, Strided sdo, Strided sdk, Strided sdv,
                         int H, int T, float scale, int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + C::kTileBytes);
  bf16* qs = reinterpret_cast<bf16*>(smem + 2 * C::kTileBytes);
  bf16* dos = reinterpret_cast<bf16*>(smem + 3 * C::kTileBytes);
  unsigned char* rest = smem + 4 * C::kTileBytes;
  bf16* ps = reinterpret_cast<bf16*>(rest);                  // p^T, bf16
  bf16* dss = reinterpret_cast<bf16*>(rest + C::kPBytes);    // dS^T, bf16
  float* ss = reinterpret_cast<float*>(rest + 2 * C::kPBytes);
  float* dps = reinterpret_cast<float*>(rest + 2 * C::kPBytes + C::kSBytes);
  float* ls = reinterpret_cast<float*>(rest + 2 * C::kPBytes + 2 * C::kSBytes);
  float* dis = ls + kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nt = T / kTile;
  const int kj = blockIdx.y;                   // key tile 0 has the most rows
  const int r0 = warp * 16;                    // the warp's keys of the tile
  float* sw = ss + r0 * C::kSLd;
  float* dpw = dps + r0 * C::kSLd;
  bf16* pw = ps + r0 * C::kPLd;
  bf16* dsw = dss + r0 * C::kPLd;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const long long stat0 = static_cast<long long>(bh) * T;

  load_tile<D>(k + b * sk.b + h * sk.h + static_cast<long long>(kj) * kTile * sk.t,
               sk.t, ks);
  load_tile<D>(v + b * sv.b + h * sv.h + static_cast<long long>(kj) * kTile * sv.t,
               sv.t, vs);
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  for (int qi = causal ? kj : 0; qi < nt; ++qi) {
    __syncthreads();
    load_tile<D>(qb + static_cast<long long>(qi) * kTile * sq.t, sq.t, qs);
    load_tile<D>(dob + static_cast<long long>(qi) * kTile * sdo.t, sdo.t, dos);
    load_stat(lse + stat0 + qi * kTile, ls);
    load_stat(di + stat0 + qi * kTile, dis);
    __syncthreads();
    // s^T = k q^T and dP^T = v dO^T for the warp's 16 keys x 64 queries
    rows_times_tile_t<D>(ks + r0 * C::kQLd, qs, sw);
    rows_times_tile_t<D>(vs + r0 * C::kQLd, dos, dpw);
    __syncwarp();
    const bool diag = causal && qi == kj;
    for (int rr = 0; rr < 16; ++rr) {
      const int key = r0 + rr;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;       // the query
        float x = sw[rr * C::kSLd + c] * scale;
        if (diag && key > c) x += kMask;
        const float p = __expf(x - ls[c]);
        const float ds = p * (dpw[rr * C::kSLd + c] - dis[c]) * scale;
        pw[rr * C::kPLd + c] = __float2bfloat16(p);
        dsw[rr * C::kPLd + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    accumulate_rows_tile<D>(dv_acc, pw, dos);  // dV += p^T dO
    accumulate_rows_tile<D>(dk_acc, dsw, qs);  // dK += dS^T q
  }
  const long long row0 = static_cast<long long>(kj) * kTile + r0;
  write_acc<D>(dk_acc, sw, dk + b * sdk.b + h * sdk.h + row0 * sdk.t, sdk.t,
               lane);
  __syncwarp();
  write_acc<D>(dv_acc, sw, dv + b * sdv.b + h * sdv.h + row0 * sdv.t, sdv.t,
               lane);
}

template <int D>
size_t bwd_dq_smem() {
  using C = Cfg<D>;
  return 4 * C::kTileBytes + C::kPBytes + 2 * C::kSBytes +
         2 * sizeof(float) * kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, bf16* __restrict__ dq,
                        Strided sq, Strided sk, Strided sv, Strided sdo,
                        Strided sdq, int H, int T, float scale, int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = reinterpret_cast<bf16*>(smem + C::kTileBytes);
  bf16* ks = reinterpret_cast<bf16*>(smem + 2 * C::kTileBytes);
  bf16* vs = reinterpret_cast<bf16*>(smem + 3 * C::kTileBytes);
  unsigned char* rest = smem + 4 * C::kTileBytes;
  bf16* dss = reinterpret_cast<bf16*>(rest);                 // dS, bf16
  float* ss = reinterpret_cast<float*>(rest + C::kPBytes);
  float* dps = reinterpret_cast<float*>(rest + C::kPBytes + C::kSBytes);
  float* ls = reinterpret_cast<float*>(rest + C::kPBytes + 2 * C::kSBytes);
  float* dis = ls + kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nt = T / kTile;
  const int qi = nt - 1 - blockIdx.y;          // the longest rows start first
  const int r0 = warp * 16;
  float* sw = ss + r0 * C::kSLd;
  float* dpw = dps + r0 * C::kSLd;
  bf16* dsw = dss + r0 * C::kPLd;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const long long row_t = static_cast<long long>(qi) * kTile;
  const long long stat0 = static_cast<long long>(bh) * T + row_t;

  load_tile<D>(q + b * sq.b + h * sq.h + row_t * sq.t, sq.t, qs);
  load_tile<D>(dout + b * sdo.b + h * sdo.h + row_t * sdo.t, sdo.t, dos);
  load_stat(lse + stat0, ls);
  load_stat(di + stat0, dis);
  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int kend = causal ? qi + 1 : nt;
  for (int kj = 0; kj < kend; ++kj) {
    __syncthreads();
    load_tile<D>(kb + static_cast<long long>(kj) * kTile * sk.t, sk.t, ks);
    load_tile<D>(vb + static_cast<long long>(kj) * kTile * sv.t, sv.t, vs);
    __syncthreads();
    // s = q k^T and dP = dO v^T for the warp's 16 queries x 64 keys
    rows_times_tile_t<D>(qs + r0 * C::kQLd, ks, sw);
    rows_times_tile_t<D>(dos + r0 * C::kQLd, vs, dpw);
    __syncwarp();
    const bool diag = causal && kj == qi;
    for (int rr = 0; rr < 16; ++rr) {
      const int row = r0 + rr;
      const float l_row = ls[row], di_row = dis[row];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;       // the key
        float x = sw[rr * C::kSLd + c] * scale;
        if (diag && c > row) x += kMask;
        const float p = __expf(x - l_row);
        dsw[rr * C::kPLd + c] =
            __float2bfloat16(p * (dpw[rr * C::kSLd + c] - di_row) * scale);
      }
    }
    __syncwarp();
    accumulate_rows_tile<D>(acc, dsw, ks);     // dQ += dS k
  }
  write_acc<D>(acc, sw, dq + b * sdq.b + h * sdq.h + (row_t + r0) * sdq.t,
               sdq.t, lane);
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

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const long long* s, int B, int H, int T,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  if (int e = prepare(flash_fwd_kernel<D>, smem)) return e;
  const dim3 grid(B * H, T / kTile);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), strided(s, 0), strided(s, 1), strided(s, 2),
      strided(s, 3), H, T, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, void* dk, void* dv,
               const long long* s, int B, int H, int T, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = bwd_dkv_smem<D>();
  if (int e = prepare(flash_bwd_dkv_kernel<D>, smem)) return e;
  const dim3 grid(B * H, T / kTile);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), strided(s, 0),
      strided(s, 1), strided(s, 2), strided(s, 3), strided(s, 4),
      strided(s, 5), H, T, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, void* dq, const long long* s,
              int B, int H, int T, float scale, int causal,
              cudaStream_t stream) {
  const size_t smem = bwd_dq_smem<D>();
  if (int e = prepare(flash_bwd_dq_kernel<D>, smem)) return e;
  const dim3 grid(B * H, T / kTile);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<bf16*>(dq), strided(s, 0), strided(s, 1), strided(s, 2),
      strided(s, 3), strided(s, 4), H, T, scale, causal);
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
