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
// is a true float32 fused multiply-add (FFMA), no TF32, so the kernels agree
// with the float32 plain versions (ops/flash_attention.py) up to the order of
// float32 sums.  expf and logf are the accurate ones (no fast-math flag).
//
// Bound.  At the LM's shape ([16, 8, 512, 64] f32, causal) one causal product
// is T^2/2 * D * B * H multiply-adds, 2.15 GFLOP: B10 does two (q k^T, p v),
// B11 four, B12 three.  At the H100's 67 TFLOP/s of float32 (no tensor
// cores) that is 0.064, 0.128 and 0.096 ms, against 0.020-0.030 ms for their
// bytes at 3.35 TB/s: all three are bound by operations.
//
// Design (a plain SIMT kernel, right first; speed is later work).  One CTA of
// 256 threads per (b*h, 64-row output tile); D in {32, 64, 128}, T a multiple
// of 64.  The CTA's 64 rows and the current 64-row tile of the other side
// sit in shared memory, rows padded to D + 1 floats so that the 16 threads
// that read 16 different rows of one column hit 16 different banks.  Thread
// (ty, tx) = (tid / 16, tid % 16) owns the 4 x 4 score entries (ty + 16 i,
// tx + 16 j) of a 64 x 64 tile, and the 4 x D/16 output entries (ty + 16 i,
// tx + 16 c): a score tile is 16 FFMAs for 8 shared loads per step of D, and
// a row's 64 scores live in the 16 lanes of one half-warp, so a row max or
// sum is four xor-shuffles.  Scores, p and dS go through a 64 x 65 tile in
// shared memory between the score pass and the product pass that consumes
// them.  The online softmax (B10) keeps m and l per row in registers and
// rescales the output sums by exp(m_old - m_new).  Causal: tiles wholly
// above the diagonal are skipped (their p is exactly 0 in float32), the
// diagonal tile adds the mask from each element's (row, column).  B10 and
// B12 start the longest rows first.  Each output entry is owned by one
// thread and summed in a fixed order: no atomics, the same bits every run.
//
// Inputs may be strided views: each tensor comes with its B, H and T strides
// in elements, the last dim contiguous (the wrapper checks).  Outputs are
// written through their strides the same way.  Each C entry launches on the
// caller's stream, allocates nothing and returns the CUDA error of the
// launch (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                  // rows of a q or k/v tile
constexpr int kThreads = 256;
constexpr float kMask = -0.7f * 3.402823466e38f;   // DEFAULT_MASK_VALUE
constexpr int kSP = kTile + 1;             // padded row of a score tile

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

// A 64 x D tile from global memory into shared rows of D + 1 floats:
// neighbouring threads read neighbouring columns.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st_t) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = src[r * st_t + c];
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[i][j] += sum_d a[(ty + 16 i) * P + d] * b[(tx + 16 j) * P + d]
template <int D>
__device__ __forceinline__ void score_tile(float (&acc)[4][4], const float* a,
                                           const float* b, int ty, int tx) {
  constexpr int P = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * P + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * P + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[i][c] += sum_k s[(ty + 16 i) * kSP + k] * m[k * P + tx + 16 c]
template <int D>
__device__ __forceinline__ void product_tile(float (&out)[4][D / 16],
                                             const float* s, const float* m,
                                             int ty, int tx) {
  constexpr int P = D + 1;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float sv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sv[i] = s[(ty + 16 * i) * kSP + k];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float mv = m[k * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i][c] = fmaf(sv[i], mv, out[i][c]);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_tile(float* dst, long long st_t,
                                           const float (&v)[4][D / 16],
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      dst[(ty + 16 * i) * st_t + tx + 16 * c] = v[i][c];
}

// ---------------------------------------------------------------------------
// B10: o and lse
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strided sq, Strided sk,
                     Strided sv, Strided so, int H, int T, float scale,
                     int causal) {
  constexpr int P = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * P;
  float* vs = ks + kTile * P;
  float* ps = vs + kTile * P;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qb = gridDim.y - 1 - blockIdx.y;         // longest rows first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<D>(qs, q + base(sq, b, h, qb * kTile), sq.t);

  float acc[4][D / 16], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int n_kb = causal ? qb + 1 : T / kTile;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();                    // the previous tile's readers are done
    load_tile<D>(ks, k + base(sk, b, h, kb * kTile), sk.t);
    load_tile<D>(vs, v + base(sv, b, h, kb * kTile), sv.t);
    __syncthreads();
    float s[4][4] = {};
    score_tile<D>(s, qs, ks, ty, tx);
    const bool diag = causal && kb == qb;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (diag && tx + 16 * j > ty + 16 * i) s[i][j] += kMask;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kSP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    product_tile<D>(acc, ps, vs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = acc[i][c] / l[i];
    if (tx == 0)
      lse[(static_cast<long long>(blockIdx.x) * T) + qb * kTile + ty + 16 * i] =
          m[i] + logf(l[i]);
  }
  store_tile<D>(o + base(so, b, h, qb * kTile), so.t, acc, ty, tx);
}

// ---------------------------------------------------------------------------
// B11: dK, dV (one CTA per 64-row k/v tile, q tiles streamed)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         float* __restrict__ dk, float* __restrict__ dv,
                         Strided sq, Strided sk, Strided sv, Strided sdo,
                         Strided sdk, Strided sdv, int H, int T, float scale,
                         int causal) {
  constexpr int P = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * P;
  float* qs = vs + kTile * P;
  float* dos = qs + kTile * P;
  float* pts = dos + kTile * P;       // p^T  [k row][q row]
  float* dss = pts + kTile * kSP;     // dS^T [k row][q row]
  float* lses = dss + kTile * kSP;
  float* dis = lses + kTile;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kb = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<D>(ks, k + base(sk, b, h, kb * kTile), sk.t);
  load_tile<D>(vs, v + base(sv, b, h, kb * kTile), sv.t);

  float dka[4][D / 16] = {}, dva[4][D / 16] = {};
  const float* lse_bh = lse + static_cast<long long>(blockIdx.x) * T;
  const float* di_bh = di + static_cast<long long>(blockIdx.x) * T;
  for (int qb = causal ? kb : 0; qb < T / kTile; ++qb) {
    __syncthreads();
    load_tile<D>(qs, q + base(sq, b, h, qb * kTile), sq.t);
    load_tile<D>(dos, dout + base(sdo, b, h, qb * kTile), sdo.t);
    if (threadIdx.x < kTile) {
      lses[threadIdx.x] = lse_bh[qb * kTile + threadIdx.x];
      dis[threadIdx.x] = di_bh[qb * kTile + threadIdx.x];
    }
    __syncthreads();
    // s^T and dP^T for k rows ty + 16 i, q rows tx + 16 j
    float st[4][4] = {}, dpt[4][4] = {};
    score_tile<D>(st, ks, qs, ty, tx);
    score_tile<D>(dpt, vs, dos, ty, tx);
    const bool diag = causal && qb == kb;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = ty + 16 * i, qr = tx + 16 * j;
        float s = st[i][j] * scale;
        if (diag && kr > qr) s += kMask;
        const float p = expf(s - lses[qr]);
        pts[kr * kSP + qr] = p;
        dss[kr * kSP + qr] = p * (dpt[i][j] - dis[qr]) * scale;
      }
    __syncthreads();
    product_tile<D>(dva, pts, dos, ty, tx);
    product_tile<D>(dka, dss, qs, ty, tx);
  }
  store_tile<D>(dk + base(sdk, b, h, kb * kTile), sdk.t, dka, ty, tx);
  store_tile<D>(dv + base(sdv, b, h, kb * kTile), sdv.t, dva, ty, tx);
}

// ---------------------------------------------------------------------------
// B12: dQ (one CTA per 64-row q tile, k/v tiles streamed)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, float* __restrict__ dq,
                        Strided sq, Strided sk, Strided sv, Strided sdo,
                        Strided sdq, int H, int T, float scale, int causal) {
  constexpr int P = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * P;
  float* ks = dos + kTile * P;
  float* vs = ks + kTile * P;
  float* dss = vs + kTile * P;        // dS [q row][k row]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qb = gridDim.y - 1 - blockIdx.y;         // longest rows first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<D>(qs, q + base(sq, b, h, qb * kTile), sq.t);
  load_tile<D>(dos, dout + base(sdo, b, h, qb * kTile), sdo.t);
  float lr[4], dr[4];
  const long long row0 = static_cast<long long>(blockIdx.x) * T + qb * kTile;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lr[i] = lse[row0 + ty + 16 * i];
    dr[i] = di[row0 + ty + 16 * i];
  }

  float dqa[4][D / 16] = {};
  const int n_kb = causal ? qb + 1 : T / kTile;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    load_tile<D>(ks, k + base(sk, b, h, kb * kTile), sk.t);
    load_tile<D>(vs, v + base(sv, b, h, kb * kTile), sv.t);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    score_tile<D>(s, qs, ks, ty, tx);
    score_tile<D>(dp, dos, vs, ty, tx);
    const bool diag = causal && kb == qb;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = ty + 16 * i, kr = tx + 16 * j;
        float x = s[i][j] * scale;
        if (diag && kr > qr) x += kMask;
        const float p = expf(x - lr[i]);
        dss[qr * kSP + kr] = p * (dp[i][j] - dr[i]) * scale;
      }
    __syncthreads();
    product_tile<D>(dqa, dss, ks, ty, tx);
  }
  store_tile<D>(dq + base(sdq, b, h, qb * kTile), sdq.t, dqa, ty, tx);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kSP);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kSP + 2 * kTile);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kSP);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, const long long* s, int B, int H, int T,
               float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  if (int e = prepare(flash_fwd_f32_kernel<D>, smem)) return e;
  const dim3 grid(B * H, T / kTile);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, strided(s, 0), strided(s, 1), strided(s, 2),
      strided(s, 3), H, T, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* di,
               float* dk, float* dv, const long long* s, int B, int H, int T,
               float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<D>();
  if (int e = prepare(flash_bwd_dkv_f32_kernel<D>, smem)) return e;
  const dim3 grid(B * H, T / kTile);
  flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, di, dk, dv, strided(s, 0), strided(s, 1),
      strided(s, 2), strided(s, 3), strided(s, 4), strided(s, 5), H, T, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* di,
              float* dq, const long long* s, int B, int H, int T, float scale,
              int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<D>();
  if (int e = prepare(flash_bwd_dq_f32_kernel<D>, smem)) return e;
  const dim3 grid(B * H, T / kTile);
  flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, di, dq, strided(s, 0), strided(s, 1), strided(s, 2),
      strided(s, 3), strided(s, 4), H, T, scale, causal);
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
