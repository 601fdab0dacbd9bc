// PowerSGD factor products for Hopper (sm_90a), kernel B9.
//
// Replaces the TPU kernel theanompi_tpu/ops/factor_pack.py:66
// _matmul_pack_pallas (oracle matmul_pack_jnp): a skinny product m @ q,
// q of rank r (2 on the main path), stored zero-padded to rows_pad rows (a
// multiple of 8) so every leaf's tile is a slice of one staging buffer
// that a single collective reduces; the pad rows are exactly 0.
//
// The port keeps a leaf in PyTorch's layout, where A = leaf.reshape(
// shape[0], -1) is the JAX package's factor matrix transposed.  So one
// contiguous A [R, C] serves both products, read in place:
//   transpose = 0:  out[i, j] = sum_c A[i, c] q[c, j]   (rows R;  Q' = A P)
//   transpose = 1:  out[c, j] = sum_i A[i, c] q[i, j]   (rows C;  P = A^T Q)
//
// Bound: device-memory bytes.  Each product reads A once (fc6 is 4096 x
// 25088 floats, 411 MB) and does 2r flops per element read, far under the
// ~20 flops per byte at which the f32 rate would limit.  So both kernels
// make one coalesced pass over A:
//   * rowdot (transpose = 0): a block of 256 threads owns 4 rows of A and
//     walks their columns with 16-byte loads where the row length and base
//     allow; each q element it reads serves the 4 rows.  Partial sums are
//     reduced in the block in a fixed order (warp shuffles, then the 8 warp
//     sums in order), so the result does not vary from run to run.
//   * coldot (transpose = 1): a block owns 32 columns; lane l of each of
//     its 8 warps walks column l down every 8th row, so a warp reads 128
//     contiguous bytes per row and q[i, :] is one broadcast.  The 8 warps'
//     partial sums meet in shared memory and are added in warp order.
//   * q columns are handled 4 at a time (gridDim.y = ceil(r / 4)), so any
//     rank works; at r = 2 A is read once.
// Sums are float32 with fused multiply-adds, in another order than a
// library product: the wrapper's callers hold it to the float32 bound
// 2 gamma_n sum_k |a_k q_k| (gamma_n = n u / (1 - n u), u = 2^-24).
//
// The C entry launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 4;     // q columns per block
constexpr int kRB = 4;     // rows of A per rowdot block

__global__ void __launch_bounds__(kThreads)
rowdot_kernel(const float* __restrict__ a, const float* __restrict__ q,
              float* __restrict__ out, int R, int C, int rank, bool vec) {
  __shared__ float red[kWarps][kRB][kRT];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int i0 = blockIdx.x * kRB;
  const int j0 = blockIdx.y * kRT;
  float acc[kRB][kRT];
#pragma unroll
  for (int rr = 0; rr < kRB; ++rr)
#pragma unroll
    for (int jj = 0; jj < kRT; ++jj) acc[rr][jj] = 0.f;
  // rows of A in this block; a block of pad rows only (nr <= 0) keeps
  // its sums 0
  const int nr = min(kRB, R - i0);
  if (nr > 0 && vec) {
    for (int c4 = t; c4 < C / 4; c4 += kThreads) {
      float qv[4][kRT];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int jj = 0; jj < kRT; ++jj)
          qv[e][jj] = j0 + jj < rank
                          ? q[static_cast<size_t>(4 * c4 + e) * rank + j0 + jj]
                          : 0.f;
#pragma unroll
      for (int rr = 0; rr < kRB; ++rr) {
        if (rr >= nr) break;
        const float4 x = reinterpret_cast<const float4*>(
            a + static_cast<size_t>(i0 + rr) * C)[c4];
#pragma unroll
        for (int jj = 0; jj < kRT; ++jj) {
          float s = acc[rr][jj];
          s = fmaf(x.x, qv[0][jj], s);
          s = fmaf(x.y, qv[1][jj], s);
          s = fmaf(x.z, qv[2][jj], s);
          s = fmaf(x.w, qv[3][jj], s);
          acc[rr][jj] = s;
        }
      }
    }
  } else if (nr > 0) {
    for (int c = t; c < C; c += kThreads) {
      float qv[kRT];
#pragma unroll
      for (int jj = 0; jj < kRT; ++jj)
        qv[jj] = j0 + jj < rank ? q[static_cast<size_t>(c) * rank + j0 + jj]
                                : 0.f;
#pragma unroll
      for (int rr = 0; rr < kRB; ++rr) {
        if (rr >= nr) break;
        const float x = a[static_cast<size_t>(i0 + rr) * C + c];
#pragma unroll
        for (int jj = 0; jj < kRT; ++jj)
          acc[rr][jj] = fmaf(x, qv[jj], acc[rr][jj]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRB; ++rr)
#pragma unroll
    for (int jj = 0; jj < kRT; ++jj) {
      float s = acc[rr][jj];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) red[warp][rr][jj] = s;
    }
  __syncthreads();
  if (t < kRB * kRT) {
    const int rr = t / kRT, jj = t % kRT;
    if (j0 + jj < rank) {
      float s = 0.f;           // pad rows: a sum of zeros, exactly +0
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][rr][jj];
      out[static_cast<size_t>(i0 + rr) * rank + j0 + jj] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
coldot_kernel(const float* __restrict__ a, const float* __restrict__ q,
              float* __restrict__ out, int R, int C, int rank, int rows_pad) {
  __shared__ float red[kWarps][kRT][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int j0 = blockIdx.y * kRT;
  float acc[kRT];
#pragma unroll
  for (int jj = 0; jj < kRT; ++jj) acc[jj] = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int i = warp; i < R; i += kWarps) {
      const float x = a[static_cast<size_t>(i) * C + c];
      const float* qi = q + static_cast<size_t>(i) * rank + j0;
#pragma unroll
      for (int jj = 0; jj < kRT; ++jj)
        if (j0 + jj < rank) acc[jj] = fmaf(x, qi[jj], acc[jj]);
    }
  }
#pragma unroll
  for (int jj = 0; jj < kRT; ++jj) red[warp][jj][lane] = acc[jj];
  __syncthreads();
  if (warp == 0 && c < rows_pad) {
#pragma unroll
    for (int jj = 0; jj < kRT; ++jj) {
      if (j0 + jj >= rank) break;
      float s = 0.f;           // columns c >= C: the pad rows, exactly +0
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][jj][lane];
      out[static_cast<size_t>(c) * rank + j0 + jj] = s;
    }
  }
}

}  // namespace

extern "C" {

// a [ra, ca] contiguous; q [transpose ? ra : ca, rank]; out [rows_pad, rank]
// with rows_pad >= (transpose ? ca : ra), rows_pad % 8 == 0 (the wrapper
// checks)
int matmul_pack(const float* a, const float* q, float* out, int ra, int ca,
                int rank, int rows_pad, int transpose, cudaStream_t stream) {
  if (rows_pad > 0 && rank > 0) {
    const unsigned ry = static_cast<unsigned>((rank + kRT - 1) / kRT);
    if (transpose) {
      const dim3 grid(static_cast<unsigned>((rows_pad + 31) / 32), ry);
      coldot_kernel<<<grid, kThreads, 0, stream>>>(a, q, out, ra, ca, rank,
                                                   rows_pad);
    } else {
      const bool vec = ca % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0;
      const dim3 grid(static_cast<unsigned>(rows_pad / kRB), ry);
      rowdot_kernel<<<grid, kThreads, 0, stream>>>(a, q, out, ra, ca, rank,
                                                   vec);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
