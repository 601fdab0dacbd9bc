// PowerSGD factor products for Hopper (sm_90a), kernel B9.
//
// Replaces the TPU kernel theanompi_tpu/ops/factor_pack.py:66
// _matmul_pack_pallas (oracle matmul_pack_jnp): a skinny product m @ q,
// q of rank r (2 on the main path), stored zero-padded to rows_pad rows (a
// multiple of 8) so every leaf's tile is a slice of one staging buffer
// that a single collective reduces; the pad rows are exactly +0.
//
// The port keeps a leaf in PyTorch's layout, where A = leaf.reshape(
// shape[0], -1) is the JAX package's factor matrix transposed.  So one
// contiguous A [R, C] serves both products, read in place:
//   transpose = 0 (rowdot):  out[i, j] = sum_c A[i, c] q[c, j]   (rows R)
//   transpose = 1 (coldot):  out[c, j] = sum_i A[i, c] q[i, j]   (rows C)
//
// Bound: device-memory bytes.  A product reads A once (fc6 is 4096 x 25088
// floats, 411 MB) and does 2r flops per element read, far under the ~20
// flops per byte at which the f32 rate would limit.  A PowerSGD pass is 16
// such products (VGG-16), 13 of them a few MB or less, so the design is:
//
//   * One launch per pass, over every leaf.  The leaves' descriptors
//     (pointers, shape, orientation, row offset in the staging buffer) ride
//     in the kernel's parameter space (a __grid_constant__ struct, < 4 KB),
//     so a launch copies nothing to the device beforehand.  Each leaf is
//     cut into work items of `band` output rows (coldot: 128, the columns
//     of A that a warp covers with 16-byte loads; rowdot: 32 or 64 rows,
//     sized by the host to about 256 KB of A per CTA); a work item's first
//     index (`item0`) is cumulative over the leaves, and a CTA finds its
//     leaf by a binary search on it.
//   * Every work item is a cluster of 8 CTAs that split its reduction: the
//     rows of A (coldot) or its columns (rowdot) in 8 even slices.  Each
//     CTA sums its slice into shared memory; after cluster.sync() CTA k
//     adds the 8 partial sums of output rows k, k+8, ... through
//     distributed shared memory in rank order and writes them.  So fc7 and
//     fc8 (4096 and 1000 rows of A down each column strip) run on 256 CTAs
//     instead of 32, with no float atomics, and every sum is taken in one
//     fixed order: the result does not vary from run to run.
//   * Bytes in flight: in coldot lane l of each warp reads columns 4l..4l+3
//     of one row as a float4 (a warp: 512 contiguous bytes a row) for 4
//     rows at once (16 KB a CTA); in rowdot a warp walks 4 rows of its
//     column slice at once with float4 loads, so each q element it reads
//     serves 4 rows, and the 4·r q values of a float4 of A come as r
//     float4 loads (r <= 2 or 4).  A streams through L1 (__ldcs); q
//     (small, reused) is read through the read-only path.
//   * A row length or base that is not 16-byte aligned (conv1_1's 27
//     columns) takes a scalar path with the same slices.
//   * q columns are handled RT at a time (RT = r for r <= 2, else 4, with
//     gridDim.y = ceil(r / 4)), so any rank works; at r <= 4 A is read once.
// Sums are float32 with fused multiply-adds, in another order than a
// library product: the callers hold it to the float32 bound
// 2 gamma_n sum_k |a_k q_k| (gamma_n = n u / (1 - n u), u = 2^-24).
//
// The C entry launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;         // CTAs splitting one work item's sums
constexpr int kColBand = 128;       // coldot: output rows of a work item;
                                    // rowdot's bands are at most this
constexpr int kRowsPerWarp = 4;     // rowdot: rows a warp walks at once
constexpr int kUnroll = 4;          // coldot: rows a lane has in flight
constexpr int kMaxLeaves = 64;

// one leaf of a pass; the host (ops/factor_pack.py) fills it
struct Leaf {
  const float* a;    // A [R, C], contiguous
  const float* q;    // [transpose ? R : C, rank]
  int R, C;
  int rows_pad;      // output rows, pad included
  int out_off;       // first row of this leaf's tile in the staging buffer
  int item0;         // first work item of the leaf (cumulative)
  int band;          // output rows per work item
  int transpose;     // 1: coldot, 0: rowdot
  int vec;           // C % 4 == 0 and A 16-byte aligned
  int qvec;          // rank <= 2 or 4, q 16-byte aligned: float4 q loads
};

struct Group {
  Leaf leaf[kMaxLeaves];
  float* out;        // the staging buffer [sum rows_pad, rank]
  int n_leaves, rank;
};
static_assert(sizeof(Group) <= 4096, "kernel parameters above 4 KB");

// the k-th of kCluster even slices of [0, n)
__device__ __forceinline__ int split(int n, int k) {
  return static_cast<int>(static_cast<long long>(n) * k / kCluster);
}

// columns c..c+3 of row i of A; columns at or past C read as 0
__device__ __forceinline__ float4 load4(const float* a, int i, int c, int C,
                                        bool vec) {
  const float* p = a + static_cast<size_t>(i) * C + c;
  if (vec) return __ldcs(reinterpret_cast<const float4*>(p));
  float4 v;
  v.x = c < C ? __ldcs(p) : 0.f;
  v.y = c + 1 < C ? __ldcs(p + 1) : 0.f;
  v.z = c + 2 < C ? __ldcs(p + 2) : 0.f;
  v.w = c + 3 < C ? __ldcs(p + 3) : 0.f;
  return v;
}

template <int RT>
__device__ __forceinline__ void fma4(float (&acc)[4][RT], const float4 x,
                                     const float (&qv)[RT]) {
#pragma unroll
  for (int jj = 0; jj < RT; ++jj) {
    acc[0][jj] = fmaf(x.x, qv[jj], acc[0][jj]);
    acc[1][jj] = fmaf(x.y, qv[jj], acc[1][jj]);
    acc[2][jj] = fmaf(x.z, qv[jj], acc[2][jj]);
    acc[3][jj] = fmaf(x.w, qv[jj], acc[3][jj]);
  }
}

// coldot: this CTA's slice k of A's rows, down the item's 128 columns
// o0..o0+127, summed into part[col][jj]
template <int RT>
__device__ void coldot_part(const Leaf& L, int o0, int k, int j0, int rank,
                            float (&red)[kWarps][RT][4][32],
                            float (&part)[kColBand][RT]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = L.C;
  const int c = o0 + 4 * lane;
  const int i_lo = split(L.R, k), i_hi = split(L.R, k + 1);
  float acc[4][RT];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int jj = 0; jj < RT; ++jj) acc[e][jj] = 0.f;
  if (c < C) {
    const bool vec = L.vec != 0;
    int i = i_lo + warp;
    for (; i + (kUnroll - 1) * kWarps < i_hi; i += kUnroll * kWarps) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = load4(L.a, i + u * kWarps, c, C,
                                                     vec);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* qi = L.q + static_cast<size_t>(i + u * kWarps) * rank + j0;
        float qv[RT];
#pragma unroll
        for (int jj = 0; jj < RT; ++jj)
          qv[jj] = j0 + jj < rank ? __ldg(qi + jj) : 0.f;
        fma4<RT>(acc, x[u], qv);
      }
    }
    for (; i < i_hi; i += kWarps) {
      const float4 x = load4(L.a, i, c, C, vec);
      const float* qi = L.q + static_cast<size_t>(i) * rank + j0;
      float qv[RT];
#pragma unroll
      for (int jj = 0; jj < RT; ++jj)
        qv[jj] = j0 + jj < rank ? __ldg(qi + jj) : 0.f;
      fma4<RT>(acc, x, qv);
    }
  }
  // columns past C are pad rows: exactly +0, whatever q holds
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int jj = 0; jj < RT; ++jj)
      red[warp][jj][e][lane] = c + e < C ? acc[e][jj] : 0.f;
  __syncthreads();
  for (int t = threadIdx.x; t < kColBand * RT; t += kThreads) {
    const int col = t / RT, jj = t % RT;
    const int l = col >> 2, e = col & 3;
    float s = red[0][jj][e][l];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][jj][e][l];
    part[col][jj] = s;
  }
}

// rowdot: the item's rows o0..o0+nb-1, across this CTA's slice k of A's
// columns (in units of 4), summed into part[row][jj]
template <int RT>
__device__ void rowdot_part(const Leaf& L, int o0, int nb, int k, int j0,
                            int rank, float (&part)[kColBand][RT]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = L.C;
  const int units = (C + 3) >> 2;
  const int u_lo = split(units, k), u_hi = split(units, k + 1);
  for (int r0 = warp * kRowsPerWarp; r0 < nb; r0 += kWarps * kRowsPerWarp) {
    const int i0 = o0 + r0;
    const int nr = min(kRowsPerWarp, L.R - i0);    // rows with data
    float acc[kRowsPerWarp][RT];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int jj = 0; jj < RT; ++jj) acc[rr][jj] = 0.f;
    if (nr > 0 && L.vec) {
      const float* a0 = L.a + static_cast<size_t>(i0) * C;
#pragma unroll 2
      for (int u = u_lo + lane; u < u_hi; u += 32) {
        float qv[4][RT];
        if (L.qvec && RT == rank) {
          // q rows 4u..4u+3 are 4·RT contiguous floats: RT float4 loads
          const float4* q4 = reinterpret_cast<const float4*>(
              L.q + static_cast<size_t>(4 * u) * RT);
          float* flat = &qv[0][0];
#pragma unroll
          for (int v = 0; v < RT; ++v) {
            const float4 w = __ldg(q4 + v);
            flat[4 * v] = w.x;
            flat[4 * v + 1] = w.y;
            flat[4 * v + 2] = w.z;
            flat[4 * v + 3] = w.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int jj = 0; jj < RT; ++jj)
              qv[e][jj] = j0 + jj < rank
                              ? __ldg(L.q + static_cast<size_t>(4 * u + e) *
                                                rank + j0 + jj)
                              : 0.f;
        }
        float4 x[kRowsPerWarp];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr)
          x[rr] = rr < nr ? __ldcs(reinterpret_cast<const float4*>(
                                a0 + static_cast<size_t>(rr) * C) + u)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
          for (int jj = 0; jj < RT; ++jj) {
            float s = acc[rr][jj];
            s = fmaf(x[rr].x, qv[0][jj], s);
            s = fmaf(x[rr].y, qv[1][jj], s);
            s = fmaf(x[rr].z, qv[2][jj], s);
            s = fmaf(x[rr].w, qv[3][jj], s);
            acc[rr][jj] = s;
          }
      }
    } else if (nr > 0) {
      const float* a0 = L.a + static_cast<size_t>(i0) * C;
      const int c_hi = min(4 * u_hi, C);
      for (int c = 4 * u_lo + lane; c < c_hi; c += 32) {
        float qv[RT];
#pragma unroll
        for (int jj = 0; jj < RT; ++jj)
          qv[jj] = j0 + jj < rank
                       ? __ldg(L.q + static_cast<size_t>(c) * rank + j0 + jj)
                       : 0.f;
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const float x = rr < nr ? __ldcs(a0 + static_cast<size_t>(rr) * C + c)
                                  : 0.f;
#pragma unroll
          for (int jj = 0; jj < RT; ++jj)
            acc[rr][jj] = fmaf(x, qv[jj], acc[rr][jj]);
        }
      }
    }
    // the warp's sum of each row, in a fixed butterfly order; rows past R
    // (pad rows) are sums of +0
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int jj = 0; jj < RT; ++jj) {
        float s = rr < nr ? acc[rr][jj] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0 && r0 + rr < nb) part[r0 + rr][jj] = s;
      }
  }
}

// 4 CTAs an SM at r <= 2 (64 registers; 3 at 77-80 made the step 5%
// slower on an H100), 3 at RT = 4, where 64 registers would spill
template <int RT>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kThreads, RT <= 2 ? 4 : 3)
factor_pack_kernel(const __grid_constant__ Group g) {
  __shared__ float red[kWarps][RT][4][32];
  __shared__ float part[kColBand][RT];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.block_rank());
  const int item = static_cast<int>(blockIdx.x) / kCluster;
  // the leaf whose items hold this one: the last with item0 <= item
  int lo = 0, hi = g.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (g.leaf[mid].item0 <= item) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = g.leaf[lo];
  const int j0 = static_cast<int>(blockIdx.y) * RT;
  const int o0 = (item - L.item0) * L.band;
  const int nb = min(L.band, L.rows_pad - o0);     // output rows written
  if (L.transpose)
    coldot_part<RT>(L, o0, k, j0, g.rank, red, part);
  else
    rowdot_part<RT>(L, o0, nb, k, j0, g.rank, part);
  cluster.sync();
  // CTA k writes rows k, k + 8, ... of the item: the 8 CTAs' partial sums
  // added in rank order
  const int mine = nb > k ? (nb - k + kCluster - 1) / kCluster : 0;
  for (int t = threadIdx.x; t < mine * RT; t += kThreads) {
    const int r = k + (t / RT) * kCluster, jj = t % RT;
    if (j0 + jj < g.rank) {
      float s = *cluster.map_shared_rank(&part[r][jj], 0);
#pragma unroll
      for (int src = 1; src < kCluster; ++src)
        s += *cluster.map_shared_rank(&part[r][jj], src);
      g.out[static_cast<size_t>(L.out_off + o0 + r) * g.rank + j0 + jj] = s;
    }
  }
  cluster.sync();       // the other CTAs' shared memory stays until all read
}

template <int RT>
int launch(const Group& g, int n_items, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n_items) * kCluster,
                  static_cast<unsigned>((g.rank + RT - 1) / RT));
  factor_pack_kernel<RT><<<grid, kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// leaves: n (<= 64) struct Leaf as ops/factor_pack.py plans them; out
// [sum rows_pad, rank]; n_items = the items of all n leaves.  The wrapper
// checks the shapes.
int matmul_pack_group(const void* leaves, int n, float* out, int rank,
                      int n_items, cudaStream_t stream) {
  if (n < 1 || n > kMaxLeaves || rank < 1 || n_items < 1 ||
      n_items > (1 << 27))
    return static_cast<int>(cudaErrorInvalidValue);
  Group g{};
  memcpy(g.leaf, leaves, sizeof(Leaf) * n);
  g.out = out;
  g.n_leaves = n;
  g.rank = rank;
  if (rank == 1) return launch<1>(g, n_items, stream);
  if (rank == 2) return launch<2>(g, n_items, stream);
  return launch<4>(g, n_items, stream);
}

}  // extern "C"
