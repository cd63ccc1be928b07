// K2: Aberth repulsion sum (sm_90a).
//
// Replaces the Pallas TPU kernel fnft_tpu/ops/pallas_kernels.py:254
// (repulsion_sum -> repulsion_sum_planes / _repulsion_kernel), also under
// vmap, where the Pallas batching rule adds a grid axis:
//
//   s_b,i = sum_{j != t_idx_i, j < deg} 1 / (z_t_b,i - z_all_b,j),
//   i < m, b < batch,
//
// with one t_idx shared by the rows (the Aberth sweeps of a batch of
// polynomials pass the same root indices). The batch is the grid's third
// axis; the split count depends on (deg, m, SMs) only, so each row gets the
// bits of a launch of that row alone.
//
// The work is O(m deg) arithmetic on O(m + deg) bytes, so the card's issue
// rate bounds it, not memory. Design: a 2-D grid of row blocks x splits of
// the j range. A block of 128 threads owns 256 active roots, two per thread
// with independent accumulators, so each value read from shared memory
// serves two pairs; it streams its split of z_all through shared memory in
// tiles of 512. Splits cover whole tiles, so tile sums group as in the
// one-pass kernel, and split_of picks their count from deg, m and the
// device's SM count so that the grid holds several blocks on every SM. Each
// split writes its partial sums to a [batch, splits, m] scratch that a
// second kernel adds in split order: no atomics,
// the same bits on every launch (the Aberth sweep's freezing depends on
// them). Self-exclusion is a select, not a branch. The precision contract
// is that of fnft_tpu/ops/roots.py:68-80: differences are formed in the
// input precision T; with `lowprec` the reciprocal and the sum of each tile
// run in float (A = float), and tile sums are accumulated in T. Without
// `lowprec` everything stays in T. The float reciprocal is rcp.approx with
// flush to zero (1 ulp) and one Newton step: on an H100 the kernel ran
// markedly slower with __frcp_rn, or without ftz. x is clamped to FLT_MAX,
// so that a difference beyond 1.8e19 gives 0, as 1/inf does; one below
// 1e-19, whose square is subnormal, is outside the float contract either
// way.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;             // threads per block
constexpr int kR = 2;                     // active roots per thread
constexpr int kRows = kThreads * kR;      // active roots per block
constexpr int kTile = 512;                // roots of z_all per tile
constexpr int kBlocksPerSm = 8;           // blocks per SM the splits aim for

template <typename T> struct Vec2;
template <> struct Vec2<double> { using type = double2; };
template <> struct Vec2<float> { using type = float2; };

__device__ __forceinline__ float recip(float x) {
  x = fminf(x, 3.402823466e38f);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}
__device__ __forceinline__ double recip(double x) { return 1.0 / x; }

// Partial sums of rows [blockIdx.x * kRows, +kRows) of batch row blockIdx.z
// over the tiles [blockIdx.y * tiles_per_split, +tiles_per_split) of its
// z_all, into part[blockIdx.z][blockIdx.y][i] (scratch [batch, splits, m]).
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
repulsion_partial_kernel(const T* __restrict__ z_all, const T* __restrict__ z_t,
                         const int* __restrict__ t_idx, T* __restrict__ part,
                         int deg, int m, int tiles_per_split) {
  using V = typename Vec2<T>::type;
  __shared__ V zs[kTile];
  const size_t b = blockIdx.z;
  const V* za = reinterpret_cast<const V*>(z_all) + b * deg;
  const V* zt = reinterpret_cast<const V*>(z_t) + b * m;
  const int row0 = blockIdx.x * kRows + threadIdx.x;
  const int j_begin = blockIdx.y * tiles_per_split * kTile;
  const int j_end = min(deg, j_begin + tiles_per_split * kTile);
  T tr[kR], ti[kR], acc_re[kR], acc_im[kR];
  int self[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = row0 + r * kThreads;
    const V z = i < m ? zt[i] : V{T(0), T(0)};
    tr[r] = z.x;
    ti[r] = z.y;
    self[r] = i < m ? t_idx[i] : -1;
    acc_re[r] = T(0);
    acc_im[r] = T(0);
  }
  for (int j0 = j_begin; j0 < j_end; j0 += kTile) {
    __syncthreads();  // previous tile fully consumed
    for (int k = threadIdx.x; k < kTile; k += kThreads) {
      if (j0 + k < deg) zs[k] = za[j0 + k];
    }
    __syncthreads();
    const int nj = min(kTile, deg - j0);
    A tile_re[kR], tile_im[kR];
    int self_k[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      tile_re[r] = A(0);
      tile_im[r] = A(0);
      self_k[r] = self[r] - j0;
    }
#pragma unroll 4
    for (int k = 0; k < nj; ++k) {
      const V zj = zs[k];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const A dr = static_cast<A>(tr[r] - zj.x);
        const A di = static_cast<A>(ti[r] - zj.y);
        const A inv = k == self_k[r] ? A(0) : recip(dr * dr + di * di);
        tile_re[r] += dr * inv;
        tile_im[r] -= di * inv;
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      acc_re[r] += static_cast<T>(tile_re[r]);
      acc_im[r] += static_cast<T>(tile_im[r]);
    }
  }
  V* out = reinterpret_cast<V*>(part) + (b * gridDim.y + blockIdx.y) * m;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = row0 + r * kThreads;
    if (i < m) out[i] = V{acc_re[r], acc_im[r]};
  }
}

// out[b][i] = sum over s = 0, 1, ..., splits - 1 of part[b][s][i], in that
// order, for the batch * m outputs.
template <typename T>
__global__ void sum_splits_kernel(const T* __restrict__ part, T* __restrict__ out,
                                  int m, int splits, size_t total) {
  using V = typename Vec2<T>::type;
  const size_t k = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= total) return;
  const size_t b = k / m, i = k % m;
  const V* p = reinterpret_cast<const V*>(part) + b * splits * m;
  V acc = V{T(0), T(0)};
  for (int s = 0; s < splits; ++s) {
    const V v = p[static_cast<size_t>(s) * m + i];
    acc.x += v.x;
    acc.y += v.y;
  }
  reinterpret_cast<V*>(out)[k] = acc;
}

// Tiles of z_all per split and number of splits on the current device: each
// split covers whole tiles, and there are enough splits for the grid of row
// blocks x splits to hold kBlocksPerSm blocks on every SM, as far as the
// tiles allow.
cudaError_t split_of(int deg, int m, int* per, int* splits) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = (deg + kTile - 1) / kTile;
  const int row_blocks = std::max(1, (m + kRows - 1) / kRows);
  const int want = (kBlocksPerSm * sms + row_blocks - 1) / row_blocks;
  *per = std::max(1, tiles / std::max(1, std::min(want, tiles)));
  *splits = std::max(1, (tiles + *per - 1) / *per);
  return cudaSuccess;
}

template <typename T, typename A>
int launch(const void* z_all, const void* z_t, const void* t_idx, void* out,
           void* part, int batch, int deg, int m, int tiles_per_split,
           int splits, cudaStream_t st) {
  T* dst = static_cast<T*>(splits > 1 ? part : out);
  const dim3 grid((m + kRows - 1) / kRows, splits, batch);
  repulsion_partial_kernel<T, A><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(z_all), static_cast<const T*>(z_t),
      static_cast<const int*>(t_idx), dst, deg, m, tiles_per_split);
  if (splits > 1) {
    const size_t total = static_cast<size_t>(batch) * m;
    sum_splits_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256,
                           0, st>>>(dst, static_cast<T*>(out), m, splits,
                                    total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of m complex values of scratch that fnft_repulsion_sum needs for
// each batch row on the current device, into *rows (1: none, the output
// serves). Returns the cudaError_t of the device query (0 = success).
extern "C" int fnft_repulsion_scratch_rows(int deg, int m, int* rows) {
  int per = 0;
  return static_cast<int>(split_of(deg, m, &per, rows));
}

// z_all [batch, deg], z_t and out [batch, m], t_idx [m] shared by the rows.
// Launches on `stream`, which belongs to the caller's current device. The j
// range is cut into splits of whole tiles (split_of); with more than one
// split, `part` is scratch of batch x `part_rows` x m complex values,
// `part_rows` at least fnft_repulsion_scratch_rows, and is otherwise not
// touched. Returns the cudaError_t of the launches (0 = success).
extern "C" int fnft_repulsion_sum(const void* z_all, const void* z_t,
                                  const void* t_idx, void* out, void* part,
                                  int part_rows, int batch, int deg, int m,
                                  int is_double, int lowprec, void* stream) {
  if (m <= 0 || batch <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int per = 0, splits = 0;
  const cudaError_t err = split_of(deg, m, &per, &splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1 && part_rows < splits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_double)
    return launch<float, float>(z_all, z_t, t_idx, out, part, batch, deg, m,
                                per, splits, st);
  if (lowprec)
    return launch<double, float>(z_all, z_t, t_idx, out, part, batch, deg,
                                 m, per, splits, st);
  return launch<double, double>(z_all, z_t, t_idx, out, part, batch, deg, m,
                                per, splits, st);
}
