// K2: Aberth repulsion sum (sm_90a).
//
// Replaces the Pallas TPU kernel fnft_tpu/ops/pallas_kernels.py:254
// (repulsion_sum -> repulsion_sum_planes / _repulsion_kernel):
//
//   s_i = sum_{j != t_idx_i, j < deg} 1 / (z_t_i - z_all_j),   i < m.
//
// Design: one thread per active root, 128 per block; the block streams
// z_all through shared memory in tiles of 512 roots, which every thread
// reads by broadcast. Self-exclusion is by index; the ragged ends of i and
// j are masked. The work is O(m deg) arithmetic on O(m + deg) bytes, so the
// card's FP32/FP64 issue rate bounds it, not memory. The precision
// contract is that of fnft_tpu/ops/roots.py:68-80: differences are formed
// in the input precision T; with `lowprec` the reciprocal and the sum of
// each tile run in float (A = float), and tile sums are accumulated in T.
// Without `lowprec` everything stays in T.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // active roots per block (one per thread)
constexpr int kTile = 512;  // roots of z_all per shared-memory tile

template <typename T, typename A>
__global__ void __launch_bounds__(kRows)
repulsion_kernel(const T* __restrict__ z_all, const T* __restrict__ z_t,
                 const int* __restrict__ t_idx, T* __restrict__ out, int deg,
                 int m) {
  __shared__ T zs[kTile][2];
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool live = i < m;
  T tr = T(0), ti = T(0);
  int self = -1;
  if (live) {
    tr = z_t[2 * i];
    ti = z_t[2 * i + 1];
    self = t_idx[i];
  }
  T acc_re = T(0), acc_im = T(0);
  for (int j0 = 0; j0 < deg; j0 += kTile) {
    __syncthreads();  // previous tile fully consumed
    for (int k = threadIdx.x; k < kTile; k += kRows) {
      const int j = j0 + k;
      if (j < deg) {
        zs[k][0] = z_all[2 * j];
        zs[k][1] = z_all[2 * j + 1];
      }
    }
    __syncthreads();
    if (live) {
      const int nj = min(kTile, deg - j0);
      A tile_re = A(0), tile_im = A(0);
      for (int k = 0; k < nj; ++k) {
        if (j0 + k == self) continue;
        const A dr = static_cast<A>(tr - zs[k][0]);
        const A di = static_cast<A>(ti - zs[k][1]);
        const A inv = A(1) / (dr * dr + di * di);
        tile_re += dr * inv;
        tile_im -= di * inv;
      }
      acc_re += static_cast<T>(tile_re);
      acc_im += static_cast<T>(tile_im);
    }
  }
  if (live) {
    out[2 * i] = acc_re;
    out[2 * i + 1] = acc_im;
  }
}

template <typename T, typename A>
int launch(const void* z_all, const void* z_t, const void* t_idx, void* out,
           int deg, int m, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((m + kRows - 1) / kRows);
  repulsion_kernel<T, A><<<blocks, kRows, 0, stream>>>(
      static_cast<const T*>(z_all), static_cast<const T*>(z_t),
      static_cast<const int*>(t_idx), static_cast<T*>(out), deg, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`, which belongs to the caller's current device. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int fnft_repulsion_sum(const void* z_all, const void* z_t,
                                  const void* t_idx, void* out, int deg, int m,
                                  int is_double, int lowprec, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_double) return launch<float, float>(z_all, z_t, t_idx, out, deg, m, st);
  if (lowprec) return launch<double, float>(z_all, z_t, t_idx, out, deg, m, st);
  return launch<double, double>(z_all, z_t, t_idx, out, deg, m, st);
}
