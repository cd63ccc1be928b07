// K1: the first L levels of the fmult tree, fused (sm_90a).
//
// Replaces the Pallas TPU kernel fnft_tpu/ops/pallas_kernels.py:113
// (fused_tree_levels / _fused_levels_kernel). Input is a stack of 2x2
// polynomial matrices [..., n, 2, 2, C] (complex, interleaved re/im, ascending
// coefficients). Each subtree of 2^L consecutive matrices is multiplied
// later @ earlier by direct coefficient convolution, in tree order (pairs
// first), giving [..., n / 2^L, 2, 2, (C - 1) 2^L + 1]. With `normalize`
// the subtree is rescaled by an exact power of two so that
// max(|re|, |im|) over all its entries lies in [1, 2); the exponent goes to
// w (true = stored * 2^w), otherwise w = 0.
//
// Design: one thread owns one subtree and keeps every intermediate product
// in registers (fp64 for complex128, fp32 for complex64); the TPU kernel's
// 128-lane transpose is a tiling artefact and is not carried over. The
// kernel streams each input matrix once and writes each output once, so it
// is bound by device-memory bytes (at L=2, C=3 in fp64: 768 B read and
// 576 B written per subtree); the exponent comes from ilogb and the scale
// from scalbn, both exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int ilogb_t(double x) { return ilogb(x); }
__device__ __forceinline__ int ilogb_t(float x) { return ilogbf(x); }
__device__ __forceinline__ double scalbn_t(double x, int e) { return scalbn(x, e); }
__device__ __forceinline__ float scalbn_t(float x, int e) { return scalbnf(x, e); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }

// out = b @ a for 2x2 matrices of polynomials with CA coefficients each,
// accumulated as the plain version does: for each coefficient of b, the
// two-term matrix entry sum is added to the output coefficients.
template <typename T, int CA>
__device__ __forceinline__ void matpoly_product(const T (&b)[4][CA][2],
                                                const T (&a)[4][CA][2],
                                                T (&out)[4][2 * CA - 1][2]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int t = 0; t < 2 * CA - 1; ++t) {
      out[e][t][0] = T(0);
      out[e][t][1] = T(0);
    }
  }
#pragma unroll
  for (int cb = 0; cb < CA; ++cb) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const T b0r = b[2 * i][cb][0], b0i = b[2 * i][cb][1];
        const T b1r = b[2 * i + 1][cb][0], b1i = b[2 * i + 1][cb][1];
#pragma unroll
        for (int ca = 0; ca < CA; ++ca) {
          const T a0r = a[j][ca][0], a0i = a[j][ca][1];
          const T a1r = a[2 + j][ca][0], a1i = a[2 + j][ca][1];
          const T re = (b0r * a0r - b0i * a0i) + (b1r * a1r - b1i * a1i);
          const T im = (b0r * a0i + b0i * a0r) + (b1r * a1i + b1i * a1r);
          out[2 * i + j][cb + ca][0] += re;
          out[2 * i + j][cb + ca][1] += im;
        }
      }
    }
  }
}

// Product of the 2^L matrices starting at `in` (interleaved [2^L][4][C][2]).
template <typename T, int L, int C>
struct Subtree {
  static constexpr int kOut = (C - 1) * (1 << L) + 1;

  __device__ __forceinline__ static void run(const T* __restrict__ in,
                                             T (&out)[4][kOut][2]) {
    if constexpr (L == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          out[e][c][0] = in[(e * C + c) * 2];
          out[e][c][1] = in[(e * C + c) * 2 + 1];
        }
      }
    } else {
      constexpr int kHalf = Subtree<T, L - 1, C>::kOut;
      T a[4][kHalf][2];
      T b[4][kHalf][2];
      Subtree<T, L - 1, C>::run(in, a);                              // earlier
      Subtree<T, L - 1, C>::run(in + (1 << (L - 1)) * 4 * C * 2, b);  // later
      matpoly_product<T, kHalf>(b, a, out);
    }
  }
};

constexpr int kThreads = 128;

template <typename T, int L, int C>
__global__ void __launch_bounds__(kThreads)
fused_levels_kernel(const T* __restrict__ in, T* __restrict__ out,
                    int* __restrict__ w, int64_t n_sub, int normalize) {
  constexpr int kOut = Subtree<T, L, C>::kOut;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n_sub) return;
  T prod[4][kOut][2];
  Subtree<T, L, C>::run(in + s * ((1 << L) * 4 * C * 2), prod);
  int ex = 0;
  T scale = T(1);
  if (normalize) {
    T mx = T(0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        mx = max(mx, max(abs_t(prod[e][k][0]), abs_t(prod[e][k][1])));
      }
    }
    if (mx > T(0)) {
      ex = ilogb_t(mx);
      scale = scalbn_t(T(1), -ex);
    }
  }
  w[s] = ex;
  T* o = out + s * (4 * kOut * 2);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      o[(e * kOut + k) * 2] = prod[e][k][0] * scale;
      o[(e * kOut + k) * 2 + 1] = prod[e][k][1] * scale;
    }
  }
}

template <typename T, int L, int C>
int launch(const void* in, void* out, void* w, long long n_sub, int normalize,
           cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n_sub + kThreads - 1) / kThreads);
  fused_levels_kernel<T, L, C><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), static_cast<int*>(w),
      static_cast<int64_t>(n_sub), normalize);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`, which belongs to the caller's current device. Returns
// the cudaError_t of the launch (0 = success). (levels, c_in) pairs other
// than the instantiated ones give cudaErrorInvalidValue.
extern "C" int fnft_fused_tree_levels(const void* in, void* out, void* w,
                                      long long n_sub, int levels, int c_in,
                                      int is_double, int normalize,
                                      void* stream) {
  if (n_sub <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FNFT_K1_CASE(L_, C_)                                              \
  if (levels == L_ && c_in == C_) {                                       \
    return is_double ? launch<double, L_, C_>(in, out, w, n_sub, normalize, st) \
                     : launch<float, L_, C_>(in, out, w, n_sub, normalize, st); \
  }
  FNFT_K1_CASE(2, 2)
  FNFT_K1_CASE(2, 3)
  FNFT_K1_CASE(2, 4)
#undef FNFT_K1_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
