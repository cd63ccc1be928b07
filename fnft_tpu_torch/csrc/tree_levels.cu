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
// The kernel reads each input matrix once and writes each output once, so
// it is bound by device-memory bytes (at L=2, C=3 in fp64: 768 B read and
// 576 B written per subtree). Design: one thread owns one subtree and keeps
// every intermediate product in registers (fp64 for complex128, fp32 for
// complex64); the TPU kernel's 128-lane transpose is a tiling artefact and
// is not carried over. A block of 64 threads walks over spans of 64
// subtrees (one contiguous stretch of the input) in a persistent loop. A
// span is copied into shared memory by coalesced cp.async, one complex
// value a thread and copy, and the next span's copy is in flight while the
// block computes this one (two buffers). In shared memory each subtree's
// row is padded to an odd number of complex values, so the threads of a
// warp, each reading its own row, hit distinct banks. The outputs go back
// into the buffer just read, in rows padded the same way, and leave it in
// coalesced stores. The exponent comes from ilogb and the scale from
// scalbn, both exact.
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

template <typename T> struct Vec2;
template <> struct Vec2<double> { using type = double2; };
template <> struct Vec2<float> { using type = float2; };

// Product of the 2^L matrices starting at `in` ([2^L][4][C] complex).
template <typename T, int L, int C>
struct Subtree {
  using V = typename Vec2<T>::type;
  static constexpr int kOut = (C - 1) * (1 << L) + 1;

  __device__ __forceinline__ static void run(const V* in, T (&out)[4][kOut][2]) {
    if constexpr (L == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const V v = in[e * C + c];
          out[e][c][0] = v.x;
          out[e][c][1] = v.y;
        }
      }
    } else {
      constexpr int kHalf = Subtree<T, L - 1, C>::kOut;
      T a[4][kHalf][2];
      T b[4][kHalf][2];
      Subtree<T, L - 1, C>::run(in, a);                          // earlier
      Subtree<T, L - 1, C>::run(in + (1 << (L - 1)) * 4 * C, b);  // later
      matpoly_product<T, kHalf>(b, a, out);
    }
  }
};

constexpr int kThreads = 64;  // threads per block = subtrees per span

// Complex values per subtree in and out, and their rows in shared memory,
// padded to an odd length.
template <int L, int C>
struct Layout {
  static constexpr int kIn = (1 << L) * 4 * C;
  static constexpr int kOut = 4 * ((C - 1) * (1 << L) + 1);
  static constexpr int kInRow = kIn | 1;
  static constexpr int kOutRow = kOut | 1;
  static constexpr int kBuf = kThreads * kInRow;  // complex values a buffer
  static_assert(kOutRow <= kInRow, "outputs are staged in the input buffer");
};

__device__ __forceinline__ void cp_async(double2* dst, const double2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async(float2* dst, const float2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Subtrees in the span starting at subtree `first`.
__device__ __forceinline__ int span_size(int64_t first, int64_t n_sub) {
  return n_sub - first < kThreads ? static_cast<int>(n_sub - first) : kThreads;
}

// Starts the copy of span `span` (subtrees [span * kThreads, +kThreads) of
// n_sub) into `buf`, one row of kInRow complex values a subtree.
template <typename V, int L, int C>
__device__ __forceinline__ void load_span(V* buf, const V* __restrict__ in,
                                          int64_t span, int64_t n_sub) {
  using Ly = Layout<L, C>;
  const int64_t first = span * kThreads;
  const int total = span_size(first, n_sub) * Ly::kIn;
  const V* src = in + first * Ly::kIn;
  for (int k = threadIdx.x; k < total; k += kThreads) {
    const int sub = k / Ly::kIn;
    cp_async(buf + sub * Ly::kInRow + (k - sub * Ly::kIn), src + k);
  }
  cp_async_commit();
}

template <typename T, int L, int C>
__global__ void __launch_bounds__(kThreads)
fused_levels_kernel(const T* __restrict__ in, T* __restrict__ out,
                    int* __restrict__ w, int64_t n_sub, int normalize) {
  using V = typename Vec2<T>::type;
  using Ly = Layout<L, C>;
  constexpr int kOut = Subtree<T, L, C>::kOut;
  extern __shared__ __align__(16) unsigned char smem[];
  V* const bufs = reinterpret_cast<V*>(smem);
  const V* gin = reinterpret_cast<const V*>(in);
  V* gout = reinterpret_cast<V*>(out);
  const int64_t n_span = (n_sub + kThreads - 1) / kThreads;
  int64_t span = blockIdx.x;
  if (span >= n_span) return;
  load_span<V, L, C>(bufs, gin, span, n_sub);
  for (int b = 0; span < n_span; span += gridDim.x, b ^= 1) {
    V* const buf = bufs + b * Ly::kBuf;
    cp_async_wait_all();
    __syncthreads();  // this span has landed; the other buffer is free
    if (span + gridDim.x < n_span)
      load_span<V, L, C>(bufs + (b ^ 1) * Ly::kBuf, gin, span + gridDim.x, n_sub);
    const int64_t first = span * kThreads;
    const int subs = span_size(first, n_sub);
    const bool live = threadIdx.x < subs;
    T prod[4][kOut][2];
    if (live) Subtree<T, L, C>::run(buf + threadIdx.x * Ly::kInRow, prod);
    __syncthreads();  // every row read: the buffer takes the outputs
    if (live) {
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
      w[first + threadIdx.x] = ex;
      V* o = buf + threadIdx.x * Ly::kOutRow;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int k = 0; k < kOut; ++k) {
          o[e * kOut + k] = V{prod[e][k][0] * scale, prod[e][k][1] * scale};
        }
      }
    }
    __syncthreads();
    V* dst = gout + first * Ly::kOut;
    for (int k = threadIdx.x; k < subs * Ly::kOut; k += kThreads) {
      const int sub = k / Ly::kOut;
      dst[k] = buf[sub * Ly::kOutRow + (k - sub * Ly::kOut)];
    }
  }
}

template <typename T, int L, int C>
int launch(const void* in, void* out, void* w, long long n_sub, int normalize,
           cudaStream_t stream) {
  auto kernel = fused_levels_kernel<T, L, C>;
  const int smem = static_cast<int>(2 * Layout<L, C>::kBuf * sizeof(typename Vec2<T>::type));
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long spans = (n_sub + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(
      spans < static_cast<long long>(per_sm) * sms ? spans
                                                   : static_cast<long long>(per_sm) * sms);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), static_cast<int*>(w),
      static_cast<int64_t>(n_sub), normalize);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`, which belongs to the caller's current device, with
// as many persistent blocks as fit on its SMs. Returns the cudaError_t of
// the launch (0 = success). (levels, c_in) pairs other than the
// instantiated ones give cudaErrorInvalidValue.
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
