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
// 576 B written per subtree; at L=3: 1536 B and 1088 B). Both designs are
// persistent blocks walking over spans of consecutive subtrees (one
// contiguous stretch of the input). A span is copied into shared memory by
// coalesced cp.async, one complex value a thread and copy, and the next
// span's copy is in flight while the block computes this one (two
// buffers). Outputs are staged in shared memory in rows padded to an odd
// length and leave in coalesced stores. The exponent comes from ilogb and
// the scale from scalbn, both exact. fp64 for complex128, fp32 for
// complex64; the TPU kernel's 128-lane transpose is a tiling artefact and
// is not carried over.
//
// L <= 2: one thread owns one subtree and keeps every intermediate product
// in registers. Spans of 64 subtrees, 64 threads a block. Each subtree's
// row is padded to an odd number of complex values, so the threads of a
// warp, each reading its own row, hit distinct banks; the outputs go back
// into the buffer just read.
//
// L = 3 (C = 3, 4: the tree then has no direct-convolution level left):
// one thread a subtree would hold 4 (8 C - 7) complex outputs and spill, so
// a team of eight threads (a quarter warp, synchronised by __syncwarp)
// takes a subtree in three steps, exchanging the products of each level
// through shared memory. With the subtree A0..A7 (time order):
//   (1) P_m = A_{2m+1} A_{2m}: thread (m, j) the column j of P_m;
//   (2) Q_h = P_{2h+1} P_{2h}: thread (h, i, j) the entry (i, j) of Q_h,
//       written over the subtree's input row, read in full by then;
//   (3) R = Q_1 Q_0: thread (k, i, j) the term Q_1[i][k] Q_0[k][j] of the
//       entry (i, j); the two threads of an entry add their terms by a
//       shuffle, each finishing half of its coefficients, and the team's
//       maximum comes from three more shuffles.
// No thread holds more than (8 C - 7) + (4 C - 3) complex values. The
// strides of the shared-memory layouts (A: entry C|1, matrix odd; P:
// entry 2 C - 1, matrix = 2 mod 4; Q: dense, entry 4 C - 3) put the values
// that one step's eight threads read at once on distinct banks. A span is
// the largest multiple of four subtrees, up to 16, of which two blocks fit
// on an SM.
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

// K1 at L <= 2, one thread a subtree; the instances at L = 3 are
// specialized below.
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

// ---------------------------------------------------------------------------
// L = 3: a team of eight threads a subtree (see the top of the file).
// ---------------------------------------------------------------------------

template <typename T, int N>
__device__ __forceinline__ void zero(T (&x)[N][2]) {
#pragma unroll
  for (int k = 0; k < N; ++k) x[k][0] = x[k][1] = T(0);
}

template <typename T, int N>
__device__ __forceinline__ void load_row(const typename Vec2<T>::type* src, T (&x)[N][2]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const typename Vec2<T>::type v = src[k];
    x[k][0] = v.x;
    x[k][1] = v.y;
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_row(typename Vec2<T>::type* dst, const T (&x)[N][2]) {
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = typename Vec2<T>::type{x[k][0], x[k][1]};
}

// acc[s + t] += b[s] a[t] for s < NB, t < NA, b read once from `b`.
template <typename T, int NB, int NA>
__device__ __forceinline__ void convolve(const typename Vec2<T>::type* b,
                                         const T (&a)[NA][2], T (&acc)[NA + NB - 1][2]) {
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    const typename Vec2<T>::type v = b[s];
#pragma unroll
    for (int t = 0; t < NA; ++t) {
      acc[s + t][0] += v.x * a[t][0] - v.y * a[t][1];
      acc[s + t][1] += v.x * a[t][1] + v.y * a[t][0];
    }
  }
}

constexpr int kTeam = 8;              // threads a subtree
constexpr long kSmemPerSm = 233472;   // bytes of shared memory an sm_90 SM has
constexpr long kSmemReserved = 1024;  // bytes the system takes a block

// Largest multiple of 4 subtrees, up to 16, whose block fits twice on an SM.
constexpr int team_span(long row_bytes) {
  int s = 16;
  while (s > 4 && 2 * (s * row_bytes + kSmemReserved) > kSmemPerSm) s -= 4;
  return s;
}

// Sizes in complex values. A subtree has an input row (twice, one a
// buffer) and a work row.
template <typename T, int C>
struct Team {
  using V = typename Vec2<T>::type;
  static constexpr int kM1 = 2 * C - 1, kM2 = 4 * C - 3, kM3 = 8 * C - 7;
  static constexpr int kIn = 32 * C;     // a subtree's input in device memory
  static constexpr int kOut = 4 * kM3;   // and its output
  // Input row: A_m[e][c] at m kAM + e kAE + c; later Q_h[e] at (4 h + e) kM2.
  static constexpr int kAE = C | 1;
  static constexpr int kAM = (4 * kAE) | 1;
  static constexpr int kInRow = (8 * kAM) | 1;
  // Work row: P_m[e] at m kPM + e kM1; later R[e] at e kM3 (the output).
  static constexpr int kPM = 4 * kM1 + 2;
  static constexpr int kWRow = (4 * kPM > kOut ? 4 * kPM : kOut) | 1;
  static_assert(8 * kM2 <= kInRow, "Q is staged in the input row");
  static constexpr long kRowBytes = (2 * kInRow + kWRow) * sizeof(V);
  static constexpr int kSpan = team_span(kRowBytes);
  static constexpr int kThreads = kTeam * kSpan;
  static constexpr int kBuf = kSpan * kInRow;
  static constexpr int kSmem = static_cast<int>(kSpan * kRowBytes);

  // Place in the input row of the value at `off` of the device row.
  __device__ __forceinline__ static int in_place(int off) {
    const int m = off / (4 * C), e = (off / C) & 3, c = off % C;
    return m * kAM + e * kAE + c;
  }

  // The subtree of input row `arow` and work row `wrow` by the team's
  // thread r; `mask` holds the team's lanes.
  __device__ __forceinline__ static void subtree(V* arow, V* wrow, int r, unsigned mask,
                                                 int* __restrict__ w, int normalize) {
    {
      // (1) thread (m, j): P_m[i][j] = sum_k A_{2m+1}[i][k] A_{2m}[k][j]
      const int m = r >> 1, j = r & 1;
      T acc[2][kM1][2];
      zero<T, kM1>(acc[0]);
      zero<T, kM1>(acc[1]);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        T a[C][2];
        load_row<T, C>(arow + 2 * m * kAM + (2 * k + j) * kAE, a);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          convolve<T, C, C>(arow + (2 * m + 1) * kAM + (2 * i + k) * kAE, a, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) store_row<T, kM1>(wrow + m * kPM + (2 * i + j) * kM1, acc[i]);
    }
    __syncwarp(mask);
    {
      // (2) thread (h, i, j): Q_h[i][j] = sum_k P_{2h+1}[i][k] P_{2h}[k][j]
      const int h = r >> 2, i = (r >> 1) & 1, j = r & 1;
      T acc[kM2][2];
      zero<T, kM2>(acc);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        T a[kM1][2];
        load_row<T, kM1>(wrow + 2 * h * kPM + (2 * k + j) * kM1, a);
        convolve<T, kM1, kM1>(wrow + (2 * h + 1) * kPM + (2 * i + k) * kM1, a, acc);
      }
      store_row<T, kM2>(arow + (4 * h + 2 * i + j) * kM2, acc);
    }
    __syncwarp(mask);
    // (3) thread (k, i, j): the term Q_1[i][k] Q_0[k][j] of R[i][j]; the
    // partner r ^ 4 has the other term. Thread k finishes the coefficients
    // [k H, k H + H) of the entry.
    const int k = r >> 2, i = (r >> 1) & 1, j = r & 1;
    constexpr int H = (kM3 + 1) / 2;
    T acc[kM3][2];
    zero<T, kM3>(acc);
    {
      T a[kM2][2];
      load_row<T, kM2>(arow + (2 * k + j) * kM2, a);
      convolve<T, kM2, kM2>(arow + (4 + 2 * i + k) * kM2, a, acc);
    }
    T mx = T(0);
#pragma unroll
    for (int u = 0; u < H; ++u) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const T lo = acc[u][c];
        const T hi = u + H < kM3 ? acc[u + H][c] : T(0);
        const T other = __shfl_xor_sync(mask, k ? lo : hi, 4);
        acc[u][c] = (k ? hi : lo) + other;  // T_0 + T_1 on both threads
        mx = max(mx, abs_t(acc[u][c]));
      }
    }
    int ex = 0;
    T scale = T(1);
    if (normalize) {
#pragma unroll
      for (int lane = 1; lane < kTeam; lane <<= 1)
        mx = max(mx, __shfl_xor_sync(mask, mx, lane));
      if (mx > T(0)) {
        ex = ilogb_t(mx);
        scale = scalbn_t(T(1), -ex);
      }
    }
    if (r == 0) *w = ex;
    V* o = wrow + (2 * i + j) * kM3 + k * H;
#pragma unroll
    for (int u = 0; u < H; ++u) {
      if (k == 0 || u + H < kM3) o[u] = V{acc[u][0] * scale, acc[u][1] * scale};
    }
  }
};

// Subtrees in the span of S subtrees starting at subtree `first`.
template <int S>
__device__ __forceinline__ int team_span_size(int64_t first, int64_t n_sub) {
  return n_sub - first < S ? static_cast<int>(n_sub - first) : S;
}

// Starts the copy of span `span` into `buf`, in Team::in_place layout.
template <typename T, int C>
__device__ __forceinline__ void load_team_span(typename Vec2<T>::type* buf,
                                               const typename Vec2<T>::type* __restrict__ in,
                                               int64_t span, int64_t n_sub) {
  using Tm = Team<T, C>;
  const int64_t first = span * Tm::kSpan;
  const int total = team_span_size<Tm::kSpan>(first, n_sub) * Tm::kIn;
  const typename Vec2<T>::type* src = in + first * Tm::kIn;
  for (int k = threadIdx.x; k < total; k += Tm::kThreads) {
    const int sub = k / Tm::kIn;
    cp_async(buf + sub * Tm::kInRow + Tm::in_place(k - sub * Tm::kIn), src + k);
  }
  cp_async_commit();
}

// The body of fused_levels_kernel<T, 3, C>: persistent over spans as above,
// the outputs staged in the work rows.
template <typename T, int C>
__device__ __forceinline__ void team_levels(const T* __restrict__ in, T* __restrict__ out,
                                            int* __restrict__ w, int64_t n_sub,
                                            int normalize) {
  using V = typename Vec2<T>::type;
  using Tm = Team<T, C>;
  extern __shared__ __align__(16) unsigned char smem[];
  V* const bufs = reinterpret_cast<V*>(smem);
  V* const work = bufs + 2 * Tm::kBuf;
  const V* gin = reinterpret_cast<const V*>(in);
  V* gout = reinterpret_cast<V*>(out);
  const int team = threadIdx.x / kTeam;
  const int64_t n_span = (n_sub + Tm::kSpan - 1) / Tm::kSpan;
  int64_t span = blockIdx.x;
  if (span >= n_span) return;
  load_team_span<T, C>(bufs, gin, span, n_sub);
  for (int b = 0; span < n_span; span += gridDim.x, b ^= 1) {
    V* const buf = bufs + b * Tm::kBuf;
    cp_async_wait_all();
    __syncthreads();  // this span has landed; the other buffer and the work
                      // rows are free
    if (span + gridDim.x < n_span)
      load_team_span<T, C>(bufs + (b ^ 1) * Tm::kBuf, gin, span + gridDim.x, n_sub);
    const int64_t first = span * Tm::kSpan;
    const int subs = team_span_size<Tm::kSpan>(first, n_sub);
    if (team < subs)
      Tm::subtree(buf + team * Tm::kInRow, work + team * Tm::kWRow, threadIdx.x % kTeam,
                  0xffu << (threadIdx.x & 24), w + first + team, normalize);
    __syncthreads();  // every output is in the work rows
    V* dst = gout + first * Tm::kOut;
    for (int k = threadIdx.x; k < subs * Tm::kOut; k += Tm::kThreads) {
      const int sub = k / Tm::kOut;
      dst[k] = work[sub * Tm::kWRow + (k - sub * Tm::kOut)];
    }
  }
}

#define FNFT_K1_TEAM_KERNEL(T_, C_)                                               \
  template <>                                                                     \
  __global__ void __launch_bounds__(Team<T_, C_>::kThreads)                       \
  fused_levels_kernel<T_, 3, C_>(const T_* __restrict__ in, T_* __restrict__ out, \
                                 int* __restrict__ w, int64_t n_sub, int normalize) { \
    team_levels<T_, C_>(in, out, w, n_sub, normalize);                            \
  }
FNFT_K1_TEAM_KERNEL(double, 3)
FNFT_K1_TEAM_KERNEL(double, 4)
FNFT_K1_TEAM_KERNEL(float, 3)
FNFT_K1_TEAM_KERNEL(float, 4)
#undef FNFT_K1_TEAM_KERNEL

// Threads a block, subtrees a span and dynamic shared memory a block of
// the instance <T, L, C>.
template <typename T, int L, int C>
struct Launch {
  static constexpr int kBlock = kThreads, kSpan = kThreads;
  static constexpr int kSmem =
      static_cast<int>(2 * Layout<L, C>::kBuf * sizeof(typename Vec2<T>::type));
};
template <typename T, int C>
struct Launch<T, 3, C> {
  static constexpr int kBlock = Team<T, C>::kThreads, kSpan = Team<T, C>::kSpan;
  static constexpr int kSmem = Team<T, C>::kSmem;
};

// Blocks of the instance that fit on one SM of the current device.
template <typename T, int L, int C>
cudaError_t blocks_per_sm(int* per_sm) {
  using Ln = Launch<T, L, C>;
  auto kernel = fused_levels_kernel<T, L, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ln::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, Ln::kBlock,
                                                        Ln::kSmem);
  return err;
}

template <typename T, int L, int C>
int launch(const void* in, void* out, void* w, long long n_sub, int normalize,
           cudaStream_t stream) {
  using Ln = Launch<T, L, C>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm<T, L, C>(&per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long spans = (n_sub + Ln::kSpan - 1) / Ln::kSpan;
  const long long fit = static_cast<long long>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(spans < fit ? spans : fit);
  fused_levels_kernel<T, L, C><<<blocks, Ln::kBlock, Ln::kSmem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), static_cast<int*>(w),
      static_cast<int64_t>(n_sub), normalize);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FNFT_K1_INSTANCES(X) X(2, 2) X(2, 3) X(2, 4) X(3, 3) X(3, 4)

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
  FNFT_K1_INSTANCES(FNFT_K1_CASE)
#undef FNFT_K1_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch configuration of the instance (levels, c_in, is_double) on the
// current device: cfg = {subtrees a span, threads a block, dynamic shared
// memory a block in bytes, blocks an SM}. Returns a cudaError_t as above.
extern "C" int fnft_fused_tree_levels_config(int levels, int c_in, int is_double,
                                             int* cfg) {
#define FNFT_K1_CFG_T(T_, L_, C_)                       \
  cfg[0] = Launch<T_, L_, C_>::kSpan;                   \
  cfg[1] = Launch<T_, L_, C_>::kBlock;                  \
  cfg[2] = Launch<T_, L_, C_>::kSmem;                   \
  return static_cast<int>(blocks_per_sm<T_, L_, C_>(cfg + 3));
#define FNFT_K1_CFG(L_, C_)                             \
  if (levels == L_ && c_in == C_) {                     \
    if (is_double) {                                    \
      FNFT_K1_CFG_T(double, L_, C_)                     \
    }                                                   \
    FNFT_K1_CFG_T(float, L_, C_)                        \
  }
  FNFT_K1_INSTANCES(FNFT_K1_CFG)
#undef FNFT_K1_CFG
#undef FNFT_K1_CFG_T
  return static_cast<int>(cudaErrorInvalidValue);
}
