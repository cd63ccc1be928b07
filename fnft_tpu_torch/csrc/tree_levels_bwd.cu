// K1T: the backward (vector-Jacobian product) of K1, the fused first two
// levels of the fmult tree (sm_90a).
//
// K1 (tree_levels.cu) replaces the Pallas TPU kernel
// fnft_tpu/ops/pallas_kernels.py:113 (fused_tree_levels). The JAX package
// has no backward kernel: it differentiates its plain levels. Here the
// forward is a kernel, so its gradient is one too.
//
// A subtree is four consecutive 2x2 polynomial matrices A0..A3 (time
// order, C coefficients each, [4][2][2][C] complex, interleaved re/im).
// K1 computes P = A1 A0, Q = A3 A2 and R = Q P (each product a 2x2 matrix
// product with polynomial convolution) and stores R 2^-w. Given the
// cotangent g of the stored output and the integer exponents w (constants
// of the derivative), with G = g 2^-w this kernel writes
//   g_Q = G * P^H,  g_P = Q^H * G,
//   g_A3 = g_Q * A2^H,  g_A2 = A3^H * g_Q,  g_A1 = g_P * A0^H,
//   g_A0 = A1^H * g_P,
// where * is the correlation that is the adjoint of the convolution:
// for c = b a, g_b[i][k][s] = sum_{j,t} g[i][j][s+t] conj(a[k][j][t]) and
// g_a[k][j][t] = sum_{i,s} conj(b[i][k][s]) g[i][j][s+t] (torch's
// convention for a holomorphic map: the cotangent against the conjugate
// Jacobian). Both are out[x] = sum_m sum_y X_m[x+y] conj(Y_m[y]) over two
// entries m of each factor; only which entries differs.
//
// Bound: device-memory bytes. Per subtree it reads 16 C input and
// 4 (4 C - 3) cotangent coefficients and the exponent, and writes 16 C
// gradient coefficients (at C = 3 in fp64: 2116 B); ~6.7k flops at C = 3.
//
// Design. A persistent grid (as many blocks as fit on the SMs) walks over
// spans of kSpan consecutive subtrees. A span's input rows, cotangent
// rows and exponents are contiguous in device memory and are copied into
// shared memory by coalesced cp.async, one value a thread and copy; the
// next span's copy is in flight while the block computes this one (two
// buffers). A team of eight threads (one quarter of a warp, synchronised
// by __syncwarp) computes one subtree in three steps, every intermediate
// in shared memory and no thread holding more than ~4 C complex values:
//   (a) each thread one entry of P or Q (2 C - 1 coefficients);
//   (b) each thread one entry of g_Q or g_P;
//   (c) each thread two entries of one of g_A0..g_A3 (C coefficients each).
// The eight threads of a step run the same code on other entries (the
// entries are picked by per-thread offsets and strides), so a warp does
// not diverge. In shared memory the rows of A are laid out with entry
// stride C|1 and matrix stride 4 (C|1) + 2 (complex values), so that the
// accesses of a team in (a) and (c) fall on distinct banks (at C = 4 the
// dense layout gives 4-way conflicts); P, Q, g_P, g_Q and the cotangent
// keep their dense layout, whose entry strides are odd. The gradients are
// written in the A layout into a work row, and leave it in coalesced
// stores. Each input and cotangent value is read from device memory once
// and each gradient written once; there are no atomics and the order of
// every sum is fixed, so two launches give the same bits. The rescale
// G = g 2^-w is scalbn, exact. fp64 for complex128, fp32 for complex64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Vec2;
template <> struct Vec2<double> { using type = double2; };
template <> struct Vec2<float> { using type = float2; };

__device__ __forceinline__ double scalbn_t(double x, int e) { return scalbn(x, e); }
__device__ __forceinline__ float scalbn_t(float x, int e) { return scalbnf(x, e); }

constexpr int kTeam = 8;  // threads a subtree

// Subtrees a span and threads a block: the fp64 instances take ~3.8 KB
// (C = 2) to ~6.9 KB (C = 4) of shared memory a subtree, the fp32 ones half,
// so 2-3 blocks fit on an SM. kMinBlocks is the launch bound's: with none,
// ptxas holds the fp64 instances to fewer registers than they need and
// spills; with 1 they take 114-148 registers and spill none. The fp32
// instances stay under the 85 registers that three blocks of 256 threads
// allow.
template <typename T>
struct Span {
  static constexpr int kSubtrees = sizeof(T) == 8 ? 16 : 32;
  static constexpr int kThreads = kTeam * kSubtrees;
  static constexpr int kMinBlocks = sizeof(T) == 8 ? 1 : 3;
};

// Sizes in complex values. Per subtree, shared memory holds (twice, one
// buffer a span) an A row and a cotangent row, and (once) a work row:
// g_Q, g_P, then P, Q, whose place the gradients take in step (c).
template <typename T, int C>
struct Layout {
  static constexpr int kES = C | 1;            // entry stride of an A row
  static constexpr int kMS = 4 * kES + 2;      // matrix stride of an A row
  static constexpr int kALen = 4 * kMS;
  static constexpr int kARow = kALen | 1;
  static constexpr int kIn = 16 * C;           // input row in device memory
  static constexpr int kMid = 2 * C - 1;       // coefficients of P, Q
  static constexpr int kOut = 4 * C - 3;       // of R and its cotangent
  static constexpr int kG = 4 * kOut;
  static constexpr int kGRow = kG | 1;
  static constexpr int kPQ = 8 * kMid;         // P, Q (or g_Q, g_P)
  static constexpr int kWRow = (kPQ + (kPQ > kALen ? kPQ : kALen)) | 1;
  static constexpr int kSpan = Span<T>::kSubtrees;
  static constexpr int kThreads = Span<T>::kThreads;
  static constexpr int kBuf = kSpan * (kARow + kGRow);
  static constexpr size_t kSmem =
      (2 * kBuf + kSpan * kWRow) * sizeof(typename Vec2<T>::type) +
      2 * kSpan * sizeof(int);
};

// Place in a shared-memory A row of the value at `off` of a device row.
template <typename T, int C>
__device__ __forceinline__ int a_place(int off) {
  using Ly = Layout<T, C>;
  const int m = off / (4 * C), e = (off / C) & 3, c = off % C;
  return m * Ly::kMS + e * Ly::kES + c;
}

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
__device__ __forceinline__ void cp_async(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of the `subs` subtrees from `first` on: A rows into
// `abuf`, cotangent rows into `gbuf`, exponents into `wbuf`.
template <typename T, int C>
__device__ __forceinline__ void load_span(
    typename Vec2<T>::type* abuf, typename Vec2<T>::type* gbuf, int* wbuf,
    const typename Vec2<T>::type* __restrict__ a,
    const typename Vec2<T>::type* __restrict__ g, const int* __restrict__ w,
    int64_t first, int subs, int normalize) {
  using Ly = Layout<T, C>;
  const typename Vec2<T>::type* src = a + first * Ly::kIn;
  for (int k = threadIdx.x; k < subs * Ly::kIn; k += Ly::kThreads) {
    const int sub = k / Ly::kIn;
    cp_async(abuf + sub * Ly::kARow + a_place<T, C>(k - sub * Ly::kIn), src + k);
  }
  src = g + first * Ly::kG;
  for (int k = threadIdx.x; k < subs * Ly::kG; k += Ly::kThreads) {
    const int sub = k / Ly::kG;
    cp_async(gbuf + sub * Ly::kGRow + (k - sub * Ly::kG), src + k);
  }
  if (normalize) {
    for (int k = threadIdx.x; k < subs; k += Ly::kThreads)
      cp_async(wbuf + k, w + first + k);
  }
  cp_async_commit();
}

// acc[k][x] += X[x + y] conj(Y[k][y]) for x < NX, y < NY and each of the
// K rows of Y, X read once from `x`.
template <typename T, int K, int NX, int NY>
__device__ __forceinline__ void correlate(const typename Vec2<T>::type* x,
                                          const T (&y)[K][NY][2], T (&acc)[K][NX][2]) {
#pragma unroll
  for (int u = 0; u < NX + NY - 1; ++u) {
    const typename Vec2<T>::type v = x[u];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int t = 0; t < NY; ++t) {
        const int s = u - t;
        if (s >= 0 && s < NX) {
          acc[k][s][0] += v.x * y[k][t][0] + v.y * y[k][t][1];
          acc[k][s][1] += v.y * y[k][t][0] - v.x * y[k][t][1];
        }
      }
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void load_row(const typename Vec2<T>::type* src,
                                         T (&x)[N][2]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const typename Vec2<T>::type v = src[k];
    x[k][0] = v.x;
    x[k][1] = v.y;
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_row(typename Vec2<T>::type* dst,
                                          const T (&x)[N][2]) {
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = typename Vec2<T>::type{x[k][0], x[k][1]};
}

template <typename T, int N>
__device__ __forceinline__ void zero(T (&x)[N][2]) {
#pragma unroll
  for (int k = 0; k < N; ++k) x[k][0] = x[k][1] = T(0);
}

// One subtree, by the team's thread r: `arow` its A row, `grow` its
// cotangent row (already scaled by 2^-w), `wrow` its work row.
template <typename T, int C>
__device__ __forceinline__ void subtree_vjp(const typename Vec2<T>::type* arow,
                                            const typename Vec2<T>::type* grow,
                                            typename Vec2<T>::type* wrow, int r,
                                            unsigned mask) {
  using Ly = Layout<T, C>;
  constexpr int kMid = Ly::kMid, kOut = Ly::kOut, kES = Ly::kES, kMS = Ly::kMS;
  const int h = r >> 2, hi = (r >> 1) & 1, lo = r & 1;
  typename Vec2<T>::type* const pq = wrow + Ly::kPQ;  // P, Q; then g_A
  {
    // (a) entry (hi, lo) of P = A1 A0 (h = 0) or Q = A3 A2 (h = 1):
    // sum over k of A_{2h+1}[hi][k] conv A_{2h}[k][lo]
    T acc[kMid][2];
    zero<T, kMid>(acc);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      T b[C][2], a[C][2];
      load_row<T, C>(arow + (2 * h + 1) * kMS + (2 * hi + k) * kES, b);
      load_row<T, C>(arow + 2 * h * kMS + (2 * k + lo) * kES, a);
#pragma unroll
      for (int s = 0; s < C; ++s) {
#pragma unroll
        for (int t = 0; t < C; ++t) {
          acc[s + t][0] += b[s][0] * a[t][0] - b[s][1] * a[t][1];
          acc[s + t][1] += b[s][0] * a[t][1] + b[s][1] * a[t][0];
        }
      }
    }
    store_row<T, kMid>(pq + r * kMid, acc);
  }
  __syncwarp(mask);
  {
    // (b) h = 0: g_Q[hi][lo] = sum_m G[hi][m] corr P[lo][m];
    //     h = 1: g_P[hi][lo] = sum_m G[m][lo] corr Q[m][hi].
    // Work-row slot r: g_Q in 0..3, g_P in 4..7.
    const int xb = h ? lo * kOut : 2 * hi * kOut, xs = h ? 2 * kOut : kOut;
    const int yb = h ? (4 + hi) * kMid : 2 * lo * kMid, ys = h ? 2 * kMid : kMid;
    T acc[1][kMid][2];
    zero<T, kMid>(acc[0]);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      T y[1][kMid][2];
      load_row<T, kMid>(pq + yb + m * ys, y[0]);
      correlate<T, 1, kMid, kMid>(grow + xb + m * xs, y, acc);
    }
    store_row<T, kMid>(wrow + r * kMid, acc[0]);
  }
  __syncwarp(mask);
  {
    // (c) h = 0 takes g_P (slots 4..7) to g_A0, g_A1; h = 1 takes g_Q
    // (slots 0..3) to g_A2, g_A3. hi = 0: the earlier factor's column lo,
    //   g_A_{2h}[kk][lo] = sum_m g[m][lo] corr A_{2h+1}[m][kk];
    // hi = 1: the later factor's row lo,
    //   g_A_{2h+1}[lo][kk] = sum_m g[lo][m] corr A_{2h}[kk][m];
    // for kk = 0, 1, written in the A layout over P and Q.
    const int g0 = h ? 0 : 4;
    const int xb = (g0 + (hi ? 2 * lo : lo)) * kMid, xs = hi ? kMid : 2 * kMid;
    const int yb = (2 * h + 1 - hi) * kMS, ys = hi ? kES : 2 * kES;
    const int yk = hi ? 2 * kES : kES;
    const int ob = (2 * h + hi) * kMS + (hi ? 2 * lo : lo) * kES;
    const int ok = hi ? kES : 2 * kES;
    T acc[2][C][2];
    zero<T, C>(acc[0]);
    zero<T, C>(acc[1]);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      T y[2][C][2];
      load_row<T, C>(arow + yb + m * ys, y[0]);
      load_row<T, C>(arow + yb + m * ys + yk, y[1]);
      correlate<T, 2, C, C>(wrow + xb + m * xs, y, acc);
    }
    store_row<T, C>(pq + ob, acc[0]);
    store_row<T, C>(pq + ob + ok, acc[1]);
  }
}

// Subtrees in span `span` of S subtrees each, of n_sub in all.
template <int S>
__device__ __forceinline__ int span_size(int64_t span, int64_t n_sub) {
  const int64_t left = n_sub - span * S;
  return left < S ? static_cast<int>(left) : S;
}

template <typename T, int C>
__global__ void __launch_bounds__(Span<T>::kThreads, Span<T>::kMinBlocks)
fused_levels_bwd_kernel(const T* __restrict__ p, const int* __restrict__ w,
                        const T* __restrict__ g_out, T* __restrict__ g_in,
                        int64_t n_sub, int normalize) {
  using V = typename Vec2<T>::type;
  using Ly = Layout<T, C>;
  extern __shared__ __align__(16) unsigned char smem[];
  V* const bufs = reinterpret_cast<V*>(smem);          // 2 x [A rows, G rows]
  V* const work = bufs + 2 * Ly::kBuf;                  // work rows
  int* const wbufs = reinterpret_cast<int*>(work + Ly::kSpan * Ly::kWRow);
  const V* ga = reinterpret_cast<const V*>(p);
  const V* gg = reinterpret_cast<const V*>(g_out);
  V* gout = reinterpret_cast<V*>(g_in);
  const int team = threadIdx.x / kTeam, r = threadIdx.x % kTeam;
  const unsigned mask = 0xffu << (threadIdx.x & 24);
  const int64_t n_span = (n_sub + Ly::kSpan - 1) / Ly::kSpan;
  int64_t span = blockIdx.x;
  if (span >= n_span) return;
  load_span<T, C>(bufs, bufs + Ly::kSpan * Ly::kARow, wbufs, ga, gg, w,
                  span * Ly::kSpan, span_size<Ly::kSpan>(span, n_sub), normalize);
  for (int b = 0; span < n_span; span += gridDim.x, b ^= 1) {
    V* const abuf = bufs + b * Ly::kBuf;
    V* const gbuf = abuf + Ly::kSpan * Ly::kARow;
    const int* wbuf = wbufs + b * Ly::kSpan;
    cp_async_wait_all();
    __syncthreads();  // this span has landed; the other buffer and the work
                      // rows are free
    const int64_t next = span + gridDim.x;
    if (next < n_span) {
      V* const nbuf = bufs + (b ^ 1) * Ly::kBuf;
      load_span<T, C>(nbuf, nbuf + Ly::kSpan * Ly::kARow, wbufs + (b ^ 1) * Ly::kSpan,
                      ga, gg, w, next * Ly::kSpan, span_size<Ly::kSpan>(next, n_sub),
                      normalize);
    }
    const int subs = span_size<Ly::kSpan>(span, n_sub);
    if (team < subs) {
      V* const grow = gbuf + team * Ly::kGRow;
      if (normalize) {
        const int ex = wbuf[team];
        for (int k = r; k < Ly::kG; k += kTeam)
          grow[k] = V{scalbn_t(grow[k].x, -ex), scalbn_t(grow[k].y, -ex)};
        __syncwarp(mask);
      }
      subtree_vjp<T, C>(abuf + team * Ly::kARow, grow, work + team * Ly::kWRow, r,
                        mask);
    }
    __syncthreads();  // every gradient is in the work rows
    V* dst = gout + span * Ly::kSpan * Ly::kIn;
    for (int k = threadIdx.x; k < subs * Ly::kIn; k += Ly::kThreads) {
      const int sub = k / Ly::kIn;
      dst[k] = work[sub * Ly::kWRow + Ly::kPQ + a_place<T, C>(k - sub * Ly::kIn)];
    }
  }
}

// Blocks of the instance that fit on one SM of the current device.
template <typename T, int C>
cudaError_t blocks_per_sm(int* per_sm) {
  using Ly = Layout<T, C>;
  auto kernel = fused_levels_bwd_kernel<T, C>;
  const int smem = static_cast<int>(Ly::kSmem);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, Ly::kThreads,
                                                        smem);
  return err;
}

template <typename T, int C>
int launch(const void* p, const void* w, const void* g_out, void* g_in,
           long long n_sub, int normalize, cudaStream_t stream) {
  using Ly = Layout<T, C>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm<T, C>(&per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long spans = (n_sub + Ly::kSpan - 1) / Ly::kSpan;
  const long long fit = static_cast<long long>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(spans < fit ? spans : fit);
  fused_levels_bwd_kernel<T, C><<<blocks, Ly::kThreads, Ly::kSmem, stream>>>(
      static_cast<const T*>(p), static_cast<const int*>(w),
      static_cast<const T*>(g_out), static_cast<T*>(g_in),
      static_cast<int64_t>(n_sub), normalize);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Gradient of fnft_fused_tree_levels in its input: p [n_sub * 4][2][2][c_in]
// (the forward's input), w [n_sub] (its exponents; read only when
// `normalize`, may be NULL otherwise), g_out [n_sub][2][2][4 c_in - 3]
// (cotangent of the forward's output) -> g_in, shaped as p. Launches on
// `stream` (the caller's current device) with as many persistent blocks as
// fit on its SMs. Returns the cudaError_t of the launch (0 = success);
// (levels, c_in) pairs other than the instantiated ones give
// cudaErrorInvalidValue.
extern "C" int fnft_fused_tree_levels_bwd(const void* p, const void* w,
                                          const void* g_out, void* g_in,
                                          long long n_sub, int levels,
                                          int c_in, int is_double,
                                          int normalize, void* stream) {
  if (n_sub <= 0) return 0;
  if (normalize && w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FNFT_K1T_CASE(C_)                                                    \
  if (levels == 2 && c_in == C_) {                                           \
    return is_double ? launch<double, C_>(p, w, g_out, g_in, n_sub, normalize, st) \
                     : launch<float, C_>(p, w, g_out, g_in, n_sub, normalize, st); \
  }
  FNFT_K1T_CASE(2)
  FNFT_K1T_CASE(3)
  FNFT_K1T_CASE(4)
#undef FNFT_K1T_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch configuration of the instance (c_in, is_double) on the current
// device: cfg = {subtrees a span, threads a block, dynamic shared memory a
// block in bytes, blocks an SM}. Returns a cudaError_t as above.
extern "C" int fnft_fused_tree_levels_bwd_config(int c_in, int is_double, int* cfg) {
#define FNFT_K1T_CFG(T_, C_)                                                 \
  if (c_in == C_ && is_double == (sizeof(T_) == 8)) {                        \
    cfg[0] = Layout<T_, C_>::kSpan;                                          \
    cfg[1] = Layout<T_, C_>::kThreads;                                       \
    cfg[2] = static_cast<int>(Layout<T_, C_>::kSmem);                        \
    return static_cast<int>(blocks_per_sm<T_, C_>(cfg + 3));                 \
  }
  FNFT_K1T_CFG(double, 2)
  FNFT_K1T_CFG(double, 3)
  FNFT_K1T_CFG(double, 4)
  FNFT_K1T_CFG(float, 2)
  FNFT_K1T_CFG(float, 3)
  FNFT_K1T_CFG(float, 4)
#undef FNFT_K1T_CFG
  return static_cast<int>(cudaErrorInvalidValue);
}
