// HHT's AM/FM normalization loop for Hopper (sm_90a): N1. Plain C
// interface, loaded with ctypes by periodicity_tpu_torch/ops/_kernels.py;
// its wrapper and plain version are ops/hht.py::am_fm_normalize /
// am_fm_normalize_plain.
//
// It replaces no Pallas kernel. In the JAX package the normalization is a
// lax.while_loop (periodicity_tpu/ops/hht.py:88-117, the loop at :113),
// vmapped over every (member, mode) row and compiled whole by XLA. In eager
// PyTorch one pass is one spline envelope of |F|, several hundred launches
// (~850 aten ops at R = 256, N = 2048), and the loop needs a host read a
// pass; so the whole loop, for every row, becomes one launch here.
//
// What it computes, per row r of X [R, N] on the shared grid t [N]: F = X,
// A = 1, then up to n_iter passes of
//   - the local maxima of |F| with scipy's plateau rule;
//   - the envelope: the interior maxima odd-reflected by pad_width maxima
//     about t[0] and t[N-1], through the masked not-a-knot spline, or the
//     constant max|F| where the row has fewer than max(pad_width, 1)
//     interior maxima or fewer than 4 knots (ops/emd.py::upper_envelope);
//   - F <- F / env, A <- A * env;
//   - the row is done when max|F| - 1 < eps (in the row's dtype).
// Outputs: A [R, N], F [R, N] clipped to [-1, 1] (a NaN stays NaN, as in
// torch.clamp), passes [R] (the passes each row ran).
//
// What bounds it. A row is a chain of at most n_iter dependent passes, and
// each pass is a chain of dependent block-wide steps: the extrema's scans,
// the knots, the solve (ceil(log2 cnt) PCR levels over the cnt valid
// knots), the Hermite evaluation, the division and one max reduction.
// Bytes are few (X and t in, A and F out, once). So the longest row's
// chain bounds the launch.
//
// What the design does about it. One thread block per row, 512 threads,
// with the row's F, A, |F|, the extrema's round masks and one envelope's
// knots and double-buffered rows in dynamic shared memory (65 KB at
// N = 2048 in float32, 130 KB in float64), or in global scratch where they
// do not fit (float64 above N ~ 3600), through the same code. The envelope
// stages are S1's (envelope.cuh), built for one envelope. Rows retire on
// their own (a finished block exits), and no host read happens inside the
// loop. The max is exact in any order, so the stop flag is the same bit as
// the plain version's. At config 9 (R = 4 mode slots x B members = 32-256
// rows) that is at most two waves of blocks on 132 SMs.
//
// Every floating-point operation is rounded on its own (rn.cuh) in the
// plain version's order, so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

#include "envelope.cuh"

namespace {

using namespace envelope;

// One row's working arrays, carved from one byte range.
template <typename T>
struct Row {
  T* F;            // [n] the FM part
  T* A;            // [n] the AM part
  T* x;            // [n] |F| of this pass
  Rounds<1> rd;    // the maxima of |F|, round by round
  Knots<T, 1> kn;  // the envelope's knots and rows
};

template <typename T>
__host__ __device__ size_t carve(int n, int k, char* base, Row<T>& w) {
  Carve c{base};
  w.F = c.take<T>(n);
  w.A = c.take<T>(n);
  w.x = c.take<T>(n);
  carve_rounds(c, n, w.rd);
  carve_knots(c, k, w.kn);
  return c.off;
}

// max that lets a NaN through, as torch.amax does
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// Max of v over the block (every v >= 0 or NaN), to every thread. Ends on a
// barrier.
template <typename T>
__device__ T block_max(T v, T* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  T m = sh[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = max_nan(m, sh[w]);
  __syncthreads();
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
amfm_kernel(const T* __restrict__ t, const T* __restrict__ X, int n, int n_iter, int pad_width,
            T eps, T* __restrict__ A_out, T* __restrict__ F_out, int* __restrict__ passes_out,
            char* scratch, size_t row_bytes) {
  using R = Rn<T>;
  extern __shared__ __align__(16) char smem[];
  __shared__ T shm[kWarps];
  __shared__ WarpTotals wt;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nr = rounds(n);
  const int r0 = (tid >> 5) * nr;
  const int w = pad_width;
  const int k = capacity(n, w);
  Row<T> W;
  carve<T>(n, k, scratch ? scratch + static_cast<size_t>(r) * row_bytes : smem, W);
  const T* x0 = X + static_cast<size_t>(r) * n;
  for (int i = tid; i < n; i += kThreads) {
    W.F[i] = x0[i];
    W.A[i] = T(1);
  }
  int it = 0;
  bool done = false;
  __syncthreads();

  while (!done && it < n_iter) {
    for (int i = tid; i < n; i += kThreads) W.x[i] = fabs(W.F[i]);
    __syncthreads();
    // 1-2. the maxima of |F| and their running counts
    const Extrema<1> ex = extrema(W.x, n, W.rd, wt);
    const int n_int = ex.count[0];
    const int cnt[1] = {n_int + 2 * w};
    const bool ok = n_int >= max(w, 1) && cnt[0] >= 4;
    const T* sd[1] = {nullptr};
    T flat = T(0);
    if (ok) {
      // 3-5. the padded knots, the system and the knots' derivatives
      place_knots(t, W.x, n, w, W.rd, ex, W.kn);
      solve_derivatives(cnt, k, W.kn, sd);
    } else {
      // the constant envelope max|F|
      T m = T(0);
      for (int i = tid; i < n; i += kThreads) m = max_nan(m, W.x[i]);
      flat = block_max(m, shm);
    }
    // 6. the envelope at every sample, the division, the new max|F|
    T m = T(0);
    for (int q = r0; q < r0 + nr; ++q) {
      const int i = 32 * q + lane;
      if (i >= n) break;
      const T env = ok ? hermite(W.kn.pt(0), W.kn.pv(0), sd[0], w + count_at(W.rd, ex, 0, q, lane),
                                 cnt[0], t[i])
                       : flat;
      const T f = quot(W.F[i], env);
      W.F[i] = f;
      W.A[i] = R::mul(W.A[i], env);
      m = max_nan(m, fabs(f));
    }
    done = R::sub(block_max(m, shm), T(1)) < eps;
    ++it;
  }

  T* a_row = A_out + static_cast<size_t>(r) * n;
  T* f_row = F_out + static_cast<size_t>(r) * n;
  for (int i = tid; i < n; i += kThreads) {
    const T f = W.F[i];
    a_row[i] = W.A[i];
    f_row[i] = f < T(-1) ? T(-1) : (f > T(1) ? T(1) : f);
  }
  if (tid == 0) passes_out[r] = it;
}

// Bytes of one row's arrays, and the dynamic shared memory a block may use:
// the arrays go there when they fit, else to global scratch.
template <typename T>
cudaError_t plan(int n, int pad_width, size_t* bytes, size_t* limit) {
  Row<T> w;
  *bytes = carve<T>(n, capacity(n, pad_width), nullptr, w);
  return shared_limit(limit);
}

template <typename T>
cudaError_t amfm_normalize(const T* t, const T* X, int n, int rows, int n_iter, int pad_width,
                           double eps, T* A, T* F, int* passes, void* scratch,
                           cudaStream_t stream) {
  if (n < 1 || n > kMaxN || rows < 1 || n_iter < 0 || pad_width < 0)
    return cudaErrorInvalidValue;
  size_t bytes = 0, limit = 0;
  cudaError_t err = plan<T>(n, pad_width, &bytes, &limit);
  if (err != cudaSuccess) return err;
  const bool in_shared = bytes <= limit;
  if (!in_shared && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = in_shared ? bytes : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&amfm_kernel<T>),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(limit));
    if (err != cudaSuccess) return err;
  }
  amfm_kernel<T><<<rows, kThreads, smem, stream>>>(
      t, X, n, n_iter, pad_width, static_cast<T>(eps), A, F, passes,
      in_shared ? nullptr : static_cast<char*>(scratch), bytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Global scratch bytes one row needs: 0 where its arrays fit in a block's
// shared memory on the current device; minus a cudaError on error.
int amfm_scratch_bytes(int n, int pad_width, int elem_size) {
  if (n < 1 || n > kMaxN || pad_width < 0 || (elem_size != 4 && elem_size != 8))
    return -static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0, limit = 0;
  const cudaError_t err = elem_size == 8 ? plan<double>(n, pad_width, &bytes, &limit)
                                         : plan<float>(n, pad_width, &bytes, &limit);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return bytes <= limit ? 0 : static_cast<int>(bytes);
}

int amfm_normalize_f32(const float* t, const float* X, int n, int rows, int n_iter,
                       int pad_width, double eps, float* A, float* F, int* passes,
                       void* scratch, cudaStream_t stream) {
  return static_cast<int>(amfm_normalize<float>(t, X, n, rows, n_iter, pad_width, eps, A, F,
                                                passes, scratch, stream));
}

int amfm_normalize_f64(const double* t, const double* X, int n, int rows, int n_iter,
                       int pad_width, double eps, double* A, double* F, int* passes,
                       void* scratch, cudaStream_t stream) {
  return static_cast<int>(amfm_normalize<double>(t, X, n, rows, n_iter, pad_width, eps, A, F,
                                                 passes, scratch, stream));
}

}  // extern "C"
