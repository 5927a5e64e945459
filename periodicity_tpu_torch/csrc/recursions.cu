// Two sequential recursions for Hopper (sm_90a): the cascaded second-order
// IIR filter and the pentadiagonal LDL^T solve of the smoothing spline.
// Plain C interface, loaded with ctypes by periodicity_tpu_torch/ops/_kernels.py.
//
// Neither has a Pallas kernel in the JAX package: each is a lax.scan there,
//   sosfilt               periodicity_tpu/ops/filters.py:273-299
//                         (sosfiltfilt runs it twice for float64 input)
//   pentadiagonal_solve   periodicity_tpu/ops/spline.py:379-431
//                         (the smoothing spline's bisection solves ~62 times)
// which XLA runs as one dispatch. In eager PyTorch every step of such a
// scan is a handful of 0-d launches (~15 a step, thousands of steps a call),
// so each recursion becomes one launch here.
//
// What bounds it on the card. Each step depends on the one before: at the
// SpottedStar shapes (m = 2146 unknowns, ~2,200 filter steps) a launch moves
// tens of kilobytes, a few hundredths of a microsecond at 3.35 TB/s, while
// its chain of dependent operations (4 a filter step through the state
// update; 5 a factor step, one of them a division, then 3 a step each way
// for the substitutions) takes tens of microseconds at the latency of one
// dependent floating-point operation. The chain binds, not the bytes.
//
// What the design does about it: one thread walks one system (one filter
// row), with the state in registers: no barrier and no shared memory in the
// chain. The filter's sections are a template parameter, so their
// coefficients and states are registers too, and the cascade pipelines: the
// next section's step needs only this section's output of the same step.
// The coefficients travel by value in the launch's parameters, read from
// host memory when the launch is made: no copy to the card, which from
// pageable memory would wait for the stream.
// Inputs are read in chunks of eight ahead of their use, so a load's latency
// overlaps the chain instead of adding to it. The filter takes a batch of
// rows, one thread each; the solve one system a launch.
//
// Every product, sum, difference and quotient is rounded on its own
// (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn; __f*_rn in float32) in the
// order the plain versions (ops/filters.py::sosfilt_plain,
// ops/spline.py::pentadiagonal_solve_plain) and the JAX scans use, so nvcc
// cannot contract a pair into an FMA: kernel and plain version agree bit for
// bit. The zero-pivot guards of the JAX factor (D == 0 -> 0) are kept.

#include <cuda_runtime.h>

#include "rn.cuh"

namespace {

constexpr int kMaxSections = 16;

// (b0, b1, b2, a1, a2) of every section, normalized by a0: at most 640
// bytes of kernel parameters in float64
template <typename T>
struct Coefficients {
  T v[5 * kMaxSections];
};
constexpr int kChunk = 8;  // inputs read ahead of the chain
constexpr int kRowsPerBlock = 32;

using rn::Rn;

// One row of the cascade, direct form II transposed, per step and section:
//   out = b0 v + z0;  z0 = (b1 v - a1 out) + z1;  z1 = b2 v - a2 out;  v = out
// coef: (b0, b1, b2, a1, a2) of each of the NS sections, normalized by a0;
// x, y [rows, n]; zi, zf [rows, NS, 2].
template <typename T, int NS>
__global__ void __launch_bounds__(kRowsPerBlock)
sosfilt_kernel(const Coefficients<T> coef, const T* __restrict__ x,
               const T* __restrict__ zi, int n, int rows, T* __restrict__ y,
               T* __restrict__ zf) {
  using R = Rn<T>;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  T b0[NS], b1[NS], b2[NS], a1[NS], a2[NS], z0[NS], z1[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    b0[s] = coef.v[5 * s];
    b1[s] = coef.v[5 * s + 1];
    b2[s] = coef.v[5 * s + 2];
    a1[s] = coef.v[5 * s + 3];
    a2[s] = coef.v[5 * s + 4];
    z0[s] = zi[(static_cast<size_t>(r) * NS + s) * 2];
    z1[s] = zi[(static_cast<size_t>(r) * NS + s) * 2 + 1];
  }
  const T* xr = x + static_cast<size_t>(r) * n;
  T* yr = y + static_cast<size_t>(r) * n;
  for (int t0 = 0; t0 < n; t0 += kChunk) {
    T buf[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) buf[k] = t0 + k < n ? xr[t0 + k] : T(0);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      T v = buf[k];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const T out = R::add(R::mul(b0[s], v), z0[s]);
        z0[s] = R::add(R::sub(R::mul(b1[s], v), R::mul(a1[s], out)), z1[s]);
        z1[s] = R::sub(R::mul(b2[s], v), R::mul(a2[s], out));
        v = out;
      }
      buf[k] = v;
      if (t0 + k + 1 == n) break;  // the state holds the last real step
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (t0 + k < n) yr[t0 + k] = buf[k];
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    zf[(static_cast<size_t>(r) * NS + s) * 2] = z0[s];
    zf[(static_cast<size_t>(r) * NS + s) * 2 + 1] = z1[s];
  }
}

template <typename T, int NS>
cudaError_t launch_sosfilt(const Coefficients<T>& coef, const T* x, const T* zi, int n,
                           int rows, T* y, T* zf, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  sosfilt_kernel<T, NS><<<blocks, kRowsPerBlock, 0, stream>>>(coef, x, zi, n, rows, y, zf);
  return cudaGetLastError();
}

// coef_host: [ns, 5] in host memory, copied into the launch's parameters
template <typename T>
cudaError_t sosfilt(const T* coef_host, const T* x, const T* zi, int n, int ns, int rows, T* y,
                    T* zf, cudaStream_t stream) {
  if (n < 0 || rows < 1 || ns < 1 || ns > kMaxSections) return cudaErrorInvalidValue;
  Coefficients<T> coef = {};
  for (int i = 0; i < 5 * ns; ++i) coef.v[i] = coef_host[i];
  switch (ns) {
#define PERIODICITY_SOSFILT_CASE(NS) \
  case NS:                           \
    return launch_sosfilt<T, NS>(coef, x, zi, n, rows, y, zf, stream);
    PERIODICITY_SOSFILT_CASE(1)
    PERIODICITY_SOSFILT_CASE(2)
    PERIODICITY_SOSFILT_CASE(3)
    PERIODICITY_SOSFILT_CASE(4)
    PERIODICITY_SOSFILT_CASE(5)
    PERIODICITY_SOSFILT_CASE(6)
    PERIODICITY_SOSFILT_CASE(7)
    PERIODICITY_SOSFILT_CASE(8)
    PERIODICITY_SOSFILT_CASE(9)
    PERIODICITY_SOSFILT_CASE(10)
    PERIODICITY_SOSFILT_CASE(11)
    PERIODICITY_SOSFILT_CASE(12)
    PERIODICITY_SOSFILT_CASE(13)
    PERIODICITY_SOSFILT_CASE(14)
    PERIODICITY_SOSFILT_CASE(15)
    PERIODICITY_SOSFILT_CASE(16)
#undef PERIODICITY_SOSFILT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

static_assert(kMaxSections == 16, "the switch above instantiates 1..16 sections");

// The symmetric pentadiagonal system with diagonals main [m], off1 [m-1],
// off2 [m-2] and right-hand side rhs [m], one thread. Per row i, with
// b_i = off1[i-1], c_i = off2[i-2] (0 before the bands start):
//   beta_i  = D_{i-2} != 0 ? c_i / D_{i-2} : 0
//   alpha_i = D_{i-1} != 0 ? (b_i - (beta_i alpha_{i-1}) D_{i-2}) / D_{i-1} : 0
//   D_i     = (a_i - (alpha_i alpha_i) D_{i-1}) - (beta_i beta_i) D_{i-2}
//   z_i     = (r_i - alpha_i z_{i-1}) - beta_i z_{i-2};   zd_i = z_i / D_i
// then backwards x_i = (zd_i - alpha_{i+1} x_{i+1}) - beta_{i+2} x_{i+2}.
// alpha and beta go to scratch [2m], zd to out, which the backward pass
// overwrites with x.
template <typename T>
__global__ void __launch_bounds__(32)
pentadiagonal_kernel(const T* __restrict__ main_d, const T* __restrict__ off1,
                     const T* __restrict__ off2, const T* __restrict__ rhs, int m,
                     T* __restrict__ scratch, T* __restrict__ out) {
  using R = Rn<T>;
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  T* alpha = scratch;
  T* beta = scratch + m;
  const T zero = T(0);
  T D1 = zero, D2 = zero, al1 = zero, z1 = zero, z2 = zero;
  for (int i0 = 0; i0 < m; i0 += kChunk) {
    T a[kChunk], b[kChunk], c[kChunk], r[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = i0 + k;
      a[k] = i < m ? main_d[i] : zero;
      r[k] = i < m ? rhs[i] : zero;
      b[k] = (i >= 1 && i < m) ? off1[i - 1] : zero;
      c[k] = (i >= 2 && i < m) ? off2[i - 2] : zero;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = i0 + k;
      if (i >= m) break;
      const T be = D2 != zero ? R::div(c[k], D2) : zero;
      const T al = D1 != zero ? R::div(R::sub(b[k], R::mul(R::mul(be, al1), D2)), D1) : zero;
      const T D = R::sub(R::sub(a[k], R::mul(R::mul(al, al), D1)), R::mul(R::mul(be, be), D2));
      const T z = R::sub(R::sub(r[k], R::mul(al, z1)), R::mul(be, z2));
      alpha[i] = al;
      beta[i] = be;
      out[i] = R::div(z, D);
      D2 = D1;
      D1 = D;
      al1 = al;
      z2 = z1;
      z1 = z;
    }
  }
  T x1 = zero, x2 = zero;
  for (int i1 = m - 1; i1 >= 0; i1 -= kChunk) {
    T zd[kChunk], an[kChunk], bn[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = i1 - k;
      zd[k] = i >= 0 ? out[i] : zero;
      an[k] = (i >= 0 && i + 1 < m) ? alpha[i + 1] : zero;
      bn[k] = (i >= 0 && i + 2 < m) ? beta[i + 2] : zero;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = i1 - k;
      if (i < 0) break;
      const T xv = R::sub(R::sub(zd[k], R::mul(an[k], x1)), R::mul(bn[k], x2));
      out[i] = xv;
      x2 = x1;
      x1 = xv;
    }
  }
}

template <typename T>
cudaError_t pentadiagonal_solve(const T* main_d, const T* off1, const T* off2, const T* rhs,
                                int m, T* scratch, T* out, cudaStream_t stream) {
  if (m < 1) return cudaErrorInvalidValue;
  pentadiagonal_kernel<T><<<1, 32, 0, stream>>>(main_d, off1, off2, rhs, m, scratch, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sosfilt_f32(const float* coef, const float* x, const float* zi, int n, int ns, int rows,
                float* y, float* zf, cudaStream_t stream) {
  return static_cast<int>(sosfilt<float>(coef, x, zi, n, ns, rows, y, zf, stream));
}

int sosfilt_f64(const double* coef, const double* x, const double* zi, int n, int ns,
                int rows, double* y, double* zf, cudaStream_t stream) {
  return static_cast<int>(sosfilt<double>(coef, x, zi, n, ns, rows, y, zf, stream));
}

int pentadiagonal_solve_f32(const float* main_d, const float* off1, const float* off2,
                            const float* rhs, int m, float* scratch, float* out,
                            cudaStream_t stream) {
  return static_cast<int>(
      pentadiagonal_solve<float>(main_d, off1, off2, rhs, m, scratch, out, stream));
}

int pentadiagonal_solve_f64(const double* main_d, const double* off1, const double* off2,
                            const double* rhs, int m, double* scratch, double* out,
                            cudaStream_t stream) {
  return static_cast<int>(
      pentadiagonal_solve<double>(main_d, off1, off2, rhs, m, scratch, out, stream));
}

}  // extern "C"
