// K1: the blocked Kalman composition of the celerite GP likelihood, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// periodicity_tpu_torch/ops/_kernels.py; the wrapper and the plain version
// are in periodicity_tpu_torch/ops/kalman.py.
//
// It has no Pallas kernel in the JAX package: it replaces the lax.scan of
// _combine inside periodicity_tpu/models/gp/pscan.py::_pkf_loglik_blocked
// (:332-346, the scan at :207-210) and one chunk of _pkf_loglik_chunked
// (:349-407), whose body XLA fuses into one dispatch a step. In eager
// PyTorch a step is ~150 launches (most of them the unrolled pivoted
// solve), ceil(N / n_blocks) steps a call.
//
// What it computes, per row (walker), with L = ceil(n / nb) positions a
// block and the 5-tuple filtering elements (A, b, C, eta, J) of Sarkka and
// Garcia-Fernandez built from (A_k, Q_k, H, diag_k, y_k):
//   stage 1  a thread per (row, block) composes its block's elements in
//            order from the identity and writes the block's summary;
//   stage 2  a thread per row composes the summaries in order from the
//            incoming carry (or the identity): each block's exclusive carry
//            and the row's outgoing carry;
//   stage 3  a thread per (row, block) composes its elements again from its
//            exclusive carry, writing before each the predicted mean and
//            variance mu_k = H.(A_k b), s_k = H (A_k C A_k^T + Q_k) H + diag_k
//            from the filtered (b, C) of the position before.
//
// What bounds it on the card. Each composition depends on the one before
// through the 3 R^2 + 2 R values of the state (R = 4 for config 7's live
// BrownianTerm), and one composition is a chain of ~13 R dependent
// operations (the R-deep product I + J C, the pivoted elimination and back
// substitution with their divisions, the products after them): a call is
// 2 L + nb compositions deep, while it moves only (2 R^2 + 4) values a
// sample. At config 7's N = 1e5 (nb = 390, L = 257) that chain is a few
// hundred microseconds; the bytes, a few microseconds. The chain binds.
//
// What the design does about it: a first correct design, reduce then scan.
// The state and the element live in registers (R is a template parameter,
// 1 to 8, and every loop over R unrolls), one thread a chain, no barrier and
// no shared memory in the chain; at R = 8 the state spills (ptxas reports
// it). The elements are built in the kernel from A_k and Q_k, twice (stages
// 1 and 3), so no [B, N, ...] element arrays exist.
//
// Every product, sum, difference and quotient is rounded on its own through
// rn.cuh, in the order of the plain version (every sum over its index in
// ascending order), and the pivot is the first maximal |value| at or below
// the diagonal: kernel and plain version agree bit for bit.

#include <cuda_runtime.h>

#include "rn.cuh"

namespace {

constexpr int kMaxR = 8;
constexpr int kThreads = 32;

using rn::Rn;

__device__ __forceinline__ float mag(float x) { return fabsf(x); }
__device__ __forceinline__ double mag(double x) { return fabs(x); }

template <typename T, int R>
struct Elem {
  T A[R][R];
  T b[R];
  T C[R][R];
  T eta[R];
  T J[R][R];
};

template <typename T, int R>
constexpr int kState = 3 * R * R + 2 * R;

template <typename T, int R>
__device__ __forceinline__ void identity(Elem<T, R>& e) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    e.b[i] = T(0);
    e.eta[i] = T(0);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      e.A[i][j] = i == j ? T(1) : T(0);
      e.C[i][j] = T(0);
      e.J[i][j] = T(0);
    }
  }
}

// packed order: A, b, C, eta, J, each row-major (ops/kalman.py::pack_carry)
template <typename T, int R>
__device__ __forceinline__ void load(const T* p, Elem<T, R>& e) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      e.A[i][j] = p[i * R + j];
      e.C[i][j] = p[R * R + R + i * R + j];
      e.J[i][j] = p[2 * R * R + 2 * R + i * R + j];
    }
    e.b[i] = p[R * R + i];
    e.eta[i] = p[2 * R * R + R + i];
  }
}

template <typename T, int R>
__device__ __forceinline__ void store(const Elem<T, R>& e, T* p) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      p[i * R + j] = e.A[i][j];
      p[R * R + R + i * R + j] = e.C[i][j];
      p[2 * R * R + 2 * R + i * R + j] = e.J[i][j];
    }
    p[R * R + i] = e.b[i];
    p[2 * R * R + R + i] = e.eta[i];
  }
}

template <typename T, int R>
__device__ __forceinline__ void load_mat(const T* __restrict__ p, T (&m)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) m[i][j] = p[i * R + j];
  }
}

// the element of one position (ops/kalman.py::_elements)
template <typename T, int R>
__device__ __forceinline__ void element(const T (&a)[R][R], const T (&q)[R][R], const T (&h)[R],
                                        T d, T y, Elem<T, R>& e) {
  using O = Rn<T>;
  T qh[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    T acc = O::mul(q[i][0], h[0]);
#pragma unroll
    for (int j = 1; j < R; ++j) acc = O::add(acc, O::mul(q[i][j], h[j]));
    qh[i] = acc;
  }
  T hqh = O::mul(h[0], qh[0]);
#pragma unroll
  for (int i = 1; i < R; ++i) hqh = O::add(hqh, O::mul(h[i], qh[i]));
  hqh = O::add(hqh, d);
  T k[R], ha[R];
#pragma unroll
  for (int i = 0; i < R; ++i) k[i] = O::div(qh[i], hqh);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    T acc = O::mul(a[0][j], h[0]);
#pragma unroll
    for (int i = 1; i < R; ++i) acc = O::add(acc, O::mul(a[i][j], h[i]));
    ha[j] = acc;
  }
  T imkh[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) imkh[i][j] = O::sub(i == j ? T(1) : T(0), O::mul(k[i], h[j]));
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      T accA = O::mul(imkh[i][0], a[0][j]);
      T accC = O::mul(imkh[i][0], q[0][j]);
#pragma unroll
      for (int l = 1; l < R; ++l) {
        accA = O::add(accA, O::mul(imkh[i][l], a[l][j]));
        accC = O::add(accC, O::mul(imkh[i][l], q[l][j]));
      }
      e.A[i][j] = accA;
      e.C[i][j] = accC;
      e.J[i][j] = O::div(O::mul(ha[i], ha[j]), hqh);
    }
    e.b[i] = O::mul(k[i], y);
  }
  const T ry = O::div(y, hqh);
#pragma unroll
  for (int j = 0; j < R; ++j) e.eta[j] = O::mul(ha[j], ry);
}

// the composition of ei (earlier) and ej (later): ops/kalman.py::_combine
template <typename T, int R>
__device__ __forceinline__ Elem<T, R> combine(const Elem<T, R>& ei, const Elem<T, R>& ej) {
  using O = Rn<T>;
  constexpr int W = 3 * R + 1;
  constexpr int K = 2 * R + 1;
  T mb[R][W];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      T m = O::mul(ej.J[i][0], ei.C[0][j]);
      T g = O::mul(ej.J[i][0], ei.A[0][j]);
#pragma unroll
      for (int l = 1; l < R; ++l) {
        m = O::add(m, O::mul(ej.J[i][l], ei.C[l][j]));
        g = O::add(g, O::mul(ej.J[i][l], ei.A[l][j]));
      }
      mb[i][j] = O::add(i == j ? T(1) : T(0), m);
      mb[i][R + j] = ej.A[j][i];
      mb[i][2 * R + 1 + j] = g;
    }
    T jb = O::mul(ej.J[i][0], ei.b[0]);
#pragma unroll
    for (int l = 1; l < R; ++l) jb = O::add(jb, O::mul(ej.J[i][l], ei.b[l]));
    mb[i][2 * R] = O::sub(ej.eta[i], jb);
  }
  // elimination with partial pivoting: the first maximal |value|
#pragma unroll
  for (int col = 0; col < R - 1; ++col) {
    int p = col;
    T best = mag(mb[col][col]);
#pragma unroll
    for (int i = col + 1; i < R; ++i) {
      const T m = mag(mb[i][col]);
      if (m > best) {
        best = m;
        p = i;
      }
    }
#pragma unroll
    for (int i = col + 1; i < R; ++i) {
      if (i == p) {
#pragma unroll
        for (int c = col; c < W; ++c) {
          const T tmp = mb[col][c];
          mb[col][c] = mb[i][c];
          mb[i][c] = tmp;
        }
      }
    }
    const T piv = mb[col][col];
#pragma unroll
    for (int i = col + 1; i < R; ++i) {
      const T f = O::div(mb[i][col], piv);
#pragma unroll
      for (int c = col + 1; c < W; ++c) mb[i][c] = O::sub(mb[i][c], O::mul(f, mb[col][c]));
    }
  }
  T x[R][K];
#pragma unroll
  for (int i = R - 1; i >= 0; --i) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      T s = mb[i][R + c];
#pragma unroll
      for (int j = i + 1; j < R; ++j) s = O::sub(s, O::mul(mb[i][j], x[j][c]));
      x[i][c] = O::div(s, mb[i][i]);
    }
  }
  // m1t = x[:, :R]^T, m2 = x[:, R], m3 = x[:, R+1:]
  Elem<T, R> out;
  T t1[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    T acc = O::mul(ei.C[k][0], ej.eta[0]);
#pragma unroll
    for (int l = 1; l < R; ++l) acc = O::add(acc, O::mul(ei.C[k][l], ej.eta[l]));
    t1[k] = O::add(ei.b[k], acc);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    T t2[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      T a = O::mul(x[0][i], ei.A[0][j]);
      T c = O::mul(x[0][i], ei.C[0][j]);
#pragma unroll
      for (int k = 1; k < R; ++k) {
        a = O::add(a, O::mul(x[k][i], ei.A[k][j]));
        c = O::add(c, O::mul(x[k][i], ei.C[k][j]));
      }
      out.A[i][j] = a;
      t2[j] = c;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      T c = O::mul(t2[0], ej.A[j][0]);
#pragma unroll
      for (int l = 1; l < R; ++l) c = O::add(c, O::mul(t2[l], ej.A[j][l]));
      out.C[i][j] = O::add(c, ej.C[i][j]);
    }
    T bb = O::mul(x[0][i], t1[0]);
#pragma unroll
    for (int k = 1; k < R; ++k) bb = O::add(bb, O::mul(x[k][i], t1[k]));
    out.b[i] = O::add(bb, ej.b[i]);
    T et = O::mul(ei.A[0][i], x[0][R]);
#pragma unroll
    for (int j = 1; j < R; ++j) et = O::add(et, O::mul(ei.A[j][i], x[j][R]));
    out.eta[i] = O::add(et, ei.eta[i]);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      T jj = O::mul(ei.A[0][i], x[0][R + 1 + k]);
#pragma unroll
      for (int j = 1; j < R; ++j) jj = O::add(jj, O::mul(ei.A[j][i], x[j][R + 1 + k]));
      out.J[i][k] = O::add(jj, ei.J[i][k]);
    }
  }
  return out;
}

// the positions [lo, hi) of block `blk` of a row of n
__device__ __forceinline__ void block_range(long long n, long long length, int blk, long long* lo,
                                            long long* hi) {
  *lo = static_cast<long long>(blk) * length;
  *hi = *lo + length < n ? *lo + length : n;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
kalman_summary_kernel(const T* __restrict__ A, const T* __restrict__ Q, const T* __restrict__ H,
                      const T* __restrict__ diag, const T* __restrict__ y, int b, int n, int nb,
                      T* __restrict__ summ) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(b) * nb) return;
  const int row = static_cast<int>(tid / nb);
  const int blk = static_cast<int>(tid % nb);
  const long long length = (static_cast<long long>(n) + nb - 1) / nb;
  long long lo, hi;
  block_range(n, length, blk, &lo, &hi);
  T h[R];
#pragma unroll
  for (int i = 0; i < R; ++i) h[i] = H[i];
  Elem<T, R> st;
  identity(st);
  const size_t base = static_cast<size_t>(row) * n;
  for (long long p = lo; p < hi; ++p) {
    T a[R][R], q[R][R];
    load_mat<T, R>(A + (base + p) * R * R, a);
    load_mat<T, R>(Q + (base + p) * R * R, q);
    Elem<T, R> e;
    element<T, R>(a, q, h, diag[base + p], y[base + p], e);
    st = combine<T, R>(st, e);
  }
  store<T, R>(st, summ + static_cast<size_t>(tid) * kState<T, R>);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
kalman_carry_kernel(const T* __restrict__ carry_in, int b, int nb, const T* __restrict__ summ,
                    T* __restrict__ excl, T* __restrict__ carry_out) {
  constexpr int S = kState<T, R>;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= b) return;
  Elem<T, R> run;
  if (carry_in) {
    load<T, R>(carry_in + static_cast<size_t>(row) * S, run);
  } else {
    identity(run);
  }
  for (int k = 0; k < nb; ++k) {
    const size_t at = (static_cast<size_t>(row) * nb + k) * S;
    store<T, R>(run, excl + at);
    Elem<T, R> e;
    load<T, R>(summ + at, e);
    run = combine<T, R>(run, e);
  }
  store<T, R>(run, carry_out + static_cast<size_t>(row) * S);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
kalman_innovation_kernel(const T* __restrict__ A, const T* __restrict__ Q,
                         const T* __restrict__ H, const T* __restrict__ diag,
                         const T* __restrict__ y, int b, int n, int nb,
                         const T* __restrict__ excl, T* __restrict__ mu, T* __restrict__ s) {
  using O = Rn<T>;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(b) * nb) return;
  const int row = static_cast<int>(tid / nb);
  const int blk = static_cast<int>(tid % nb);
  const long long length = (static_cast<long long>(n) + nb - 1) / nb;
  long long lo, hi;
  block_range(n, length, blk, &lo, &hi);
  if (lo >= hi) return;
  T h[R];
#pragma unroll
  for (int i = 0; i < R; ++i) h[i] = H[i];
  Elem<T, R> st;
  load<T, R>(excl + static_cast<size_t>(tid) * kState<T, R>, st);
  const size_t base = static_cast<size_t>(row) * n;
  for (long long p = lo; p < hi; ++p) {
    T a[R][R], q[R][R];
    load_mat<T, R>(A + (base + p) * R * R, a);
    load_mat<T, R>(Q + (base + p) * R * R, q);
    const T d = diag[base + p];
    // mu = H . (A b); s = H (A C A^T + Q) H + d (ops/kalman.py::_innovation)
    T m[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      T acc = O::mul(a[i][0], st.b[0]);
#pragma unroll
      for (int k = 1; k < R; ++k) acc = O::add(acc, O::mul(a[i][k], st.b[k]));
      m[i] = acc;
    }
    T mu_p = O::mul(h[0], m[0]);
#pragma unroll
    for (int i = 1; i < R; ++i) mu_p = O::add(mu_p, O::mul(h[i], m[i]));
    T ph[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      T t[R];
#pragma unroll
      for (int l = 0; l < R; ++l) {
        T acc = O::mul(a[i][0], st.C[0][l]);
#pragma unroll
        for (int k = 1; k < R; ++k) acc = O::add(acc, O::mul(a[i][k], st.C[k][l]));
        t[l] = acc;
      }
      T pr[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        T acc = O::mul(t[0], a[j][0]);
#pragma unroll
        for (int l = 1; l < R; ++l) acc = O::add(acc, O::mul(t[l], a[j][l]));
        pr[j] = O::add(acc, q[i][j]);
      }
      T acc = O::mul(pr[0], h[0]);
#pragma unroll
      for (int j = 1; j < R; ++j) acc = O::add(acc, O::mul(pr[j], h[j]));
      ph[i] = acc;
    }
    T s_p = O::mul(h[0], ph[0]);
#pragma unroll
    for (int i = 1; i < R; ++i) s_p = O::add(s_p, O::mul(h[i], ph[i]));
    mu[base + p] = mu_p;
    s[base + p] = O::add(s_p, d);
    Elem<T, R> e;
    element<T, R>(a, q, h, d, y[base + p], e);
    st = combine<T, R>(st, e);
  }
}

template <typename T, int R>
cudaError_t launch(const T* A, const T* Q, const T* H, const T* diag, const T* y,
                   const T* carry_in, int b, int n, int nb, T* summ, T* excl, T* mu, T* s,
                   T* carry_out, cudaStream_t stream) {
  const long long threads = static_cast<long long>(b) * nb;
  const int grid = static_cast<int>((threads + kThreads - 1) / kThreads);
  kalman_summary_kernel<T, R><<<grid, kThreads, 0, stream>>>(A, Q, H, diag, y, b, n, nb, summ);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kalman_carry_kernel<T, R><<<(b + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      carry_in, b, nb, summ, excl, carry_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kalman_innovation_kernel<T, R><<<grid, kThreads, 0, stream>>>(A, Q, H, diag, y, b, n, nb, excl,
                                                                 mu, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t blocked(const T* A, const T* Q, const T* H, const T* diag, const T* y,
                    const T* carry_in, int b, int n, int r, int nb, T* summ, T* excl, T* mu,
                    T* s, T* carry_out, cudaStream_t stream) {
  if (b < 1 || n < 1 || nb < 1 || static_cast<long long>(b) * nb > (1LL << 31) - kThreads)
    return cudaErrorInvalidValue;
  switch (r) {
#define PERIODICITY_KALMAN_CASE(RR)                                                       \
  case RR:                                                                                \
    return launch<T, RR>(A, Q, H, diag, y, carry_in, b, n, nb, summ, excl, mu, s,         \
                         carry_out, stream);
    PERIODICITY_KALMAN_CASE(1)
    PERIODICITY_KALMAN_CASE(2)
    PERIODICITY_KALMAN_CASE(3)
    PERIODICITY_KALMAN_CASE(4)
    PERIODICITY_KALMAN_CASE(5)
    PERIODICITY_KALMAN_CASE(6)
    PERIODICITY_KALMAN_CASE(7)
    PERIODICITY_KALMAN_CASE(8)
#undef PERIODICITY_KALMAN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

static_assert(kMaxR == 8, "the switch above instantiates R = 1..8");

}  // namespace

extern "C" {

int kalman_blocked_f32(const float* A, const float* Q, const float* H, const float* diag,
                       const float* y, const float* carry_in, int b, int n, int r, int nb,
                       float* summ, float* excl, float* mu, float* s, float* carry_out,
                       cudaStream_t stream) {
  return static_cast<int>(
      blocked<float>(A, Q, H, diag, y, carry_in, b, n, r, nb, summ, excl, mu, s, carry_out,
                     stream));
}

int kalman_blocked_f64(const double* A, const double* Q, const double* H, const double* diag,
                       const double* y, const double* carry_in, int b, int n, int r, int nb,
                       double* summ, double* excl, double* mu, double* s, double* carry_out,
                       cudaStream_t stream) {
  return static_cast<int>(
      blocked<double>(A, Q, H, diag, y, carry_in, b, n, r, nb, summ, excl, mu, s, carry_out,
                      stream));
}

}  // extern "C"
