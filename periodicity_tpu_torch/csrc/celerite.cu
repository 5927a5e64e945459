// The celerite recursions for Hopper (sm_90a): the fused factor and forward
// substitution (G1), its adjoint (G2) and the two-sweep solve (G3).
// Plain C interface, loaded with ctypes by periodicity_tpu_torch/ops/_kernels.py.
//
// None has a Pallas kernel in the JAX package: each is a lax.scan there,
//   G1  periodicity_tpu/models/gp/solver.py:150-167 (the fused likelihood;
//       the factor alone at :71-86)
//   G2  jax.grad through that scan
//   G3  periodicity_tpu/models/gp/solver.py:88-130 (celerite_solve)
// which XLA runs as one dispatch. In eager PyTorch every step of such a
// scan is a dozen or more launches, thousands of steps a call, so each
// recursion is one launch here.
//
// What bounds it on the card. Each step depends on the one before, through
// an R x R state (R = 6 for the masked BrownianTerm, 8 for the masked
// RotationTerm): at SpottedStar's N = 2148 and 64 walkers a likelihood moves
// a few megabytes, about a microsecond at 3.35 TB/s, while its chain of
// dependent operations (the state update, the R-deep sums Su and u . Su, a
// division, the next update) takes a hundred microseconds or more at the
// latency of one dependent floating-point operation. The chain binds.
//
// What the design does about it: one thread walks one row (a walker) for
// G1 and G2, and one right-hand side column for G3, with the state in
// registers: no barrier and no shared memory in the chain. R is a template
// parameter (1 to 8), so the state arrays are registers. G1 reads the next
// step's inputs one step ahead of their use, so a load's latency overlaps
// the chain. The state S is symmetric bit for bit (each entry is a product
// of commuting factors), so G1 and G2 keep its upper triangle, packed
// row-major: R (R + 1) / 2 values. G1 saves S before each step's update,
// and f, for G2, which recomputes the rest of the step from them.
//
// Every product, sum, difference and quotient is rounded on its own
// (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn; __f*_rn in float32) in the
// order of the plain versions (periodicity_tpu_torch/ops/celerite.py), so
// nvcc cannot contract a pair into an FMA: kernel and plain version agree
// bit for bit. A non-finite or non-positive D propagates as it does there.

#include <cuda_runtime.h>

#include "rn.cuh"

namespace {

constexpr int kMaxR = 8;
constexpr int kRowsPerBlock = 32;
constexpr int kColsPerBlock = 128;

using rn::Rn;

// slot of (i, j), i <= j, in the packed upper triangle
template <int R>
__device__ __forceinline__ constexpr int tri(int i, int j) {
  return i * R - i * (i - 1) / 2 + (j - i);
}

template <int R>
__device__ __forceinline__ constexpr int sym(int i, int j) {
  return i <= j ? tri<R>(i, j) : tri<R>(j, i);
}

// G1. A [b, n], U, V [b, n, R], P [b, n-1, R], y [b, n] or null. Writes D
// [b, n]; W [b, n, R], z [b, n], S_saved [b, n-1, K] and f_saved [b, n-1, R]
// where not null (z needs y). Per step t >= 1, p = P[t-1]:
//   S_ij = (p_i p_j) (S_ij + D_{t-1} (W_{t-1,i} W_{t-1,j}))
//   Su_i = sum_j S_ij u_j;  D_t = a_t - sum_i u_i Su_i;  W_t = (v_t - Su) / D_t
//   f_i  = p_i (f_i + W_{t-1,i} z_{t-1});  z_t = y_t - sum_i u_i f_i
template <typename T, int R>
__global__ void __launch_bounds__(kRowsPerBlock)
celerite_forward_kernel(const T* __restrict__ A, const T* __restrict__ U,
                        const T* __restrict__ V, const T* __restrict__ P,
                        const T* __restrict__ y, int b, int n, T* __restrict__ D,
                        T* __restrict__ W, T* __restrict__ z, T* __restrict__ s_saved,
                        T* __restrict__ f_saved) {
  using O = Rn<T>;
  constexpr int K = R * (R + 1) / 2;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= b) return;
  const size_t rn_ = static_cast<size_t>(row) * n;
  const T* Ar = A + rn_;
  const T* Ur = U + rn_ * R;
  const T* Vr = V + rn_ * R;
  const T* Pr = P + static_cast<size_t>(row) * (n - 1) * R;
  const T* yr = y ? y + rn_ : nullptr;
  T* Sr = s_saved ? s_saved + static_cast<size_t>(row) * (n - 1) * K : nullptr;
  T* Fr = f_saved ? f_saved + static_cast<size_t>(row) * (n - 1) * R : nullptr;

  T S[K], f[R], w_prev[R];
#pragma unroll
  for (int k = 0; k < K; ++k) S[k] = T(0);
  T d_prev = Ar[0];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    f[i] = T(0);
    w_prev[i] = O::div(Vr[i], d_prev);
  }
  T z_prev = yr ? yr[0] : T(0);
  D[rn_] = d_prev;
  if (W) {
#pragma unroll
    for (int i = 0; i < R; ++i) W[rn_ * R + i] = w_prev[i];
  }
  if (z) z[rn_] = z_prev;

  // inputs of step t, read one step ahead
  T a_n = T(0), y_n = T(0), u_n[R], v_n[R], p_n[R];
  if (n > 1) {
    a_n = Ar[1];
    y_n = yr ? yr[1] : T(0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      u_n[i] = Ur[R + i];
      v_n[i] = Vr[R + i];
      p_n[i] = Pr[i];
    }
  }
  for (int t = 1; t < n; ++t) {
    const T a = a_n, yt = y_n;
    T u[R], v[R], p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      u[i] = u_n[i];
      v[i] = v_n[i];
      p[i] = p_n[i];
    }
    if (t + 1 < n) {
      a_n = Ar[t + 1];
      y_n = yr ? yr[t + 1] : T(0);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        u_n[i] = Ur[static_cast<size_t>(t + 1) * R + i];
        v_n[i] = Vr[static_cast<size_t>(t + 1) * R + i];
        p_n[i] = Pr[static_cast<size_t>(t) * R + i];
      }
    }
    if (Sr) {
#pragma unroll
      for (int k = 0; k < K; ++k) Sr[static_cast<size_t>(t - 1) * K + k] = S[k];
#pragma unroll
      for (int i = 0; i < R; ++i) Fr[static_cast<size_t>(t - 1) * R + i] = f[i];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = i; j < R; ++j) {
        const int k = tri<R>(i, j);
        S[k] = O::mul(O::mul(p[i], p[j]),
                      O::add(S[k], O::mul(d_prev, O::mul(w_prev[i], w_prev[j]))));
      }
    }
    T su[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      T acc = O::mul(S[sym<R>(i, 0)], u[0]);
#pragma unroll
      for (int j = 1; j < R; ++j) acc = O::add(acc, O::mul(S[sym<R>(i, j)], u[j]));
      su[i] = acc;
    }
    T dot = O::mul(u[0], su[0]);
#pragma unroll
    for (int i = 1; i < R; ++i) dot = O::add(dot, O::mul(u[i], su[i]));
    const T d = O::sub(a, dot);
    T w[R];
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = O::div(O::sub(v[i], su[i]), d);
    if (yr) {
#pragma unroll
      for (int i = 0; i < R; ++i) f[i] = O::mul(p[i], O::add(f[i], O::mul(w_prev[i], z_prev)));
      T dotf = O::mul(u[0], f[0]);
#pragma unroll
      for (int i = 1; i < R; ++i) dotf = O::add(dotf, O::mul(u[i], f[i]));
      z_prev = O::sub(yt, dotf);
      if (z) z[rn_ + t] = z_prev;
    }
    D[rn_ + t] = d;
    if (W) {
#pragma unroll
      for (int i = 0; i < R; ++i) W[(rn_ + t) * R + i] = w[i];
    }
    d_prev = d;
#pragma unroll
    for (int i = 0; i < R; ++i) w_prev[i] = w[i];
  }
}

// G2: the reverse sweep of G1 with y, in the order of
// ops/celerite.py::celerite_adjoint_plain. G is the adjoint of S, kept
// symmetric (packed); dD and dz are the adjoints of G1's outputs.
template <typename T, int R>
__global__ void __launch_bounds__(kRowsPerBlock)
celerite_adjoint_kernel(const T* __restrict__ U, const T* __restrict__ P,
                        const T* __restrict__ D, const T* __restrict__ W,
                        const T* __restrict__ z, const T* __restrict__ s_saved,
                        const T* __restrict__ f_saved, const T* __restrict__ dD,
                        const T* __restrict__ dz, int b, int n, T* __restrict__ dA,
                        T* __restrict__ dU, T* __restrict__ dV, T* __restrict__ dP,
                        T* __restrict__ dy) {
  using O = Rn<T>;
  constexpr int K = R * (R + 1) / 2;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= b) return;
  const size_t rn_ = static_cast<size_t>(row) * n;
  const size_t rp_ = static_cast<size_t>(row) * (n - 1);
  const T half = T(0.5);

  T G[K], wb[R], fb[R];
#pragma unroll
  for (int k = 0; k < K; ++k) G[k] = T(0);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    wb[i] = T(0);
    fb[i] = T(0);
  }
  T db = dD[rn_ + n - 1];
  T zb = dz[rn_ + n - 1];
  for (int t = n - 1; t >= 1; --t) {
    T p[R], u[R], w_prev[R], w[R], fs[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      p[i] = P[(rp_ + t - 1) * R + i];
      u[i] = U[(rn_ + t) * R + i];
      w_prev[i] = W[(rn_ + t - 1) * R + i];
      w[i] = W[(rn_ + t) * R + i];
      fs[i] = f_saved[(rp_ + t - 1) * R + i];
    }
    const T d_prev = D[rn_ + t - 1], z_prev = z[rn_ + t - 1], d = D[rn_ + t];
    const T dD_prev = dD[rn_ + t - 1], dz_prev = dz[rn_ + t - 1];
    // the forward step again, from the saved state
    T st[K];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = i; j < R; ++j) {
        const int k = tri<R>(i, j);
        st[k] = O::add(s_saved[(rp_ + t - 1) * K + k],
                       O::mul(d_prev, O::mul(w_prev[i], w_prev[j])));
      }
    }
    T su[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      T acc = O::mul(O::mul(O::mul(p[i], p[0]), st[sym<R>(i, 0)]), u[0]);
#pragma unroll
      for (int j = 1; j < R; ++j)
        acc = O::add(acc, O::mul(O::mul(O::mul(p[i], p[j]), st[sym<R>(i, j)]), u[j]));
      su[i] = acc;
    }
    T ft[R], fn[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      ft[i] = O::add(fs[i], O::mul(w_prev[i], z_prev));
      fn[i] = O::mul(p[i], ft[i]);
    }
    // z_t = y_t - u . f_t
    dy[rn_ + t] = zb;
    const T nzb = -zb;
    T ub[R], pb[R], ftb[R], wb_prev[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      ub[i] = O::mul(nzb, fn[i]);
      fb[i] = O::add(fb[i], O::mul(nzb, u[i]));
      // f_t = p (f_{t-1} + W_{t-1} z_{t-1})
      pb[i] = O::mul(fb[i], ft[i]);
      ftb[i] = O::mul(fb[i], p[i]);
      wb_prev[i] = O::mul(ftb[i], z_prev);
    }
    T zb_prev = O::mul(ftb[0], w_prev[0]);
#pragma unroll
    for (int i = 1; i < R; ++i) zb_prev = O::add(zb_prev, O::mul(ftb[i], w_prev[i]));
    zb_prev = O::add(dz_prev, zb_prev);
    // W_t = (v_t - Su) / D_t
    T sub[R];
    T ww = O::mul(wb[0], w[0]);
#pragma unroll
    for (int i = 1; i < R; ++i) ww = O::add(ww, O::mul(wb[i], w[i]));
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const T vb = O::div(wb[i], d);
      dV[(rn_ + t) * R + i] = vb;
      sub[i] = -vb;
    }
    db = O::sub(db, O::div(ww, d));
    // D_t = a_t - u . Su
    dA[rn_ + t] = db;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      ub[i] = O::sub(ub[i], O::mul(db, su[i]));
      sub[i] = O::sub(sub[i], O::mul(db, u[i]));
    }
    // Su = S_t u_t
#pragma unroll
    for (int i = 0; i < R; ++i) {
      T acc = O::mul(O::mul(O::mul(p[i], p[0]), st[sym<R>(i, 0)]), sub[0]);
#pragma unroll
      for (int j = 1; j < R; ++j)
        acc = O::add(acc, O::mul(O::mul(O::mul(p[i], p[j]), st[sym<R>(i, j)]), sub[j]));
      dU[(rn_ + t) * R + i] = O::add(ub[i], acc);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = i; j < R; ++j) {
        const int k = tri<R>(i, j);
        G[k] = O::add(G[k], O::mul(O::add(O::mul(sub[i], u[j]), O::mul(u[i], sub[j])), half));
      }
    }
    // S_t = (p_i p_j) S~
#pragma unroll
    for (int i = 0; i < R; ++i) {
      T acc = O::mul(O::mul(G[sym<R>(i, 0)], st[sym<R>(i, 0)]), p[0]);
#pragma unroll
      for (int j = 1; j < R; ++j)
        acc = O::add(acc, O::mul(O::mul(G[sym<R>(i, j)], st[sym<R>(i, j)]), p[j]));
      dP[(rp_ + t - 1) * R + i] = O::add(pb[i], O::add(acc, acc));
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = i; j < R; ++j) {
        const int k = tri<R>(i, j);
        G[k] = O::mul(G[k], O::mul(p[i], p[j]));
      }
    }
    // S~ = S_{t-1} + D_{t-1} W_{t-1} W_{t-1}^T
    T q[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      T acc = O::mul(G[sym<R>(i, 0)], w_prev[0]);
#pragma unroll
      for (int j = 1; j < R; ++j) acc = O::add(acc, O::mul(G[sym<R>(i, j)], w_prev[j]));
      q[i] = acc;
    }
    T wq = O::mul(w_prev[0], q[0]);
#pragma unroll
    for (int i = 1; i < R; ++i) wq = O::add(wq, O::mul(w_prev[i], q[i]));
    db = O::add(dD_prev, wq);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      wb[i] = O::add(wb_prev[i], O::mul(d_prev, O::add(q[i], q[i])));
      fb[i] = ftb[i];
    }
    zb = zb_prev;
  }
  // t = 0: D_0 = A_0, W_0 = V_0 / D_0, z_0 = y_0
  dy[rn_] = zb;
  const T d0 = D[rn_];
  T ww = O::mul(wb[0], W[rn_ * R]);
#pragma unroll
  for (int i = 1; i < R; ++i) ww = O::add(ww, O::mul(wb[i], W[rn_ * R + i]));
#pragma unroll
  for (int i = 0; i < R; ++i) {
    dV[rn_ * R + i] = O::div(wb[i], d0);
    dU[rn_ * R + i] = T(0);
  }
  dA[rn_] = O::sub(db, O::div(ww, d0));
}

// G3: X = K^{-1} Y for one factored system, one thread a column of Y [n, k].
// Forward: f = p (f + W_{t-1} z_{t-1}), z_t = Y_t - u_t . f, written as
// z_t / D_t; backward: g = p_t (g + U_{t+1} x_{t+1}), x_t = zd_t - W_t . g.
template <typename T, int R>
__global__ void __launch_bounds__(kColsPerBlock)
celerite_solve_kernel(const T* __restrict__ U, const T* __restrict__ P,
                      const T* __restrict__ D, const T* __restrict__ W,
                      const T* __restrict__ Y, int n, int k, T* __restrict__ X) {
  using O = Rn<T>;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= k) return;
  T f[R];
#pragma unroll
  for (int i = 0; i < R; ++i) f[i] = T(0);
  T z_prev = Y[col];
  X[col] = O::div(z_prev, D[0]);
  for (int t = 1; t < n; ++t) {
    T dotf = T(0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      f[i] = O::mul(P[static_cast<size_t>(t - 1) * R + i],
                    O::add(f[i], O::mul(W[static_cast<size_t>(t - 1) * R + i], z_prev)));
      const T uf = O::mul(U[static_cast<size_t>(t) * R + i], f[i]);
      dotf = i == 0 ? uf : O::add(dotf, uf);
    }
    z_prev = O::sub(Y[static_cast<size_t>(t) * k + col], dotf);
    X[static_cast<size_t>(t) * k + col] = O::div(z_prev, D[t]);
  }
  T g[R];
#pragma unroll
  for (int i = 0; i < R; ++i) g[i] = T(0);
  T x_next = X[static_cast<size_t>(n - 1) * k + col];
  for (int t = n - 2; t >= 0; --t) {
    T dotg = T(0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      g[i] = O::mul(P[static_cast<size_t>(t) * R + i],
                    O::add(g[i], O::mul(U[static_cast<size_t>(t + 1) * R + i], x_next)));
      const T wg = O::mul(W[static_cast<size_t>(t) * R + i], g[i]);
      dotg = i == 0 ? wg : O::add(dotg, wg);
    }
    x_next = O::sub(X[static_cast<size_t>(t) * k + col], dotg);
    X[static_cast<size_t>(t) * k + col] = x_next;
  }
}

template <typename T>
cudaError_t forward(const T* A, const T* U, const T* V, const T* P, const T* y, int b, int n,
                    int r, T* D, T* W, T* z, T* s_saved, T* f_saved, cudaStream_t stream) {
  if (b < 1 || n < 1 || (z && !y) || (s_saved && !f_saved)) return cudaErrorInvalidValue;
  const int blocks = (b + kRowsPerBlock - 1) / kRowsPerBlock;
  switch (r) {
#define PERIODICITY_CELERITE_CASE(RR)                                                     \
  case RR:                                                                                \
    celerite_forward_kernel<T, RR><<<blocks, kRowsPerBlock, 0, stream>>>(                 \
        A, U, V, P, y, b, n, D, W, z, s_saved, f_saved);                                  \
    return cudaGetLastError();
    PERIODICITY_CELERITE_CASE(1)
    PERIODICITY_CELERITE_CASE(2)
    PERIODICITY_CELERITE_CASE(3)
    PERIODICITY_CELERITE_CASE(4)
    PERIODICITY_CELERITE_CASE(5)
    PERIODICITY_CELERITE_CASE(6)
    PERIODICITY_CELERITE_CASE(7)
    PERIODICITY_CELERITE_CASE(8)
#undef PERIODICITY_CELERITE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t adjoint(const T* U, const T* P, const T* D, const T* W, const T* z,
                    const T* s_saved, const T* f_saved, const T* dD, const T* dz, int b, int n,
                    int r, T* dA, T* dU, T* dV, T* dP, T* dy, cudaStream_t stream) {
  if (b < 1 || n < 1) return cudaErrorInvalidValue;
  const int blocks = (b + kRowsPerBlock - 1) / kRowsPerBlock;
  switch (r) {
#define PERIODICITY_CELERITE_CASE(RR)                                                     \
  case RR:                                                                                \
    celerite_adjoint_kernel<T, RR><<<blocks, kRowsPerBlock, 0, stream>>>(                 \
        U, P, D, W, z, s_saved, f_saved, dD, dz, b, n, dA, dU, dV, dP, dy);               \
    return cudaGetLastError();
    PERIODICITY_CELERITE_CASE(1)
    PERIODICITY_CELERITE_CASE(2)
    PERIODICITY_CELERITE_CASE(3)
    PERIODICITY_CELERITE_CASE(4)
    PERIODICITY_CELERITE_CASE(5)
    PERIODICITY_CELERITE_CASE(6)
    PERIODICITY_CELERITE_CASE(7)
    PERIODICITY_CELERITE_CASE(8)
#undef PERIODICITY_CELERITE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t solve(const T* U, const T* P, const T* D, const T* W, const T* Y, int n, int r,
                  int k, T* X, cudaStream_t stream) {
  if (n < 1 || k < 1) return cudaErrorInvalidValue;
  const int blocks = (k + kColsPerBlock - 1) / kColsPerBlock;
  switch (r) {
#define PERIODICITY_CELERITE_CASE(RR)                                                     \
  case RR:                                                                                \
    celerite_solve_kernel<T, RR><<<blocks, kColsPerBlock, 0, stream>>>(U, P, D, W, Y, n,  \
                                                                        k, X);            \
    return cudaGetLastError();
    PERIODICITY_CELERITE_CASE(1)
    PERIODICITY_CELERITE_CASE(2)
    PERIODICITY_CELERITE_CASE(3)
    PERIODICITY_CELERITE_CASE(4)
    PERIODICITY_CELERITE_CASE(5)
    PERIODICITY_CELERITE_CASE(6)
    PERIODICITY_CELERITE_CASE(7)
    PERIODICITY_CELERITE_CASE(8)
#undef PERIODICITY_CELERITE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

static_assert(kMaxR == 8, "the switches above instantiate R = 1..8");

}  // namespace

extern "C" {

int celerite_forward_f32(const float* A, const float* U, const float* V, const float* P,
                         const float* y, int b, int n, int r, float* D, float* W, float* z,
                         float* s_saved, float* f_saved, cudaStream_t stream) {
  return static_cast<int>(forward<float>(A, U, V, P, y, b, n, r, D, W, z, s_saved, f_saved,
                                         stream));
}

int celerite_forward_f64(const double* A, const double* U, const double* V, const double* P,
                         const double* y, int b, int n, int r, double* D, double* W, double* z,
                         double* s_saved, double* f_saved, cudaStream_t stream) {
  return static_cast<int>(forward<double>(A, U, V, P, y, b, n, r, D, W, z, s_saved, f_saved,
                                          stream));
}

int celerite_adjoint_f32(const float* U, const float* P, const float* D, const float* W,
                         const float* z, const float* s_saved, const float* f_saved,
                         const float* dD, const float* dz, int b, int n, int r, float* dA,
                         float* dU, float* dV, float* dP, float* dy, cudaStream_t stream) {
  return static_cast<int>(adjoint<float>(U, P, D, W, z, s_saved, f_saved, dD, dz, b, n, r, dA,
                                         dU, dV, dP, dy, stream));
}

int celerite_adjoint_f64(const double* U, const double* P, const double* D, const double* W,
                         const double* z, const double* s_saved, const double* f_saved,
                         const double* dD, const double* dz, int b, int n, int r, double* dA,
                         double* dU, double* dV, double* dP, double* dy, cudaStream_t stream) {
  return static_cast<int>(adjoint<double>(U, P, D, W, z, s_saved, f_saved, dD, dz, b, n, r, dA,
                                          dU, dV, dP, dy, stream));
}

int celerite_solve_f32(const float* U, const float* P, const float* D, const float* W,
                       const float* Y, int n, int r, int k, float* X, cudaStream_t stream) {
  return static_cast<int>(solve<float>(U, P, D, W, Y, n, r, k, X, stream));
}

int celerite_solve_f64(const double* U, const double* P, const double* D, const double* W,
                       const double* Y, int n, int r, int k, double* X, cudaStream_t stream) {
  return static_cast<int>(solve<double>(U, P, D, W, Y, n, r, k, X, stream));
}

}  // extern "C"
