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
// latency of one dependent floating-point operation. The chain binds. A
// warp issues its instructions in order, so whatever else sits in the
// stream of the warp that walks the chain (staging copies, stores to
// device memory, address arithmetic, a division the chain does not need
// and its branch) lengthens every step; G1 and G3 give that work to other
// warps of the block.
//
// G1: a group of lanes a walker. G = the next power of two >= R lanes walk
// one walker (4 walkers a warp at R = 5..8), so a group never straddles a
// warp; config 5's 64 walkers spread over 16 blocks. Lane i < R owns row i
// of the state S, in full, and u_i, v_i, p_i, W_i and f_i. The state is
// symmetric bit for bit (each entry is a product of commuting factors), so
// lane i's (p_i p_j)(S_ij + D (W_i W_j)) are the plain version's bits for
// j < i too. Each step lane i updates its row, sums Su_i over j and divides
// W_i = (v_i - Su_i) / D: the R divisions run side by side on R lanes
// instead of one after another on one thread. The sums across rows (u . Su
// for D, u . f for z) are taken by every lane of the group in the plain
// order from products brought in with __shfl_sync, so every lane holds the
// same D and z, NaN or non-positive included; W of the step before comes
// the same way. Lanes past R repeat row R - 1 and write nothing. A second
// warp stages the inputs of the next 16 steps in shared memory with
// cp.async and writes the last 16 steps' D, z and W out of it. The outputs
// keep their layouts: S_saved is the packed upper triangle, row-major
// (R (R + 1) / 2 values; lane i writes its entries j >= i), saved before
// each step's update with f, for G2, which recomputes the rest of the step
// from them.
//
// G2: one thread walks one walker, the state in registers (R is a
// template parameter, 1 to 8, so the state arrays are registers).
//
// G3: one column of the right-hand sides a lane, each column's recursion
// one lane's walk in the plain order, 32 columns a block, so K = 2148
// spreads over 68 blocks. Warp 0 walks; four more warps stage the next 32
// rows of the coefficients (P, U, W, D), which every column shares, and of
// the block's columns of Y (forward) or of the forward sweep's z / D
// (backward), and finish the rows before: the division by D and the stores
// to X. Each sweep's step touches one row: the forward finishes row r with
// f = p_r (f + W_r z_r), the backward with g = g + U_r x_r, and the next row
// in its direction scales by p.
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
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRowsPerBlock = 32;     // G2: a thread a walker
constexpr int kForwardWarps = 2;      // G1: one warp walks, one stages
constexpr int kColsPerBlock = kWarp;  // G3: a lane a column
constexpr int kSolveWarps = 5;        // G3: one warp walks, four stage and finish
constexpr int kRowTile = 32;          // G3: rows a staged tile

using rn::Rn;

// G1's lanes a walker: the next power of two >= R
__host__ __device__ constexpr int group_lanes(int r) {
  return r <= 1 ? 1 : r <= 2 ? 2 : r <= 4 ? 4 : 8;
}

// G1's steps a staged tile: 8 at R <= 2, whose blocks hold 16 or 32 walkers
__host__ __device__ constexpr int step_tile(int r) { return r > 2 ? 16 : 8; }

// slot of (i, j), i <= j, in the packed upper triangle
template <int R>
__device__ __forceinline__ constexpr int tri(int i, int j) {
  return i * R - i * (i - 1) / 2 + (j - i);
}

template <int R>
__device__ __forceinline__ constexpr int sym(int i, int j) {
  return i <= j ? tri<R>(i, j) : tri<R>(j, i);
}

// one element (4 or 8 bytes) from device to shared memory with cp.async
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async copies 4 or 8 bytes here");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(sizeof(T))
               : "memory");
}

// until every copy this thread issued has landed
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// G1. A [b, n], U, V [b, n, R], P [b, n-1, R], y [b, n] (kY). Writes D
// [b, n]; W [b, n, R] and z [b, n] (kY) where not null, S_saved [b, n-1, K]
// and f_saved [b, n-1, R] (kSave). Per step t >= 1, p = P[t-1]:
//   S_ij = (p_i p_j) (S_ij + D_{t-1} (W_{t-1,i} W_{t-1,j}))
//   Su_i = sum_j S_ij u_j;  D_t = a_t - sum_i u_i Su_i;  W_t = (v_t - Su) / D_t
//   f_i  = p_i (f_i + W_{t-1,i} z_{t-1});  z_t = y_t - sum_i u_i f_i
// A block is two warps: warp 0 walks 32 / G walkers, G lanes each; warp 1
// stages the next tile's inputs and writes out the last tile's D, z and W
// while warp 0 walks this one, and the two meet at one barrier a tile. A
// step of warp 0 has no branch but the division's own and touches no
// device memory but the saved state's: y and the saved state are template
// parameters, z comes before D in the step (it needs only the step
// before), so the scheduler overlaps the two chains, and the step's shared
// addresses are induction variables, which the compiler keeps in
// registers instead of rebuilding them each step.
template <typename T, int R, bool kY, bool kSave>
__global__ void __launch_bounds__(kForwardWarps * kWarp)
celerite_forward_kernel(const T* __restrict__ A, const T* __restrict__ U,
                        const T* __restrict__ V, const T* __restrict__ P,
                        const T* __restrict__ y, int b, int n, T* __restrict__ D,
                        T* __restrict__ W, T* __restrict__ z, T* __restrict__ s_saved,
                        T* __restrict__ f_saved) {
  using O = Rn<T>;
  constexpr int K = R * (R + 1) / 2;
  constexpr int G = group_lanes(R);
  constexpr int WB = kWarp / G;
  constexpr int TS = step_tile(R);
  // each walker's inputs and outputs of TS steps, two tiles in turn; a row
  // of one more element, so the groups' accesses of one step fall in
  // different banks
  __shared__ T t_a[2][WB][TS + 1], t_y[2][WB][TS + 1];
  __shared__ T t_u[2][WB][TS * R + 1], t_v[2][WB][TS * R + 1], t_p[2][WB][TS * R + 1];
  __shared__ T o_d[2][WB][TS + 1], o_z[2][WB][TS + 1], o_w[2][WB][TS * R + 1];
  static_assert(sizeof(T) * WB * 8 * (TS + 1 + TS * R + 1) <= 48 * 1024,
                "G1's tiles fit in 48 KB of static shared memory");

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int first = blockIdx.x * WB;
  const int tiles = (n - 1 + TS - 1) / TS;

  if (warp == 1) {
    // tile m holds steps 1 + m TS ..; walkers past b read walker b - 1
    auto stage = [&](int m) {
      const int buf = m & 1, t0 = 1 + m * TS, cnt = min(TS, n - t0);
      for (int e = lane; e < WB * TS; e += kWarp) {
        const int w = e / TS, s = e % TS;
        if (s < cnt) {
          const size_t r = static_cast<size_t>(min(first + w, b - 1));
          copy_async(&t_a[buf][w][s], A + r * n + t0 + s);
          if (kY) copy_async(&t_y[buf][w][s], y + r * n + t0 + s);
        }
      }
      for (int e = lane; e < WB * TS * R; e += kWarp) {
        const int w = e / (TS * R), s = e % (TS * R);
        if (s < cnt * R) {
          const size_t r = static_cast<size_t>(min(first + w, b - 1));
          copy_async(&t_u[buf][w][s], U + (r * n + t0) * R + s);
          copy_async(&t_v[buf][w][s], V + (r * n + t0) * R + s);
          copy_async(&t_p[buf][w][s], P + (r * (n - 1) + t0 - 1) * R + s);
        }
      }
    };
    // tile m's D, z and W of the block's walkers below b
    auto flush = [&](int m) {
      const int buf = m & 1, t0 = 1 + m * TS, cnt = min(TS, n - t0);
      for (int e = lane; e < WB * TS; e += kWarp) {
        const int w = e / TS, s = e % TS;
        if (s < cnt && first + w < b) {
          const size_t o = static_cast<size_t>(first + w) * n + t0 + s;
          D[o] = o_d[buf][w][s];
          if (kY && z) z[o] = o_z[buf][w][s];
        }
      }
      if (W)
        for (int e = lane; e < WB * TS * R; e += kWarp) {
          const int w = e / (TS * R), s = e % (TS * R);
          if (s < cnt * R && first + w < b)
            W[(static_cast<size_t>(first + w) * n + t0) * R + s] = o_w[buf][w][s];
        }
    };
    if (tiles > 0) stage(0);
    copy_wait_all();
    __syncthreads();
    for (int m = 0; m <= tiles; ++m) {
      if (m + 1 < tiles) stage(m + 1);
      if (m > 0) flush(m - 1);
      copy_wait_all();
      __syncthreads();
    }
    return;
  }

  const int slot = lane / G;         // the walker within the block
  const int i = lane % G;            // the row of S this lane owns
  const int ir = i < R ? i : R - 1;  // a lane past R repeats row R - 1
  const int base = slot * G;         // the group's first lane
  const int row = first + slot;
  const bool own = row < b && i < R;  // the lanes that write device memory
  const size_t rn_ = static_cast<size_t>(row < b ? row : b - 1) * n;
  T d_prev = A[rn_];
  T w_own = O::div(V[rn_ * R + ir], d_prev);
  T z_prev = kY ? y[rn_] : T(0);
  if (own && i == 0) {
    D[rn_] = d_prev;
    if (kY && z) z[rn_] = z_prev;
  }
  if (own && W) W[rn_ * R + i] = w_own;
  T S[R];  // row ir of the state
#pragma unroll
  for (int j = 0; j < R; ++j) S[j] = T(0);
  T f = T(0);
  // this lane's entries (ir, j >= ir) of the saved state, and its f
  const size_t rp_ = static_cast<size_t>(row < b ? row : b - 1) * (n - 1);
  T* Sp = kSave ? s_saved + rp_ * K + ir * R - ir * (ir - 1) / 2 - ir : nullptr;
  T* Fp = kSave ? f_saved + rp_ * R + ir : nullptr;
  __syncthreads();

  for (int m = 0; m <= tiles; ++m) {
    if (m < tiles) {
      const int buf = m & 1, cnt = min(TS, n - 1 - m * TS);
      // the step's rows of the tile, advanced a step at a time
      const T* ta = t_a[buf][slot];
      const T* ty = t_y[buf][slot];
      const T* tu = t_u[buf][slot];
      const T* tp = t_p[buf][slot];
      const T* tui = t_u[buf][slot] + ir;
      const T* tpi = t_p[buf][slot] + ir;
      const T* tvi = t_v[buf][slot] + ir;
      T* od = o_d[buf][slot];
      T* oz = o_z[buf][slot];
      T* ow = o_w[buf][slot] + ir;
#pragma unroll 2
      for (int s = 0; s < cnt; ++s) {
        T u[R], p[R], wp[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          u[j] = tu[j];
          p[j] = tp[j];
          wp[j] = __shfl_sync(kFullMask, w_own, base + j);
        }
        const T ui = *tui, pi = *tpi;
        if (kSave) {
#pragma unroll
          for (int j = 0; j < R; ++j)
            if (own && j >= ir) Sp[j] = S[j];
          if (own) Fp[0] = f;
          Sp += K;
          Fp += R;
        }
        if (kY) {
          f = O::mul(pi, O::add(f, O::mul(w_own, z_prev)));
          const T qf = O::mul(ui, f);
          T dotf = __shfl_sync(kFullMask, qf, base);
#pragma unroll
          for (int j = 1; j < R; ++j) dotf = O::add(dotf, __shfl_sync(kFullMask, qf, base + j));
          z_prev = O::sub(*ty, dotf);
          *oz = z_prev;
        }
#pragma unroll
        for (int j = 0; j < R; ++j)
          S[j] = O::mul(O::mul(pi, p[j]), O::add(S[j], O::mul(d_prev, O::mul(w_own, wp[j]))));
        T su = O::mul(S[0], u[0]);
#pragma unroll
        for (int j = 1; j < R; ++j) su = O::add(su, O::mul(S[j], u[j]));
        const T q = O::mul(ui, su);
        T dot = __shfl_sync(kFullMask, q, base);
#pragma unroll
        for (int j = 1; j < R; ++j) dot = O::add(dot, __shfl_sync(kFullMask, q, base + j));
        const T d = O::sub(*ta, dot);
        *od = d;
        w_own = O::div(O::sub(*tvi, su), d);
        *ow = w_own;
        d_prev = d;
        ta += 1;
        ty += 1;
        tu += R;
        tp += R;
        tui += R;
        tpi += R;
        tvi += R;
        od += 1;
        oz += 1;
        ow += R;
      }
    }
    __syncthreads();
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

// G3: X = K^{-1} Y for one factored system, Y [n, k], a lane a column.
// Forward, row r: z_r = Y_r - u_r . f, then f = p_r (f + W_r z_r); z_r / D_r
// is written to X. Backward, row r: g = p_r g, x_r = zd_r - W_r . g, then
// g = g + U_r x_r. Warp 0 walks both sweeps and touches no device memory:
// it reads each row's operands a row ahead from shared memory and leaves
// z_r (x_r) in the tile it read Y_r (zd_r) from. The other warps, rows
// split among them, stage the next tile and finish the one before (divide
// by D and write out, or write out) while warp 0 walks this one. A tile
// goes through three slots, staged, walked and finished; the warps meet at
// one barrier a tile.
template <typename T, int R>
__global__ void __launch_bounds__(kSolveWarps * kWarp)
celerite_solve_kernel(const T* __restrict__ U, const T* __restrict__ P,
                      const T* __restrict__ D, const T* __restrict__ W,
                      const T* __restrict__ Y, int n, int k, T* __restrict__ X) {
  using O = Rn<T>;
  constexpr int RT = kRowTile, NS = 3, DW = kSolveWarps - 1, C = kColsPerBlock;
  // a tile's row s at index s + 1: warp 0 reads a row ahead, past either
  // end, without a bound
  __shared__ T t_u[NS][(RT + 2) * R], t_w[NS][(RT + 2) * R], t_p[NS][(RT + 2) * R];
  __shared__ T t_d[NS][RT], t_x[NS][RT + 2][C];
  static_assert(sizeof(T) * NS * (3 * (RT + 2) * R + RT + (RT + 2) * C) <= 48 * 1024,
                "G3's tiles fit in 48 KB of static shared memory");
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int col = blockIdx.x * C + lane;
  const bool live = col < k;
  const int tiles = (n + RT - 1) / RT;

  if (warp > 0) {
    const int h = (warp - 1) * kWarp + lane;  // this thread among the DW warps
    // rows m RT .. of U, W, P (zeros past its n - 1 rows, so the backward's
    // state stays 0 on row n - 1), D (forward) and the block's columns of
    // src into slot m % NS
    auto stage = [&](int m, const T* src, bool forward) {
      if (m < 0 || m >= tiles) return;
      const int sl = m % NS, r0 = m * RT, cnt = min(RT, n - r0);
      const int cnt_p = min(cnt, n - 1 - r0);
      const size_t c0 = static_cast<size_t>(r0) * R;
      for (int e = h; e < cnt * R; e += DW * kWarp) {
        copy_async(&t_u[sl][R + e], U + c0 + e);
        copy_async(&t_w[sl][R + e], W + c0 + e);
        if (e < cnt_p * R)
          copy_async(&t_p[sl][R + e], P + c0 + e);
        else
          t_p[sl][R + e] = T(0);
      }
      if (forward && h < cnt) copy_async(&t_d[sl][h], D + r0 + h);
      if (live)
        for (int s = warp - 1; s < cnt; s += DW)
          copy_async(&t_x[sl][s + 1][lane], src + static_cast<size_t>(r0 + s) * k + col);
    };
    // tile m's rows to X, divided by D (forward) or as they are
    auto finish = [&](int m, bool forward) {
      if (m < 0 || m >= tiles || !live) return;
      const int sl = m % NS, r0 = m * RT, cnt = min(RT, n - r0);
      for (int s = warp - 1; s < cnt; s += DW) {
        const T x = t_x[sl][s + 1][lane];
        X[static_cast<size_t>(r0 + s) * k + col] = forward ? O::div(x, t_d[sl][s]) : x;
      }
    };
    stage(0, Y, true);
    copy_wait_all();
    __syncthreads();
    for (int m = 0; m <= tiles; ++m) {
      finish(m - 1, true);
      stage(m + 1, Y, true);
      copy_wait_all();
      __syncthreads();
    }
    // each thread reads back the rows of X it wrote
    stage(tiles - 1, X, false);
    copy_wait_all();
    __syncthreads();
    for (int m = tiles - 1; m >= -1; --m) {
      finish(m + 1, false);
      stage(m - 1, X, false);
      copy_wait_all();
      __syncthreads();
    }
    return;
  }

  T f[R];
#pragma unroll
  for (int j = 0; j < R; ++j) f[j] = T(0);
  __syncthreads();
  for (int m = 0; m <= tiles; ++m) {
    if (m < tiles) {
      const int sl = m % NS, r0 = m * RT, cnt = min(RT, n - r0);
      // row s's operands, advanced a row at a time (induction variables
      // keep the shared addresses in registers), and row s + 1's read ahead
      const T* tu = &t_u[sl][R];
      const T* tw = &t_w[sl][R];
      const T* tp = &t_p[sl][R];
      T* tx = &t_x[sl][1][lane];
      T u[R], w[R], p[R], y_r = *tx;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        u[j] = tu[j];
        w[j] = tw[j];
        p[j] = tp[j];
      }
#pragma unroll 4
      for (int s = 0; s < cnt; ++s) {
        T un[R], wn[R], pn[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          un[j] = tu[R + j];
          wn[j] = tw[R + j];
          pn[j] = tp[R + j];
        }
        const T yn = tx[C];
        T dotf = O::mul(u[0], f[0]);
#pragma unroll
        for (int j = 1; j < R; ++j) dotf = O::add(dotf, O::mul(u[j], f[j]));
        const T zr = r0 + s > 0 ? O::sub(y_r, dotf) : y_r;
        *tx = zr;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          f[j] = O::mul(p[j], O::add(f[j], O::mul(w[j], zr)));
          u[j] = un[j];
          w[j] = wn[j];
          p[j] = pn[j];
        }
        y_r = yn;
        tu += R;
        tw += R;
        tp += R;
        tx += C;
      }
    }
    __syncthreads();
  }

  T g[R];
#pragma unroll
  for (int j = 0; j < R; ++j) g[j] = T(0);
  __syncthreads();
  for (int m = tiles - 1; m >= -1; --m) {
    if (m >= 0) {
      const int sl = m % NS, r0 = m * RT, cnt = min(RT, n - r0);
      const T* tu = &t_u[sl][cnt * R];
      const T* tw = &t_w[sl][cnt * R];
      const T* tp = &t_p[sl][cnt * R];
      T* tx = &t_x[sl][cnt][lane];
      T u[R], w[R], p[R], zd = *tx;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        u[j] = tu[j];
        w[j] = tw[j];
        p[j] = tp[j];
      }
#pragma unroll 4
      for (int s = cnt - 1; s >= 0; --s) {
        T un[R], wn[R], pn[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          un[j] = tu[j - R];
          wn[j] = tw[j - R];
          pn[j] = tp[j - R];
        }
        const T zn = tx[-C];
#pragma unroll
        for (int j = 0; j < R; ++j) g[j] = O::mul(p[j], g[j]);
        T dotg = O::mul(w[0], g[0]);
#pragma unroll
        for (int j = 1; j < R; ++j) dotg = O::add(dotg, O::mul(w[j], g[j]));
        const T x = r0 + s + 1 < n ? O::sub(zd, dotg) : zd;
        *tx = x;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          g[j] = O::add(g[j], O::mul(u[j], x));
          u[j] = un[j];
          w[j] = wn[j];
          p[j] = pn[j];
        }
        zd = zn;
        tu -= R;
        tw -= R;
        tp -= R;
        tx -= C;
      }
    }
    __syncthreads();
  }
}

int forward_blocks(int b, int r) {
  const int walkers = kWarp / group_lanes(r);
  return (b + walkers - 1) / walkers;
}

int solve_blocks(int k) { return (k + kColsPerBlock - 1) / kColsPerBlock; }

template <typename T, int R>
cudaError_t forward_r(const T* A, const T* U, const T* V, const T* P, const T* y, int b, int n,
                      T* D, T* W, T* z, T* s_saved, T* f_saved, cudaStream_t stream) {
  const int blocks = forward_blocks(b, R), threads = kForwardWarps * kWarp;
  if (y && s_saved)
    celerite_forward_kernel<T, R, true, true>
        <<<blocks, threads, 0, stream>>>(A, U, V, P, y, b, n, D, W, z, s_saved, f_saved);
  else if (y)
    celerite_forward_kernel<T, R, true, false>
        <<<blocks, threads, 0, stream>>>(A, U, V, P, y, b, n, D, W, z, s_saved, f_saved);
  else if (s_saved)
    celerite_forward_kernel<T, R, false, true>
        <<<blocks, threads, 0, stream>>>(A, U, V, P, y, b, n, D, W, z, s_saved, f_saved);
  else
    celerite_forward_kernel<T, R, false, false>
        <<<blocks, threads, 0, stream>>>(A, U, V, P, y, b, n, D, W, z, s_saved, f_saved);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const T* A, const T* U, const T* V, const T* P, const T* y, int b, int n,
                    int r, T* D, T* W, T* z, T* s_saved, T* f_saved, cudaStream_t stream) {
  if (b < 1 || n < 1 || (z && !y) || (s_saved && !f_saved)) return cudaErrorInvalidValue;
  switch (r) {
#define PERIODICITY_CELERITE_CASE(RR) \
  case RR:                            \
    return forward_r<T, RR>(A, U, V, P, y, b, n, D, W, z, s_saved, f_saved, stream);
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
  const int blocks = solve_blocks(k);
  switch (r) {
#define PERIODICITY_CELERITE_CASE(RR)                                                     \
  case RR:                                                                                \
    celerite_solve_kernel<T, RR><<<blocks, kSolveWarps * kWarp, 0, stream>>>(             \
        U, P, D, W, Y, n, k, X);                                                          \
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

// G1's launch: out = {lanes a walker, walkers a block, blocks, threads a
// block, steps a staged tile}; G3's: out = {columns a block, blocks,
// threads a block, rows a staged tile}
int celerite_forward_geometry(int b, int r, int* out) {
  if (b < 1 || r < 1 || r > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = group_lanes(r);
  out[1] = kWarp / group_lanes(r);
  out[2] = forward_blocks(b, r);
  out[3] = kForwardWarps * kWarp;
  out[4] = step_tile(r);
  return 0;
}

int celerite_solve_geometry(int k, int* out) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = kColsPerBlock;
  out[1] = solve_blocks(k);
  out[2] = kSolveWarps * kWarp;
  out[3] = kRowTile;
  return 0;
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
