// The celerite recursions for Hopper (sm_90a): the fused factor and forward
// substitution (G1), its adjoint (G2) and the two-sweep solve (G3), for R =
// 1 to 16 slots. celerite.cu holds the plain C interface, loaded with ctypes
// by periodicity_tpu_torch/ops/_kernels.py, and the widths R <= 8; each pair
// of wider ones has a translation unit of its own (celerite_r*.cu), which
// nvcc builds in parallel with the others.
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
// one walker (4 walkers a warp at R = 5..8, 2 at R = 9..16), so a group
// never straddles a
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
// G2: G1's lanes on the reverse sweep. Lane i < R owns row i of the
// adjoint state G and of the state the forward step rebuilds from the saved
// one, O(R) registers a lane (R is a template parameter, 1 to 16); the sums
// across rows come by __shfl_sync in the plain order, as in G1. Three
// staging warps bring the saved state and the other inputs of the next 8 or
// 16 steps into shared memory (dynamic, up to 135 KB a block at R = 8 and
// 196 KB at R = 16 in float64) and write the outputs out of it.
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

#pragma once

#include <cuda_runtime.h>

#include <atomic>

#include "rn.cuh"

namespace {

constexpr int kMaxR = 16;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kForwardWarps = 2;      // G1: one warp walks, one stages
constexpr int kAdjointWarps = 4;      // G2: one warp walks, three stage
constexpr int kColsPerBlock = kWarp;  // G3: a lane a column
constexpr int kSolveWarps = 5;        // G3: one warp walks, four stage and finish
// a block's shared memory on Hopper, dynamic past the first 48 KB
constexpr int kMaxSharedBytes = 227 * 1024;

using rn::Rn;

// G1's and G2's lanes a walker: the next power of two >= R
__host__ __device__ constexpr int group_lanes(int r) {
  return r <= 1 ? 1 : r <= 2 ? 2 : r <= 4 ? 4 : r <= 8 ? 8 : 16;
}

// G1's and G2's steps a staged tile: 8 at R <= 2, whose blocks hold 16 or 32 walkers
__host__ __device__ constexpr int step_tile(int r) { return r > 2 ? 16 : 8; }

// G3's rows a staged tile: 16 past R = 8, where 32 rows of float64
// coefficients outgrow 48 KB of static shared memory
__host__ __device__ constexpr int solve_row_tile(int r) { return r > 8 ? 16 : 32; }

// slot of (i, j), i <= j, in the packed upper triangle
template <int R>
__device__ __forceinline__ constexpr int tri(int i, int j) {
  return i * R - i * (i - 1) / 2 + (j - i);
}

template <int R>
__device__ __forceinline__ constexpr int sym(int i, int j) {
  return i <= j ? tri<R>(i, j) : tri<R>(j, i);
}

// a / d as Rn<T>::div rounds it, with a zero a kept off the division's slow
// path: a masked slot's W-bar is 0 at every step of G2, and __ddiv_rn /
// __fdiv_rn send a zero numerator to a subroutine call that stalls the
// whole warp. 0 / d is a zero signed by a and d, which a * d gives for
// every finite nonzero d; an infinite, zero or NaN d takes the division.
template <typename T>
__device__ __forceinline__ T div_rn(T a, T d) {
  return a == T(0) && isfinite(d) && d != T(0) ? Rn<T>::mul(a, d) : Rn<T>::div(a, d);
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

// G2's shared tiles: one record a walker and buffer, holding the inputs of
// a tile of TS steps going down in t and their outputs (offsets in elements
// of T). Step t of a tile that holds t_lo .. t_hi sits at k = t - t_lo; the
// rows W[t - 1], W[t] and D[t - 1], D[t] at k and k + 1. S_saved[t - 1]
// arrives unpacked, row i at i (R + 1), so each lane reads its own row of
// S~ at fixed offsets; the padding and an odd record length put the lanes'
// and the walkers' reads of one step in different banks.
template <int R>
struct AdjointTile {
  static constexpr int G = group_lanes(R), WB = kWarp / G, TS = step_tile(R), SR = R + 1;
  static constexpr int U = 0;                   // U[t]            [TS][R]
  static constexpr int P = U + TS * R;          // P[t - 1]        [TS][R]
  static constexpr int F = P + TS * R;          // f_saved[t - 1]  [TS][R]
  static constexpr int W = F + TS * R;          // W[t_lo - 1 ..]  [TS + 1][R]
  static constexpr int S = W + (TS + 1) * R;    // S_saved[t - 1]  [TS][R][SR]
  static constexpr int D = S + TS * R * SR;     // D[t_lo - 1 ..]  [TS + 1]
  static constexpr int Z = D + TS + 1;          // z[t - 1]        [TS]
  static constexpr int DD = Z + TS;             // dD[t - 1]       [TS]
  static constexpr int DZ = DD + TS;            // dz[t - 1]       [TS]
  static constexpr int OU = DZ + TS;            // dU[t]           [TS][R]
  static constexpr int OV = OU + TS * R;        // dV[t]           [TS][R]
  static constexpr int OP = OV + TS * R;        // dP[t - 1]       [TS][R]
  static constexpr int OY = OP + TS * R;        // dy[t]           [TS]
  static constexpr int OA = OY + TS;            // dA[t]           [TS]
  static constexpr int stride = (OA + TS) | 1;  // elements a record
  template <typename T>
  static constexpr int bytes() {
    return static_cast<int>(sizeof(T)) * 2 * WB * stride;
  }
};

// G2: the reverse sweep of G1 with y, in the order of
// ops/celerite.py::celerite_adjoint_plain, on G1's lanes. dD and dz are the
// adjoints of G1's outputs; the adjoint state G of S is carried in full.
// Per step t = n - 1 .. 1, p = P[t-1], S~ = S_saved[t-1] + D_{t-1} W_{t-1}
// W_{t-1}^T and S_t = (p_i p_j) S~ recomputed from the saved state:
//   dy_t = zb;  fb += -zb u;  zb = dz_{t-1} + sum_i (fb_i p_i) W_{t-1,i}
//   dV_t = wb / D_t;  db -= (sum_i wb_i W_{t,i}) / D_t;  dA_t = db
//   sub = -dV_t - db u;  dU_t = -zb p f~ - db Su + S_t sub
//   G += (sub u^T + u sub^T) / 2;  dP_{t-1} = fb f~ + 2 sum_j (G S~)_ij p_j
//   G *= p_i p_j;  q = G W_{t-1};  db = dD_{t-1} + W_{t-1} . q
//   wb = fb p z_{t-1} + D_{t-1} (q + q)
// Lane i < R owns row i of G, of S~ and of S_t, and its own p_i, u_i,
// W_{t-1,i}, W_{t,i}, f~_i, wb_i and fb_i: G1's group of lanes a walker, a
// group inside a warp. Each lane computes the plain version's entries (i, j)
// in their own operand order, so its rows are the plain rows. The sums over
// j within a row (Su, dU's, dP's, q) stay on the lane; the three over the
// rows (sum fb_i p_i W_{t-1,i}, wb . W_t, W_{t-1} . q) are taken by every
// lane from __shfl_sync products in the plain order, so every lane holds
// the same zb and db, NaN included, and sub_j comes the same way. Lanes
// past R repeat row R - 1; where R < G the last of them also divides
// W-bar . W_t, so a step has one division a lane. As in G1, warp 0 walks and touches no device
// memory inside a tile; warps 1-3 stage the next tile's inputs with
// cp.async and write the last tile's dA, dy, dU, dV and dP out of the
// shared records (AdjointTile, in dynamic shared memory); the warps meet at
// one barrier a tile. Warp 0 finishes t = 0 itself.
template <typename T, int R>
__global__ void __launch_bounds__(kAdjointWarps * kWarp)
celerite_adjoint_kernel(const T* __restrict__ U, const T* __restrict__ P,
                        const T* __restrict__ D, const T* __restrict__ W,
                        const T* __restrict__ z, const T* __restrict__ s_saved,
                        const T* __restrict__ f_saved, const T* __restrict__ dD,
                        const T* __restrict__ dz, int b, int n, T* __restrict__ dA,
                        T* __restrict__ dU, T* __restrict__ dV, T* __restrict__ dP,
                        T* __restrict__ dy) {
  using O = Rn<T>;
  using L = AdjointTile<R>;
  constexpr int K = R * (R + 1) / 2, G = L::G, WB = L::WB, TS = L::TS, SR = L::SR;
  extern __shared__ __align__(16) unsigned char g2_smem[];
  T* const records = reinterpret_cast<T*>(g2_smem);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int first = blockIdx.x * WB;
  const int tiles = (n - 1 + TS - 1) / TS;
  // tile m holds steps t_lo .. t_hi = n - 1 - m TS, cnt of them
  auto span = [&](int m, int& cnt, int& t_lo) {
    const int t_hi = n - 1 - m * TS;
    cnt = min(TS, t_hi);
    t_lo = t_hi - cnt + 1;
  };

  if (warp > 0) {
    constexpr int H = (kAdjointWarps - 1) * kWarp;  // the staging threads
    const int h = threadIdx.x - kWarp;
    // the entry (i, j) of S_saved this thread unpacks, at the steps k =
    // h / R^2 + c Q of each tile: Q groups of R^2 threads (none from R = 10,
    // where R^2 > H)
    constexpr int Q = H / (R * R);
    const int ij = h % (R * R), i = ij / R, j = ij % R;
    const bool unpacks = h < Q * R * R;
    const int s_src = sym<R>(i, j), s_dst = i * SR + j;
    // tile m's inputs into buffer m % 2; walkers past b read walker b - 1
    auto stage = [&](int m) {
      int cnt, t_lo;
      span(m, cnt, t_lo);
#pragma unroll
      for (int w = 0; w < WB; ++w) {
        const size_t r = static_cast<size_t>(min(first + w, b - 1));
        T* const rec = records + ((m & 1) * WB + w) * L::stride;
        const size_t o_t = (r * n + t_lo) * R, o_p = (r * (n - 1) + t_lo - 1) * R;
        for (int e = h; e < cnt * R; e += H) {
          copy_async(rec + L::U + e, U + o_t + e);
          copy_async(rec + L::P + e, P + o_p + e);
          copy_async(rec + L::F + e, f_saved + o_p + e);
        }
        for (int e = h; e < (cnt + 1) * R; e += H) copy_async(rec + L::W + e, W + o_t - R + e);
        const size_t o = r * n + t_lo - 1;
        for (int e = h; e <= cnt; e += H) {
          copy_async(rec + L::D + e, D + o + e);
          if (e < cnt) {
            copy_async(rec + L::Z + e, z + o + e);
            copy_async(rec + L::DD + e, dD + o + e);
            copy_async(rec + L::DZ + e, dz + o + e);
          }
        }
        if constexpr (Q > 0) {
          if (unpacks) {
            const T* const src = s_saved + (r * (n - 1) + t_lo - 1) * K + s_src;
            for (int k = h / (R * R); k < cnt; k += Q)
              copy_async(rec + L::S + k * R * SR + s_dst, src + k * K);
          }
        } else {
          // R^2 > H (R >= 10): a thread unpacks entries of several rows
          const T* const src = s_saved + (r * (n - 1) + t_lo - 1) * K;
          for (int e = h; e < cnt * R * R; e += H) {
            const int k = e / (R * R), ie = e % (R * R) / R, je = e % R;
            copy_async(rec + L::S + k * R * SR + ie * SR + je, src + k * K + sym<R>(ie, je));
          }
        }
      }
    };
    // tile m's outputs of the block's walkers below b
    auto flush = [&](int m) {
      int cnt, t_lo;
      span(m, cnt, t_lo);
#pragma unroll
      for (int w = 0; w < WB; ++w) {
        if (first + w >= b) break;
        const T* const rec = records + ((m & 1) * WB + w) * L::stride;
        const size_t r = static_cast<size_t>(first + w);
        const size_t o_t = (r * n + t_lo) * R, o_p = (r * (n - 1) + t_lo - 1) * R;
        for (int e = h; e < cnt * R; e += H) {
          dU[o_t + e] = rec[L::OU + e];
          dV[o_t + e] = rec[L::OV + e];
          dP[o_p + e] = rec[L::OP + e];
        }
        for (int e = h; e < cnt; e += H) {
          dy[r * n + t_lo + e] = rec[L::OY + e];
          dA[r * n + t_lo + e] = rec[L::OA + e];
        }
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
  const int i = lane % G;            // the row this lane owns
  const int ir = i < R ? i : R - 1;  // a lane past R repeats row R - 1
  const int base = slot * G;         // the group's first lane
  const int walker = first + slot;
  const size_t rn_ = static_cast<size_t>(walker < b ? walker : b - 1) * n;
  const T half = T(0.5);
  // the group's sum of x over lanes 0 .. R - 1, left to right
  auto rows_sum = [&](T x) {
    T acc = __shfl_sync(kFullMask, x, base);
#pragma unroll
    for (int j = 1; j < R; ++j) acc = O::add(acc, __shfl_sync(kFullMask, x, base + j));
    return acc;
  };
  T g[R];  // row ir of G
#pragma unroll
  for (int j = 0; j < R; ++j) g[j] = T(0);
  T wb = T(0), fb = T(0);
  T db = dD[rn_ + n - 1], zb = dz[rn_ + n - 1];
  __syncthreads();

  for (int m = 0; m <= tiles; ++m) {
    if (m < tiles) {
      const int cnt = min(TS, n - 1 - m * TS);
      // the step's rows, from k = cnt - 1 down, advanced a step at a time:
      // the arrays of R a step at fixed offsets from row (this lane's own
      // element from mine), those of one from one, and its row of S~
      T* const rec = records + ((m & 1) * WB + slot) * L::stride;
      T* row = rec + (cnt - 1) * R;
      T* mine = row + ir;
      T* one = rec + cnt - 1;
      const T* srow = rec + L::S + ((cnt - 1) * R + ir) * SR;
#pragma unroll 2
      for (int s = 0; s < cnt; ++s) {
        T u[R], p[R], wp[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          u[j] = row[L::U + j];
          p[j] = row[L::P + j];
          wp[j] = row[L::W + j];  // W[t - 1]; W[t] a row on
        }
        const T ui = mine[L::U], pi = mine[L::P], wpi = mine[L::W], wi = mine[L::W + R];
        const T d_prev = one[L::D], d = one[L::D + 1], z_prev = one[L::Z];
        // the forward step again: row ir of S~ and of S_t, and Su_ir
        T st[R], sn[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          st[j] = O::add(srow[j], O::mul(d_prev, O::mul(wpi, wp[j])));
          sn[j] = O::mul(O::mul(pi, p[j]), st[j]);
        }
        T su = O::mul(sn[0], u[0]);
#pragma unroll
        for (int j = 1; j < R; ++j) su = O::add(su, O::mul(sn[j], u[j]));
        const T ft = O::add(mine[L::F], O::mul(wpi, z_prev));
        // z_t = y_t - u . f_t;  f_t = p (f_{t-1} + W_{t-1} z_{t-1})
        one[L::OY] = zb;
        const T nzb = -zb;
        T ub = O::mul(nzb, O::mul(pi, ft));
        fb = O::add(fb, O::mul(nzb, ui));
        const T pb = O::mul(fb, ft);
        const T ftb = O::mul(fb, pi);
        const T wb_prev = O::mul(ftb, z_prev);
        const T zb_prev = O::add(one[L::DZ], rows_sum(O::mul(ftb, wpi)));
        // W_t = (v_t - Su) / D_t
        const T ww = rows_sum(O::mul(wb, wi));
        T vb, wwd;
        if constexpr (R < G) {
          // one division a lane, the last lane (past R) dividing ww: each
          // division ends a basic block (its slow path is a call), and two
          // in a row were the longest stretch of a step
          const T q = div_rn(i == G - 1 ? ww : wb, d);
          vb = __shfl_sync(kFullMask, q, base + ir);
          wwd = __shfl_sync(kFullMask, q, base + G - 1);
        } else {
          vb = div_rn(wb, d);
          wwd = div_rn(ww, d);
        }
        mine[L::OV] = vb;
        db = O::sub(db, wwd);
        // D_t = a_t - u . Su
        one[L::OA] = db;
        ub = O::sub(ub, O::mul(db, su));
        const T sub = O::sub(-vb, O::mul(db, ui));
        // Su = S_t u_t, and G's symmetric update
        T sj[R];
#pragma unroll
        for (int j = 0; j < R; ++j) sj[j] = __shfl_sync(kFullMask, sub, base + j);
        T du = O::mul(sn[0], sj[0]);
#pragma unroll
        for (int j = 1; j < R; ++j) du = O::add(du, O::mul(sn[j], sj[j]));
        mine[L::OU] = O::add(ub, du);
#pragma unroll
        for (int j = 0; j < R; ++j)
          g[j] = O::add(g[j], O::mul(O::add(O::mul(sub, u[j]), O::mul(ui, sj[j])), half));
        // S_t = (p_i p_j) S~
        T rp = O::mul(O::mul(g[0], st[0]), p[0]);
#pragma unroll
        for (int j = 1; j < R; ++j) rp = O::add(rp, O::mul(O::mul(g[j], st[j]), p[j]));
        mine[L::OP] = O::add(pb, O::add(rp, rp));
#pragma unroll
        for (int j = 0; j < R; ++j) g[j] = O::mul(g[j], O::mul(pi, p[j]));
        // S~ = S_{t-1} + D_{t-1} W_{t-1} W_{t-1}^T
        T q = O::mul(g[0], wp[0]);
#pragma unroll
        for (int j = 1; j < R; ++j) q = O::add(q, O::mul(g[j], wp[j]));
        db = O::add(one[L::DD], rows_sum(O::mul(wpi, q)));
        wb = O::add(wb_prev, O::mul(d_prev, O::add(q, q)));
        fb = ftb;
        zb = zb_prev;
        row -= R;
        mine -= R;
        one -= 1;
        srow -= R * SR;
      }
    }
    __syncthreads();
  }
  // t = 0: D_0 = A_0, W_0 = V_0 / D_0, z_0 = y_0
  const T d0 = D[rn_];
  const T ww = rows_sum(O::mul(wb, W[rn_ * R + ir]));
  const T vb = div_rn(wb, d0);
  const T da = O::sub(db, div_rn(ww, d0));
  if (walker < b && i < R) {
    dV[rn_ * R + i] = vb;
    dU[rn_ * R + i] = T(0);
    if (i == 0) {
      dy[rn_] = zb;
      dA[rn_] = da;
    }
  }
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
  constexpr int RT = solve_row_tile(R), NS = 3, DW = kSolveWarps - 1, C = kColsPerBlock;
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

inline int forward_blocks(int b, int r) {
  const int walkers = kWarp / group_lanes(r);
  return (b + walkers - 1) / walkers;
}

inline int solve_blocks(int k) { return (k + kColsPerBlock - 1) / kColsPerBlock; }

}  // namespace

namespace celerite_k {

// The launches of one width R. celerite.cu instantiates R <= 8 and declares
// the wider ones extern; PERIODICITY_CELERITE_WIDTH(R) instantiates one in
// the translation unit of its own.
template <typename T, int R>
struct Width {
  static cudaError_t forward(const T* A, const T* U, const T* V, const T* P, const T* y, int b,
                             int n, T* D, T* W, T* z, T* s_saved, T* f_saved,
                             cudaStream_t stream);
  static cudaError_t adjoint(const T* U, const T* P, const T* D, const T* W, const T* z,
                             const T* s_saved, const T* f_saved, const T* dD, const T* dz, int b,
                             int n, T* dA, T* dU, T* dV, T* dP, T* dy, cudaStream_t stream);
  static cudaError_t solve(const T* U, const T* P, const T* D, const T* W, const T* Y, int n,
                           int k, T* X, cudaStream_t stream);
  // every kernel's: {local memory bytes a thread, registers a thread,
  // shared memory bytes a block} for G1 with y and the saved state, with y,
  // with the saved state, with neither, then G2 and G3 (18 ints)
  static cudaError_t attributes(int* out);
};

template <typename T, int R>
cudaError_t Width<T, R>::forward(const T* A, const T* U, const T* V, const T* P, const T* y,
                                 int b, int n, T* D, T* W, T* z, T* s_saved, T* f_saved,
                                 cudaStream_t stream) {
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

template <typename T, int R>
cudaError_t Width<T, R>::adjoint(const T* U, const T* P, const T* D, const T* W, const T* z,
                                 const T* s_saved, const T* f_saved, const T* dD, const T* dz,
                                 int b, int n, T* dA, T* dU, T* dV, T* dP, T* dy,
                                 cudaStream_t stream) {
  constexpr int bytes = AdjointTile<R>::template bytes<T>();
  static_assert(bytes <= kMaxSharedBytes, "G2's tiles fit in a block's shared memory");
  // the kernel's shared-memory limit, raised once a device (the call costs
  // host time and the answer never changes)
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev % 64);
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&celerite_adjoint_kernel<T, R>),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit);
  }
  celerite_adjoint_kernel<T, R><<<forward_blocks(b, R), kAdjointWarps * kWarp, bytes, stream>>>(
      U, P, D, W, z, s_saved, f_saved, dD, dz, b, n, dA, dU, dV, dP, dy);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t Width<T, R>::solve(const T* U, const T* P, const T* D, const T* W, const T* Y,
                               int n, int k, T* X, cudaStream_t stream) {
  celerite_solve_kernel<T, R><<<solve_blocks(k), kSolveWarps * kWarp, 0, stream>>>(U, P, D, W, Y,
                                                                                  n, k, X);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t Width<T, R>::attributes(int* out) {
  const void* fns[6] = {
      reinterpret_cast<const void*>(&celerite_forward_kernel<T, R, true, true>),
      reinterpret_cast<const void*>(&celerite_forward_kernel<T, R, true, false>),
      reinterpret_cast<const void*>(&celerite_forward_kernel<T, R, false, true>),
      reinterpret_cast<const void*>(&celerite_forward_kernel<T, R, false, false>),
      reinterpret_cast<const void*>(&celerite_adjoint_kernel<T, R>),
      reinterpret_cast<const void*>(&celerite_solve_kernel<T, R>)};
  for (int k = 0; k < 6; ++k) {
    cudaFuncAttributes a{};
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[k]);
    if (err != cudaSuccess) return err;
    out[3 * k] = static_cast<int>(a.localSizeBytes);
    out[3 * k + 1] = a.numRegs;
    out[3 * k + 2] = static_cast<int>(a.sharedSizeBytes) +
                     (k == 4 ? AdjointTile<R>::template bytes<T>() : 0);
  }
  return cudaSuccess;
}

}  // namespace celerite_k

// one width's instantiation, in the translation unit that owns it, and its
// declaration in the others
#define PERIODICITY_CELERITE_WIDTH(RR)          \
  template struct celerite_k::Width<float, RR>; \
  template struct celerite_k::Width<double, RR>;
#define PERIODICITY_CELERITE_EXTERN(RR)                \
  extern template struct celerite_k::Width<float, RR>; \
  extern template struct celerite_k::Width<double, RR>;
