// K2: the adjoint of K1 (kalman.cuh), the vector-Jacobian product of the
// blocked Kalman composition, for Hopper (sm_90a), at R = 1 to 16 states.
// kalman_adjoint.cu holds its plain C interface and the widths R <= 8; each
// wider width is instantiated beside K1's in kalman_r*.cu. The wrapper and
// the plain version (kalman_blocked_adjoint_plain, with which it agrees bit
// for bit) are in periodicity_tpu_torch/ops/kalman.py.
//
// It replaces jax.grad through periodicity_tpu/models/gp/pscan.py::
// _blocked_inclusive_prefixes (:279-329): the reverse of the within-block
// lax.scan, of the associative scan over the block summaries and of the
// stitch, which XLA derives from the forward.
//
// From K1's operands, the stage-1 prefixes K1 left in its scratch and the
// cotangents of mu, s and the outgoing carry, per row, K1's stages in
// reverse, a group of lanes an item as in K1 (G lanes, the next power of
// two >= R; a block is one warp of 32 / G groups):
//   levels   the scan's levels over [carry_in, S_0 .. S_{m-1}] formed again,
//            every level kept (a launch a level, as stage 2);
//   stitch   a group a position p: the filtered (b, C) at p - 1 formed
//            again, the innovations' adjoint (dA, dQ, ddiag), then the
//            stitch's: the partial composition excl o prefix(p - 1) reversed,
//            giving the prefix's cotangent (dpre[p - 1]) and the exclusive
//            carry's share (share[p]);
//   leaf     a thread a value of a leaf: the shares of the positions that
//            compose it, summed in ascending position from zero, and the
//            outgoing carry's cotangent on the last leaf;
//   tree     a launch a level, last to first, a group a leaf i: its own
//            share (the later operand's of the pair (i - h, i) at i >= h,
//            else what the level above handed it), then the earlier
//            operand's of the pair (i, i + h); level 0 gives each summary's
//            cotangent and the incoming carry's;
//   walk     a group a (row, block): from the summary's cotangent backwards
//            through the block, at each step the prefix's cotangent plus its
//            stitch share, the step's element formed again (K1's stage-0
//            element) and the composition prefix(l - 1) o e_l reversed (the
//            identity before a block's first); the element's cotangent goes
//            to dpre[l];
//   element  a group a position: the element's adjoint (dA, dQ, ddiag, dy),
//            added to the innovations'.
//
// A composition's adjoint forms its M = I + Jj Ci, pivots and multipliers
// again exactly as K1 does (the same operations in the same order), and
// the pivots are constants, as under jax.grad. The solve M X = RHS reverses
// as dRHS = M^-T dX (U^T forward substitution, then each elimination step's
// multipliers transposed and its row swap undone, the last first) and dM =
// -dRHS X^T; the rest are products. Every product, sum, difference and
// quotient is rounded on its own through rn.cuh (a float32 quotient
// through Divisor), in the plain version's order, every sum over its index
// ascending; nothing is summed by atomics.
//
// How a group shares the work: the factorization, the intermediates of
// the adjoint and the operands a step rereads live in the group's slot of
// dynamic shared memory (Work below), never in local memory. Each matrix of
// a phase is spread over the lanes an entry at a time (entry e on lane e %
// G), each entry formed by the plain version's own sequence of roundings,
// and one __syncwarp of the group separates a phase from the next. The
// elimination takes four phases a column (the pivot, read by every lane;
// the row swap; the multipliers; the update); the back substitution, the
// U^T forward substitution and the transposed multipliers run a column of
// the right-hand side a lane, every row in turn, with no barrier between
// rows (a column depends on itself alone).
//
// What bounds it on the card: like K1, a chain of dependent compositions,
// L + 2 ceil(log2(m + 1)) + 1 of them deep, each of whose adjoints is now
// ~30 phases of a few dependent operations over shared memory. The walk
// holds one group a (row, block): at config 7 (one row, m = 39 to 512
// blocks) a few hundred lanes of the card's 132 SMs.

#pragma once

#include "kalman.cuh"

namespace {

constexpr int kAdjThreads = 64;  // the leaf kernel: a thread a value

// A composition's solve and its adjoint's intermediates, in a group's
// shared memory: [M | RHS] eliminated in place, the multipliers f[i][col]
// of each step, the solution X, t1 = bi + Ci etaj and T2 = m1t Ci with
// their cotangents, dX (then M^-T dX) and dM; the pivot rows last. The
// right-hand side is [Aj^T | etaj - Jj bi | Jj Ai] (kFull) or Aj^T.
template <typename T, int R, bool kFull>
struct Work {
  static constexpr int W = kFull ? 2 * R + 1 : R;
  T mb[R][R + W];
  T f[R][R];
  T x[R][W];
  T t1[R], t2[R][R];
  T dt1[R], dt2[R][R];
  T z[R][W];
  T dm[R][R];
  int piv[R];
};

// the factorization of ei o ej on a group (ops/kalman.py::_solve with
// factors): lane i of G, the group's mask. Ends with the group in step.
template <typename T, int R, bool kFull>
__device__ void factor(const T* ei, const T* ej, Work<T, R, kFull>& w, int i, unsigned mask) {
  using O = Rn<T>;
  using P = Pack<R>;
  constexpr int G = group_lanes(R), W = Work<T, R, kFull>::W, RW = R + W;
  #pragma unroll 1
  for (int e = i; e < R * RW; e += G) {
    const int r = e / RW, c = e % RW;
    const T* jr = ej + P::J + r * R;
    T v;
    if (c < R) {
      T acc = O::mul(jr[0], ei[P::C + c]);
      for (int l = 1; l < R; ++l) acc = O::add(acc, O::mul(jr[l], ei[P::C + l * R + c]));
      v = O::add(r == c ? T(1) : T(0), acc);
    } else if (c < 2 * R) {
      v = ej[P::A + (c - R) * R + r];
    } else if (c == 2 * R) {
      T jb = O::mul(jr[0], ei[P::B]);
      for (int l = 1; l < R; ++l) jb = O::add(jb, O::mul(jr[l], ei[P::B + l]));
      v = O::sub(ej[P::ETA + r], jb);
    } else {
      const int cc = c - 2 * R - 1;
      T g = O::mul(jr[0], ei[P::A + cc]);
      for (int l = 1; l < R; ++l) g = O::add(g, O::mul(jr[l], ei[P::A + l * R + cc]));
      v = g;
    }
    w.mb[r][c] = v;
  }
  __syncwarp(mask);
  #pragma unroll 1
  for (int col = 0; col < R - 1; ++col) {
    int p = col;
    T best = mag(w.mb[col][col]);
    #pragma unroll 1
    for (int r = col + 1; r < R; ++r) {
      const T v = mag(w.mb[r][col]);
      if (v > best) {
        best = v;
        p = r;
      }
    }
    __syncwarp(mask);
    if (p != col)
      #pragma unroll 1
      for (int c = col + i; c < RW; c += G) {
        const T a = w.mb[col][c];
        w.mb[col][c] = w.mb[p][c];
        w.mb[p][c] = a;
      }
    if (i == 0) w.piv[col] = p;
    __syncwarp(mask);
    {
      const Divisor<T> dp(w.mb[col][col]);
      #pragma unroll 1
      for (int r = col + 1 + i; r < R; r += G) w.f[r][col] = dp.quot(w.mb[r][col]);
    }
    __syncwarp(mask);
    const int cols = RW - col - 1;
    #pragma unroll 1
    for (int e = i; e < (R - col - 1) * cols; e += G) {
      const int r = col + 1 + e / cols, c = col + 1 + e % cols;
      w.mb[r][c] = O::sub(w.mb[r][c], O::mul(w.f[r][col], w.mb[col][c]));
    }
    __syncwarp(mask);
  }
  // back substitution, a column of the right-hand side a lane
  #pragma unroll 1
  for (int c = i; c < W; c += G)
    #pragma unroll 1
    for (int r = R - 1; r >= 0; --r) {
      T acc = w.mb[r][R + c];
      #pragma unroll 1
      for (int j = r + 1; j < R; ++j) acc = O::sub(acc, O::mul(w.mb[r][j], w.x[j][c]));
      w.x[r][c] = Divisor<T>(w.mb[r][r]).quot(acc);
    }
  __syncwarp(mask);
}

// t1 = bi + Ci etaj and T2 = m1t Ci (m1t[i][k] = x[k][i]) into w, on a
// group; no barrier after
template <typename T, int R, bool kFull>
__device__ __forceinline__ void middle_entry(const T* ei, const T* ej, Work<T, R, kFull>& w,
                                             int e) {
  using O = Rn<T>;
  using P = Pack<R>;
  if (e < R) {
    T acc = O::mul(ei[P::C + e * R], ej[P::ETA]);
    for (int l = 1; l < R; ++l) acc = O::add(acc, O::mul(ei[P::C + e * R + l], ej[P::ETA + l]));
    w.t1[e] = O::add(ei[P::B + e], acc);
  } else {
    const int a = (e - R) / R, l = (e - R) % R;
    T a2 = O::mul(w.x[0][a], ei[P::C + l]);
    for (int k = 1; k < R; ++k) a2 = O::add(a2, O::mul(w.x[k][a], ei[P::C + k * R + l]));
    w.t2[a][l] = a2;
  }
}

// the full composition's A, eta and J, entry e of the R^2 + R + R^2 past
// (b, C), from the factorization in w
template <typename T, int R>
__device__ __forceinline__ void compose_full_entry(const T* ei, const Work<T, R, true>& w,
                                                   T* out, int e) {
  using O = Rn<T>;
  using P = Pack<R>;
  if (e < R * R) {
    const int a = e / R, j = e % R;
    T v = O::mul(w.x[0][a], ei[P::A + j]);
    for (int k = 1; k < R; ++k) v = O::add(v, O::mul(w.x[k][a], ei[P::A + k * R + j]));
    out[P::A + a * R + j] = v;
  } else if (e < R * R + R) {
    const int a = e - R * R;
    T v = O::mul(ei[P::A + a], w.x[0][R]);
    for (int j = 1; j < R; ++j) v = O::add(v, O::mul(ei[P::A + j * R + a], w.x[j][R]));
    out[P::ETA + a] = O::add(v, ei[P::ETA + a]);
  } else {
    const int a = (e - R * R - R) / R, k = (e - R * R - R) % R;
    T v = O::mul(ei[P::A + a], w.x[0][R + 1 + k]);
    for (int j = 1; j < R; ++j) v = O::add(v, O::mul(ei[P::A + j * R + a], w.x[j][R + 1 + k]));
    out[P::J + a * R + k] = O::add(v, ei[P::J + a * R + k]);
  }
}

// the composition's value (ops/kalman.py::_combine) from the factorization
// in w: kFull the packed 5-tuple, else its (b, C) at out[0 .. R) and out[R
// ..). Ends with the group in step.
template <typename T, int R, bool kFull>
__device__ void compose_out(const T* ei, const T* ej, Work<T, R, kFull>& w, T* out, int i,
                            unsigned mask) {
  using O = Rn<T>;
  using P = Pack<R>;
  constexpr int G = group_lanes(R), F = R + R * R;
  constexpr int oB = kFull ? P::B : 0, oC = kFull ? P::C : R;
  #pragma unroll 1
  for (int e = i; e < F; e += G) middle_entry<T, R, kFull>(ei, ej, w, e);
  __syncwarp(mask);
  constexpr int count = kFull ? 2 * F + R * R : F;
  #pragma unroll 1
  for (int e = i; e < count; e += G) {
    if (e < R) {
      T acc = O::mul(w.x[0][e], w.t1[0]);
      for (int k = 1; k < R; ++k) acc = O::add(acc, O::mul(w.x[k][e], w.t1[k]));
      out[oB + e] = O::add(acc, ej[P::B + e]);
    } else if (e < F) {
      const int a = (e - R) / R, j = (e - R) % R;
      T c = O::mul(w.t2[a][0], ej[P::A + j * R]);
      for (int l = 1; l < R; ++l) c = O::add(c, O::mul(w.t2[a][l], ej[P::A + j * R + l]));
      out[oC + a * R + j] = O::add(c, ej[P::C + a * R + j]);
    } else if constexpr (kFull) {
      compose_full_entry<T, R>(ei, w, out, e - F);
    }
  }
  __syncwarp(mask);
}

// The adjoint of ei o ej (ops/kalman.py::_combine_vjp) on a group, from
// the result's cotangent dout (kFull a packed 5-tuple, else (b, C) at
// dout[0 .. R) and dout[R ..)), through the factorization in w: dei (kFull
// packed, else its b and C at dei[0 .. R) and dei[R ..)) and dej (packed).
// dei and dej overlap neither the operands, dout nor w. Ends with the
// group in step.
template <typename T, int R, bool kFull>
__device__ void compose_vjp(const T* ei, const T* ej, Work<T, R, kFull>& w, const T* dout,
                            T* dei, T* dej, int i, unsigned mask) {
  using O = Rn<T>;
  using P = Pack<R>;
  constexpr int G = group_lanes(R), W = Work<T, R, kFull>::W, F = R + R * R, S = P::S;
  const T* dbn = dout + (kFull ? P::B : 0);
  const T* dcn = dout + (kFull ? P::C : R);
  // t1, T2; dT2 = dCn Aj; dt1 = m1t^T dbn
  #pragma unroll 1
  for (int e = i; e < 2 * F; e += G) {
    if (e < F) {
      middle_entry<T, R, kFull>(ei, ej, w, e);
    } else if (e < F + R * R) {
      const int a = (e - F) / R, l = (e - F) % R;
      T acc = O::mul(dcn[a * R], ej[P::A + l]);
      for (int j = 1; j < R; ++j) acc = O::add(acc, O::mul(dcn[a * R + j], ej[P::A + j * R + l]));
      w.dt2[a][l] = acc;
    } else {
      const int k = e - F - R * R;
      T acc = O::mul(w.x[k][0], dbn[0]);
      for (int a = 1; a < R; ++a) acc = O::add(acc, O::mul(w.x[k][a], dbn[a]));
      w.dt1[k] = acc;
    }
  }
  __syncwarp(mask);
  // dX = [dm1t^T | dm2 | dm3] into z
  #pragma unroll 1
  for (int e = i; e < R * W; e += G) {
    const int b = e / W, c = e % W;
    if (c < R) {
      const int a = c;
      T acc = O::mul(dbn[a], w.t1[b]);
      if constexpr (kFull) {
        T mm = O::mul(dout[P::A + a * R], ei[P::A + b * R]);
        for (int k = 1; k < R; ++k) mm = O::add(mm, O::mul(dout[P::A + a * R + k], ei[P::A + b * R + k]));
        acc = O::add(mm, acc);
      }
      T cc = O::mul(w.dt2[a][0], ei[P::C + b * R]);
      for (int l = 1; l < R; ++l) cc = O::add(cc, O::mul(w.dt2[a][l], ei[P::C + b * R + l]));
      w.z[b][a] = O::add(acc, cc);
    } else if constexpr (kFull) {
      if (c == R) {
        T acc = O::mul(ei[P::A + b * R], dout[P::ETA]);
        for (int k = 1; k < R; ++k) acc = O::add(acc, O::mul(ei[P::A + b * R + k], dout[P::ETA + k]));
        w.z[b][R] = acc;
      } else {
        const int cc = c - R - 1;
        T m3 = O::mul(ei[P::A + b * R], dout[P::J + cc]);
        for (int k = 1; k < R; ++k) m3 = O::add(m3, O::mul(ei[P::A + b * R + k], dout[P::J + k * R + cc]));
        w.z[b][c] = m3;
      }
    }
  }
  __syncwarp(mask);
  // M^-T dX, a column a lane: U^T forward substitution, then each step's
  // multipliers transposed and its row swap undone, the last step first
  #pragma unroll 1
  for (int c = i; c < W; c += G) {
    #pragma unroll 1
    for (int r = 0; r < R; ++r) {
      T acc = w.z[r][c];
      #pragma unroll 1
      for (int j = 0; j < r; ++j) acc = O::sub(acc, O::mul(w.mb[j][r], w.z[j][c]));
      w.z[r][c] = Divisor<T>(w.mb[r][r]).quot(acc);
    }
    #pragma unroll 1
    for (int col = R - 2; col >= 0; --col) {
      const int p = w.piv[col];
      T acc = w.z[col][c];
      #pragma unroll 1
      for (int r = col + 1; r < R; ++r) acc = O::sub(acc, O::mul(w.f[r][col], w.z[r][c]));
      if (p != col) {
        w.z[col][c] = w.z[p][c];
        w.z[p][c] = acc;
      } else {
        w.z[col][c] = acc;
      }
    }
  }
  __syncwarp(mask);
  // dM = -(Z X^T)
  #pragma unroll 1
  for (int e = i; e < R * R; e += G) {
    const int a = e / R, b = e % R;
    T acc = O::mul(w.z[a][0], w.x[b][0]);
    for (int c = 1; c < W; ++c) acc = O::add(acc, O::mul(w.z[a][c], w.x[b][c]));
    w.dm[a][b] = -acc;
  }
  __syncwarp(mask);
  // dei at its packed offsets (kFull) or (b, C); then dej
  constexpr int ND = kFull ? S : F;
  #pragma unroll 1
  for (int e = i; e < ND + S; e += G) {
    if (e < ND) {
      const int o = kFull ? e : e + P::B;  // the packed offset
      T v = T(0);
      if (o < P::B) {
        if constexpr (kFull) {
          const int k = o / R, b = o % R;
          T acc = O::mul(w.x[k][0], dout[P::A + b]);
          for (int a = 1; a < R; ++a) acc = O::add(acc, O::mul(w.x[k][a], dout[P::A + a * R + b]));
          acc = O::add(acc, O::mul(w.x[k][R], dout[P::ETA + b]));
          T m3 = O::mul(w.x[k][R + 1], dout[P::J + b * R]);
          for (int c = 1; c < R; ++c) m3 = O::add(m3, O::mul(w.x[k][R + 1 + c], dout[P::J + b * R + c]));
          acc = O::add(acc, m3);
          T jg = O::mul(ej[P::J + k], w.z[0][R + 1 + b]);
          for (int r = 1; r < R; ++r) jg = O::add(jg, O::mul(ej[P::J + r * R + k], w.z[r][R + 1 + b]));
          v = O::add(acc, jg);
        }
      } else if (o < P::C) {
        const int l = o - P::B;
        v = w.dt1[l];
        if constexpr (kFull) {
          T jv = O::mul(ej[P::J + l], w.z[0][R]);
          for (int r = 1; r < R; ++r) jv = O::add(jv, O::mul(ej[P::J + r * R + l], w.z[r][R]));
          v = O::sub(v, jv);
        }
      } else if (o < P::ETA) {
        const int l = (o - P::C) / R, c = (o - P::C) % R;
        T acc = O::mul(w.dt1[l], ej[P::ETA + c]);
        T m = O::mul(w.x[l][0], w.dt2[0][c]);
        for (int k = 1; k < R; ++k) m = O::add(m, O::mul(w.x[l][k], w.dt2[k][c]));
        acc = O::add(acc, m);
        T jm = O::mul(ej[P::J + l], w.dm[0][c]);
        for (int r = 1; r < R; ++r) jm = O::add(jm, O::mul(ej[P::J + r * R + l], w.dm[r][c]));
        v = O::add(acc, jm);
      } else {
        v = dout[o];  // eta and J pass through
      }
      dei[e] = v;
    } else {
      const int o = e - ND;
      T v;
      if (o < P::B) {
        const int j = o / R, l = o % R;
        T acc = O::mul(dcn[j], w.t2[0][l]);
        for (int a = 1; a < R; ++a) acc = O::add(acc, O::mul(dcn[a * R + j], w.t2[a][l]));
        v = O::add(acc, w.z[l][j]);
      } else if (o < P::C) {
        v = dbn[o - P::B];
      } else if (o < P::ETA) {
        v = dcn[o - P::C];
      } else if (o < P::J) {
        const int j = o - P::ETA;
        T et = O::mul(ei[P::C + j], w.dt1[0]);
        for (int r = 1; r < R; ++r) et = O::add(et, O::mul(ei[P::C + r * R + j], w.dt1[r]));
        if constexpr (kFull) et = O::add(et, w.z[j][R]);
        v = et;
      } else {
        const int j = (o - P::J) / R, l = (o - P::J) % R;
        T acc = O::mul(w.dm[j][0], ei[P::C + l * R]);
        for (int c = 1; c < R; ++c) acc = O::add(acc, O::mul(w.dm[j][c], ei[P::C + l * R + c]));
        if constexpr (kFull) {
          acc = O::sub(acc, O::mul(w.z[j][R], ei[P::B + l]));
          T g = O::mul(w.z[j][R + 1], ei[P::A + l * R]);
          for (int c = 1; c < R; ++c) g = O::add(g, O::mul(w.z[j][R + 1 + c], ei[P::A + l * R + c]));
          acc = O::add(acc, g);
        }
        v = acc;
      }
      dej[o] = v;
    }
  }
  __syncwarp(mask);
}

// a group's place in a one-warp block of 32 / G groups
template <int R>
struct Lanes {
  static constexpr int G = group_lanes(R), NG = kWarp / G;
  int g, i, base;
  unsigned mask;
  __device__ Lanes()
      : g(threadIdx.x / G), i(threadIdx.x % G), base(threadIdx.x - threadIdx.x % G),
        mask(group_mask(G, threadIdx.x - threadIdx.x % G)) {}
  __device__ long long item() const { return static_cast<long long>(blockIdx.x) * NG + g; }
};

// each kernel's slot of a group in dynamic shared memory
template <typename T, int R>
struct LevelsSlot {
  Work<T, R, true> w;
};
template <typename T, int R>
struct StitchSlot {
  Work<T, R, false> w;
  T f[R + R * R], g[R + R * R], tt[R][R], dtt[R][R];
};
template <typename T, int R>
struct TreeSlot {
  Work<T, R, true> w;
  T acc[Pack<R>::S], di[Pack<R>::S], dj[Pack<R>::S];
};
template <typename T, int R>
struct WalkSlot {
  Work<T, R, true> w;
  T run[Pack<R>::S], prev[Pack<R>::S], el[Pack<R>::S], pv[Pack<R>::S];
};
template <typename T, int R>
struct ElementSlot {
  T qh[R], kk[R], ha[R], im[R][R], dk[R], dha[R], dqh[R];
};

template <typename Slot>
__device__ __forceinline__ Slot& slot(int g) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  return reinterpret_cast<Slot*>(k2_smem)[g];
}

// Level d of the scan again: item x of row `row` of [B, leaves] becomes
// in[x - h] o in[x] for x >= h, else in[x]; `in` null copies the leaves
// (carry_in when given, then each block's last prefix).
template <typename T, int R>
__global__ void __launch_bounds__(kWarp)
k2_levels_kernel(const T* __restrict__ carry_in, const T* __restrict__ prefixes, int b, int n,
                 int length, int leaves, int h, const T* __restrict__ in, T* __restrict__ out) {
  constexpr int S = Pack<R>::S, G = group_lanes(R);
  const Lanes<R> ln;
  const long long it = ln.item();
  if (it >= static_cast<long long>(b) * leaves) return;
  const int row = static_cast<int>(it / leaves), x = static_cast<int>(it % leaves);
  T* dst = out + it * S;
  const T* src = nullptr;
  if (!in) {
    if (carry_in && x == 0) {
      src = carry_in + static_cast<long long>(row) * S;
    } else {
      const long long end = static_cast<long long>(x + 1 - (carry_in ? 1 : 0)) * length;
      src = prefixes + (static_cast<long long>(row) * n + (end < n ? end : n) - 1) * S;
    }
  } else if (x < h) {
    src = in + it * S;
  }
  if (src) {
    #pragma unroll 1
    for (int e = ln.i; e < S; e += G) dst[e] = src[e];
    return;
  }
  const T* ej = in + it * S;
  const T* ei = ej - static_cast<long long>(h) * S;
  auto& sl = slot<LevelsSlot<T, R>>(ln.g);
  factor<T, R, true>(ei, ej, sl.w, ln.i, ln.mask);
  compose_out<T, R, true>(ei, ej, sl.w, dst, ln.i, ln.mask);
}

// The innovations' and the stitch's adjoint at position p of the flattened
// [B N] axis (ops/kalman.py::_innovation_vjp, then _combine_vjp partial).
template <typename T, int R>
__global__ void __launch_bounds__(kWarp)
k2_stitch_kernel(const T* __restrict__ A, const T* __restrict__ Q, const T* __restrict__ H,
                 const T* __restrict__ carry_in, const T* __restrict__ prefixes,
                 const T* __restrict__ final_level, const T* __restrict__ dmu,
                 const T* __restrict__ ds, int b, int n, int length, int leaves,
                 T* __restrict__ dA, T* __restrict__ dQ, T* __restrict__ ddiag,
                 T* __restrict__ dpre, T* __restrict__ share) {
  using O = Rn<T>;
  using P = Pack<R>;
  constexpr int S = P::S, F = R + R * R, G = group_lanes(R);
  const Lanes<R> ln;
  const int i = ln.i;
  const long long it = ln.item();
  if (it >= static_cast<long long>(b) * n) return;
  const int row = static_cast<int>(it / n), pp = static_cast<int>(it % n);
  auto& sl = slot<StitchSlot<T, R>>(ln.g);
  // the filtered (b, C) at p - 1, as K1's stage 3 forms it
  int j = -1;
  const T* prefix = prefixes + (it - 1) * S;
  const T* excl = nullptr;
  if (pp == 0) {
    const T* c = carry_in ? carry_in + static_cast<long long>(row) * S : nullptr;
    #pragma unroll 1
    for (int e = i; e < F; e += G) sl.f[e] = c ? c[P::B + e] : T(0);
  } else {
    j = (pp - 1) / length - (carry_in ? 0 : 1);
    if (j < 0) {
      #pragma unroll 1
      for (int e = i; e < F; e += G) sl.f[e] = prefix[P::B + e];
    } else {
      excl = final_level + (static_cast<long long>(row) * leaves + j) * S;
      factor<T, R, false>(excl, prefix, sl.w, i, ln.mask);
      compose_out<T, R, false>(excl, prefix, sl.w, sl.f, i, ln.mask);
    }
  }
  __syncwarp(ln.mask);
  const T* a = A + it * R * R;
  const T* f = sl.f;
  const T dm = dmu[it], dsv = ds[it];
  // T = A C and dT = (dph H^T) A, dph = H ds, dmi = H dmu
  #pragma unroll 1
  for (int e = i; e < R * R; e += G) {
    const int r = e / R, l = e % R;
    T acc = O::mul(a[r * R], f[R + l]);
    for (int k = 1; k < R; ++k) acc = O::add(acc, O::mul(a[r * R + k], f[R + k * R + l]));
    sl.tt[r][l] = acc;
    const T dph = O::mul(H[r], dsv);
    T d2 = O::mul(O::mul(dph, H[0]), a[l]);
    for (int jj = 1; jj < R; ++jj) d2 = O::add(d2, O::mul(O::mul(dph, H[jj]), a[jj * R + l]));
    sl.dtt[r][l] = d2;
  }
  __syncwarp(ln.mask);
  // the filtered (b, C)'s cotangent g, then dA and dQ
  #pragma unroll 1
  for (int e = i; e < F + R * R; e += G) {
    if (e < R) {
      T acc = O::mul(a[e], O::mul(H[0], dm));
      for (int r = 1; r < R; ++r) acc = O::add(acc, O::mul(a[r * R + e], O::mul(H[r], dm)));
      sl.g[e] = acc;
    } else if (e < F) {
      const int k = (e - R) / R, l = (e - R) % R;
      T c = O::mul(a[k], sl.dtt[0][l]);
      for (int r = 1; r < R; ++r) c = O::add(c, O::mul(a[r * R + k], sl.dtt[r][l]));
      sl.g[e] = c;
    } else {
      const int r = (e - F) / R, k = (e - F) % R;
      T acc = O::mul(O::mul(H[r], dm), f[k]);
      T pt = O::mul(O::mul(O::mul(H[0], dsv), H[r]), sl.tt[0][k]);
      for (int q = 1; q < R; ++q) pt = O::add(pt, O::mul(O::mul(O::mul(H[q], dsv), H[r]), sl.tt[q][k]));
      acc = O::add(acc, pt);
      T tc = O::mul(sl.dtt[r][0], f[R + k * R]);
      for (int l = 1; l < R; ++l) tc = O::add(tc, O::mul(sl.dtt[r][l], f[R + k * R + l]));
      dA[it * R * R + r * R + k] = O::add(acc, tc);
      dQ[it * R * R + r * R + k] = O::mul(O::mul(H[r], dsv), H[k]);
    }
  }
  if (i == 0) ddiag[it] = dsv;
  __syncwarp(ln.mask);
  if (pp == 0) {
    if (carry_in)
      #pragma unroll 1
      for (int e = i; e < F; e += G) share[it * F + e] = sl.g[e];
  } else if (j < 0) {
    T* d = dpre + (it - 1) * S;
    #pragma unroll 1
    for (int e = i; e < S; e += G) d[e] = e >= P::B && e < P::ETA ? sl.g[e - P::B] : T(0);
  } else {
    compose_vjp<T, R, false>(excl, prefix, sl.w, sl.g, share + it * F, dpre + (it - 1) * S, i,
                             ln.mask);
  }
}

// A leaf's value e: the shares of the positions [start, end) that compose
// it (its b and C), summed in ascending position from zero, plus on the
// last leaf the outgoing carry's cotangent; with no level above, the
// incoming carry's cotangent is leaf 0.
template <typename T, int R>
__global__ void __launch_bounds__(kAdjThreads)
k2_leaf_kernel(const T* __restrict__ share, const T* __restrict__ dcarry_out, int b, int n,
               int length, int leaves, int carried, T* __restrict__ out,
               T* __restrict__ dcarry_in) {
  using O = Rn<T>;
  using P = Pack<R>;
  constexpr int S = P::S, F = R + R * R;
  const long long it = static_cast<long long>(blockIdx.x) * kAdjThreads + threadIdx.x;
  if (it >= static_cast<long long>(b) * leaves * S) return;
  const int e = static_cast<int>(it % S);
  const long long item = it / S;
  const int row = static_cast<int>(item / leaves), x = static_cast<int>(item % leaves);
  T acc = T(0);
  if (e >= P::B && e < P::ETA) {
    long long start, end;
    if (carried) {
      start = x == 0 ? 0 : static_cast<long long>(x) * length + 1;
      end = static_cast<long long>(x + 1) * length + 1;
    } else {
      start = static_cast<long long>(x + 1) * length + 1;
      end = static_cast<long long>(x + 2) * length + 1;
    }
    if (end > n) end = n;
    for (long long p = start; p < end; ++p)
      acc = O::add(acc, share[(static_cast<long long>(row) * n + p) * F + e - P::B]);
  }
  if (dcarry_out && x == leaves - 1) acc = O::add(acc, dcarry_out[static_cast<long long>(row) * S + e]);
  out[it] = acc;
  if (dcarry_in && x == 0) dcarry_in[static_cast<long long>(row) * S + e] = acc;
}

// Level d of the scan in reverse, a group a leaf i of [B, leaves]: its own
// share, then the earlier operand's of the pair (i, i + h).
template <typename T, int R>
__global__ void __launch_bounds__(kWarp)
k2_tree_kernel(const T* __restrict__ level, const T* __restrict__ dnext, int b, int leaves,
               int h, T* __restrict__ dcur, T* __restrict__ dcarry_in) {
  using O = Rn<T>;
  constexpr int S = Pack<R>::S, G = group_lanes(R);
  const Lanes<R> ln;
  const int i = ln.i;
  const long long it = ln.item();
  if (it >= static_cast<long long>(b) * leaves) return;
  const int x = static_cast<int>(it % leaves);
  auto& sl = slot<TreeSlot<T, R>>(ln.g);
  const T* xi = level + it * S;
  if (x >= h) {
    const T* xl = xi - static_cast<long long>(h) * S;
    factor<T, R, true>(xl, xi, sl.w, i, ln.mask);
    compose_vjp<T, R, true>(xl, xi, sl.w, dnext + it * S, sl.di, sl.acc, i, ln.mask);
  } else {
    #pragma unroll 1
    for (int e = i; e < S; e += G) sl.acc[e] = dnext[it * S + e];
    __syncwarp(ln.mask);
  }
  if (x + h < leaves) {
    const T* xr = xi + static_cast<long long>(h) * S;
    factor<T, R, true>(xi, xr, sl.w, i, ln.mask);
    compose_vjp<T, R, true>(xi, xr, sl.w, dnext + (it + h) * S, sl.di, sl.dj, i, ln.mask);
    #pragma unroll 1
    for (int e = i; e < S; e += G) sl.acc[e] = O::add(sl.acc[e], sl.di[e]);
  }
  #pragma unroll 1
  for (int e = i; e < S; e += G) {
    dcur[it * S + e] = sl.acc[e];
    if (dcarry_in && x == 0) dcarry_in[(it / leaves) * S + e] = sl.acc[e];
  }
}

// Block `blk` of row `row` walked backwards from its summary's cotangent
// (dleaf, leaf blk + carried) by a group: at step l the prefix's cotangent
// (what step l + 1 handed back, plus dpre[l] where a position follows),
// the element e_l formed again (K1's stage-0 element, the same bits) and
// prefix(l - 1) o e_l reversed; e_l's cotangent overwrites dpre[l], which
// nothing reads again.
template <typename T, int R>
__global__ void __launch_bounds__(kWarp)
k2_walk_kernel(const T* __restrict__ A, const T* __restrict__ Q, const T* __restrict__ H,
               const T* __restrict__ diag, const T* __restrict__ y,
               const T* __restrict__ prefixes, const T* __restrict__ dleaf, int b, int n,
               int length, int m, int carried, T* __restrict__ dpre) {
  using O = Rn<T>;
  constexpr int S = Pack<R>::S, G = group_lanes(R), RR = R * R;
  const Lanes<R> ln;
  const int i = ln.i;
  const long long ch = ln.item();
  if (ch >= static_cast<long long>(b) * m) return;
  const int row = static_cast<int>(ch / m), blk = static_cast<int>(ch % m);
  const int first = blk * length;
  const int cnt = n - first < length ? n - first : length;
  const int leaves = m + carried;
  auto& sl = slot<WalkSlot<T, R>>(ln.g);
  T* run = sl.run;
  T* prev = sl.prev;
  #pragma unroll 1
  for (int e = i; e < S; e += G)
    run[e] = dleaf[(static_cast<long long>(row) * leaves + blk + carried) * S + e];
  #pragma unroll 1
  for (int l = cnt - 1; l >= 0; --l) {
    const long long q = static_cast<long long>(row) * n + first + l;
    T* dq = dpre + q * S;
    const bool follows = first + l + 1 < n;
    #pragma unroll 1
    for (int e = i; e < S; e += G) {
      if (follows) run[e] = O::add(run[e], dq[e]);
      sl.pv[e] = l > 0 ? prefixes[(q - 1) * S + e] : identity_at<T, R>(e);
    }
    element<T, R>(A + q * RR, Q + q * RR, H, diag[q], y[q], sl.el, i, ln.base, ln.mask, true);
    __syncwarp(ln.mask);
    factor<T, R, true>(sl.pv, sl.el, sl.w, i, ln.mask);
    compose_vjp<T, R, true>(sl.pv, sl.el, sl.w, run, prev, dq, i, ln.mask);
    T* t = run;
    run = prev;
    prev = t;
  }
}

// The element's adjoint at a position (ops/kalman.py::_elements_vjp), a
// group a position, from its cotangent de, added to the innovations' dA,
// dQ and ddiag.
template <typename T, int R>
__global__ void __launch_bounds__(kWarp)
k2_element_kernel(const T* __restrict__ A, const T* __restrict__ Q, const T* __restrict__ H,
                  const T* __restrict__ diag, const T* __restrict__ y, const T* __restrict__ de,
                  long long total, T* __restrict__ dA, T* __restrict__ dQ,
                  T* __restrict__ ddiag, T* __restrict__ dy) {
  using O = Rn<T>;
  using P = Pack<R>;
  constexpr int S = P::S, G = group_lanes(R);
  const Lanes<R> ln;
  const int i = ln.i;
  const long long it = ln.item();
  if (it >= total) return;
  auto& sl = slot<ElementSlot<T, R>>(ln.g);
  const T* a = A + it * R * R;
  const T* q = Q + it * R * R;
  const T* g = de + it * S;
  const T yv = y[it];
  #pragma unroll 1
  for (int e = i; e < 2 * R; e += G) {
    if (e < R) {
      T acc = O::mul(q[e * R], H[0]);
      for (int j = 1; j < R; ++j) acc = O::add(acc, O::mul(q[e * R + j], H[j]));
      sl.qh[e] = acc;
    } else {
      const int j = e - R;
      T acc = O::mul(a[j], H[0]);
      for (int k = 1; k < R; ++k) acc = O::add(acc, O::mul(a[k * R + j], H[k]));
      sl.ha[j] = acc;
    }
  }
  __syncwarp(ln.mask);
  T hqh = O::mul(H[0], sl.qh[0]);
  for (int k = 1; k < R; ++k) hqh = O::add(hqh, O::mul(H[k], sl.qh[k]));
  hqh = O::add(hqh, diag[it]);
  const Divisor<T> dh(hqh);
  const T ry = dh.quot(yv);
  #pragma unroll 1
  for (int e = i; e < R; e += G) sl.kk[e] = dh.quot(sl.qh[e]);
  __syncwarp(ln.mask);
  // I - K H; dK = dbe y - (dAe A^T + dCe Q^T) H; dHA
  #pragma unroll 1
  for (int e = i; e < R * R + 2 * R; e += G) {
    if (e < R * R) {
      const int r = e / R, j = e % R;
      sl.im[r][j] = O::sub(r == j ? T(1) : T(0), O::mul(sl.kk[r], H[j]));
    } else if (e < R * R + R) {
      const int r = e - R * R;
      T acc = O::mul(g[P::B + r], yv);
      T s2 = T(0);
      #pragma unroll 1
      for (int j = 0; j < R; ++j) {
        T x1 = O::mul(g[P::A + r * R], a[j * R]);
        for (int k = 1; k < R; ++k) x1 = O::add(x1, O::mul(g[P::A + r * R + k], a[j * R + k]));
        T x2 = O::mul(g[P::C + r * R], q[j * R]);
        for (int k = 1; k < R; ++k) x2 = O::add(x2, O::mul(g[P::C + r * R + k], q[j * R + k]));
        const T t = O::mul(O::add(x1, x2), H[j]);
        s2 = j == 0 ? t : O::add(s2, t);
      }
      sl.dk[r] = O::sub(acc, s2);
    } else {
      const int r = e - R * R - R;
      T acc = O::mul(g[P::ETA + r], ry);
      T w1 = O::mul(dh.quot(g[P::J + r * R]), sl.ha[0]);
      for (int j = 1; j < R; ++j) w1 = O::add(w1, O::mul(dh.quot(g[P::J + r * R + j]), sl.ha[j]));
      acc = O::add(acc, w1);
      T w2 = O::mul(dh.quot(g[P::J + r]), sl.ha[0]);
      for (int j = 1; j < R; ++j) w2 = O::add(w2, O::mul(dh.quot(g[P::J + j * R + r]), sl.ha[j]));
      sl.dha[r] = O::add(acc, w2);
    }
  }
  __syncwarp(ln.mask);
  // dy and d(HQH + d), every lane the same
  T dyv = O::mul(g[P::B], sl.kk[0]);
  for (int r = 1; r < R; ++r) dyv = O::add(dyv, O::mul(g[P::B + r], sl.kk[r]));
  T dry = O::mul(g[P::ETA], sl.ha[0]);
  for (int r = 1; r < R; ++r) dry = O::add(dry, O::mul(g[P::ETA + r], sl.ha[r]));
  dyv = O::add(dyv, dh.quot(dry));
  T acc = T(0);
  #pragma unroll 1
  for (int r = 0; r < R; ++r)
    #pragma unroll 1
    for (int j = 0; j < R; ++j) {
      const T t = O::mul(g[P::J + r * R + j], dh.quot(O::mul(sl.ha[r], sl.ha[j])));
      acc = r == 0 && j == 0 ? t : O::add(acc, t);
    }
  acc = O::add(acc, O::mul(dry, ry));
  T kd = O::mul(sl.dk[0], sl.kk[0]);
  for (int r = 1; r < R; ++r) kd = O::add(kd, O::mul(sl.dk[r], sl.kk[r]));
  acc = O::add(acc, kd);
  const T dhqh = -dh.quot(acc);
  #pragma unroll 1
  for (int e = i; e < R; e += G) sl.dqh[e] = O::add(dh.quot(sl.dk[e]), O::mul(H[e], dhqh));
  __syncwarp(ln.mask);
  #pragma unroll 1
  for (int e = i; e < R * R; e += G) {
    const int k = e / R, j = e % R;
    T x1 = O::mul(sl.im[0][k], g[P::A + j]);
    T x2 = O::mul(sl.im[0][k], g[P::C + j]);
    for (int r = 1; r < R; ++r) {
      x1 = O::add(x1, O::mul(sl.im[r][k], g[P::A + r * R + j]));
      x2 = O::add(x2, O::mul(sl.im[r][k], g[P::C + r * R + j]));
    }
    const long long o = it * R * R + e;
    dA[o] = O::add(dA[o], O::add(x1, O::mul(H[k], sl.dha[j])));
    dQ[o] = O::add(dQ[o], O::add(x2, O::mul(sl.dqh[k], H[j])));
  }
  if (i == 0) {
    ddiag[it] = O::add(ddiag[it], dhqh);
    dy[it] = dyv;
  }
}

// a group kernel's dynamic shared memory: its slot times the groups a block
template <typename Slot, int R>
constexpr int slot_bytes() {
  return static_cast<int>(sizeof(Slot)) * (kWarp / group_lanes(R));
}

}  // namespace

namespace kalman_k {

// K2's launches at one width R. kalman_adjoint.cu instantiates R <= 8 and
// declares the wider ones extern; PERIODICITY_KALMAN_ADJOINT_WIDTH(R)
// instantiates one in K1's unit of that width.
template <typename T, int R>
struct Adjoint {
  static cudaError_t launch(const T* A, const T* Q, const T* H, const T* diag, const T* y,
                            const T* carry_in, const T* prefixes, const T* dmu, const T* ds,
                            const T* dcarry_out, int b, int n, int nb, T* levels, T* dtree,
                            T* dpre, T* share, T* dA, T* dQ, T* ddiag, T* dy, T* dcarry_in,
                            cudaStream_t stream);
  // out = {lanes a group, groups a block (one warp), blocks over the
  // positions, over the leaves, the leaf kernel's over the leaves' values,
  // over the chains, L, m, leaves, levels, launches}
  static void geometry(int b, int n, int nb, int carry, int* out);
  // {local memory bytes a thread, registers a thread, shared bytes a block
  // (static and dynamic)} of the levels, stitch, leaf, tree, walk and
  // element kernels in turn
  static cudaError_t attributes(int* out);
};

template <typename T, int R>
cudaError_t Adjoint<T, R>::launch(const T* A, const T* Q, const T* H, const T* diag,
                                  const T* y, const T* carry_in, const T* prefixes,
                                  const T* dmu, const T* ds, const T* dcarry_out, int b, int n,
                                  int nb, T* levels, T* dtree, T* dpre, T* share, T* dA, T* dQ,
                                  T* ddiag, T* dy, T* dcarry_in, cudaStream_t stream) {
  constexpr int S = Pack<R>::S, NG = kWarp / group_lanes(R);
  constexpr int kLevels = slot_bytes<LevelsSlot<T, R>, R>(),
                kStitch = slot_bytes<StitchSlot<T, R>, R>(),
                kTree = slot_bytes<TreeSlot<T, R>, R>(), kWalk = slot_bytes<WalkSlot<T, R>, R>(),
                kElement = slot_bytes<ElementSlot<T, R>, R>();
  cudaError_t err;
  if constexpr (kLevels > 48 * 1024 || kStitch > 48 * 1024 || kTree > 48 * 1024 ||
                kWalk > 48 * 1024) {
    // the group kernels' shared-memory limit, raised once a device
    static std::atomic<unsigned long long> raised{0};
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev % 64);
    if (!(raised.load() & bit)) {
      const void* fns[4] = {reinterpret_cast<const void*>(&k2_levels_kernel<T, R>),
                            reinterpret_cast<const void*>(&k2_stitch_kernel<T, R>),
                            reinterpret_cast<const void*>(&k2_tree_kernel<T, R>),
                            reinterpret_cast<const void*>(&k2_walk_kernel<T, R>)};
      const int bytes[4] = {kLevels, kStitch, kTree, kWalk};
      for (int k = 0; k < 4; ++k)
        if ((err = cudaFuncSetAttribute(fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        bytes[k])) != cudaSuccess)
          return err;
      raised.fetch_or(bit);
    }
  }
  int length, m;
  geometry_of(n, nb, &length, &m);
  const int carried = carry_in ? 1 : 0;
  const int leaves = m + carried;
  const int depth = tree_levels(leaves);
  const long long total = static_cast<long long>(b) * n;
  const long long level_size = static_cast<long long>(b) * leaves * S;
  const int leaf_grid = grid_of(static_cast<long long>(b) * leaves, NG);
  for (int d = 0; d <= depth; ++d) {
    k2_levels_kernel<T, R><<<leaf_grid, kWarp, kLevels, stream>>>(
        carry_in, prefixes, b, n, length, leaves, d > 0 ? 1 << (d - 1) : 0,
        d > 0 ? levels + (d - 1) * level_size : nullptr, levels + d * level_size);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  k2_stitch_kernel<T, R><<<grid_of(total, NG), kWarp, kStitch, stream>>>(
      A, Q, H, carry_in, prefixes, levels + depth * level_size, dmu, ds, b, n, length, leaves,
      dA, dQ, ddiag, dpre, share);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k2_leaf_kernel<T, R><<<grid_of(level_size, kAdjThreads), kAdjThreads, 0, stream>>>(
      share, dcarry_out, b, n, length, leaves, carried, dtree, depth == 0 ? dcarry_in : nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int d = depth - 1; d >= 0; --d) {
    const int k = depth - 1 - d;
    k2_tree_kernel<T, R><<<leaf_grid, kWarp, kTree, stream>>>(
        levels + d * level_size, dtree + (k & 1) * level_size, b, leaves, 1 << d,
        dtree + ((k + 1) & 1) * level_size, d == 0 ? dcarry_in : nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  k2_walk_kernel<T, R><<<grid_of(static_cast<long long>(b) * m, NG), kWarp, kWalk, stream>>>(
      A, Q, H, diag, y, prefixes, dtree + (depth & 1) * level_size, b, n, length, m, carried,
      dpre);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k2_element_kernel<T, R><<<grid_of(total, NG), kWarp, kElement, stream>>>(
      A, Q, H, diag, y, dpre, total, dA, dQ, ddiag, dy);
  return cudaGetLastError();
}

template <typename T, int R>
void Adjoint<T, R>::geometry(int b, int n, int nb, int carry, int* out) {
  constexpr int NG = kWarp / group_lanes(R);
  int length, m;
  geometry_of(n, nb, &length, &m);
  const int leaves = m + (carry ? 1 : 0);
  const int depth = tree_levels(leaves);
  out[0] = group_lanes(R);
  out[1] = NG;
  out[2] = grid_of(static_cast<long long>(b) * n, NG);
  out[3] = grid_of(static_cast<long long>(b) * leaves, NG);
  out[4] = grid_of(static_cast<long long>(b) * leaves * Pack<R>::S, kAdjThreads);
  out[5] = grid_of(static_cast<long long>(b) * m, NG);
  out[6] = length;
  out[7] = m;
  out[8] = leaves;
  out[9] = depth;
  out[10] = 2 * depth + 5;
}

template <typename T, int R>
cudaError_t Adjoint<T, R>::attributes(int* out) {
  const void* fns[6] = {reinterpret_cast<const void*>(&k2_levels_kernel<T, R>),
                        reinterpret_cast<const void*>(&k2_stitch_kernel<T, R>),
                        reinterpret_cast<const void*>(&k2_leaf_kernel<T, R>),
                        reinterpret_cast<const void*>(&k2_tree_kernel<T, R>),
                        reinterpret_cast<const void*>(&k2_walk_kernel<T, R>),
                        reinterpret_cast<const void*>(&k2_element_kernel<T, R>)};
  const int dynamic[6] = {slot_bytes<LevelsSlot<T, R>, R>(), slot_bytes<StitchSlot<T, R>, R>(),
                          0, slot_bytes<TreeSlot<T, R>, R>(), slot_bytes<WalkSlot<T, R>, R>(),
                          slot_bytes<ElementSlot<T, R>, R>()};
  for (int k = 0; k < 6; ++k) {
    cudaFuncAttributes a{};
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[k]);
    if (err != cudaSuccess) return err;
    out[3 * k] = static_cast<int>(a.localSizeBytes);
    out[3 * k + 1] = a.numRegs;
    out[3 * k + 2] = static_cast<int>(a.sharedSizeBytes) + dynamic[k];
  }
  return cudaSuccess;
}

}  // namespace kalman_k

#define PERIODICITY_KALMAN_ADJOINT_WIDTH(RR)     \
  template struct kalman_k::Adjoint<float, RR>; \
  template struct kalman_k::Adjoint<double, RR>;
#define PERIODICITY_KALMAN_ADJOINT_EXTERN(RR)           \
  extern template struct kalman_k::Adjoint<float, RR>; \
  extern template struct kalman_k::Adjoint<double, RR>;
