// K1: the blocked Kalman composition of the celerite GP likelihood, for
// Hopper (sm_90a), at R = 1 to 16 states. kalman.cu holds the plain C
// interface, loaded with ctypes by periodicity_tpu_torch/ops/_kernels.py,
// and the widths R <= 8; each wider width has a translation unit of its own
// (kalman_r*.cu), which nvcc builds in parallel with the others. The
// wrapper and the plain version are in periodicity_tpu_torch/ops/kalman.py.
//
// It has no Pallas kernel in the JAX package: it replaces the lax.scan of
// _combine inside periodicity_tpu/models/gp/pscan.py::_pkf_loglik_blocked
// (:332-346, the two-level structure of _blocked_inclusive_prefixes at
// :279-329) and one chunk of _pkf_loglik_chunked (:349-407), which XLA runs
// as one dispatch a step. In eager PyTorch a step is ~150 launches (most of
// them the unrolled pivoted solve), ceil(N / n_blocks) steps a call.
//
// What it computes, per row (walker), with L = ceil(n / nb) positions a
// block, m = ceil(n / L) blocks that hold a position, and the 5-tuple
// filtering elements (A, b, C, eta, J) of Sarkka and Garcia-Fernandez built
// from (A_k, Q_k, H, diag_k, y_k), JAX's two-level structure:
//   stage 0  every position's element, a group of lanes a position,
//            written to elems [B, N, S], S = 3 R^2 + 2 R;
//   stage 1  a group of lanes a (row, block) walks its L elements from the
//            identity and overwrites each with its inclusive prefix;
//   stage 2  an inclusive scan over [carry_in (when given), S_0 .. S_{m-1}]
//            (S_k block k's last prefix) in ceil(log2) levels, a launch a
//            level: x[i] = x[i - 2^d] o x[i], the earlier on the left. It
//            gives each block's exclusive carry and the outgoing carry;
//   stage 3  a group of lanes a position p: the filtered (b, C) at p - 1 as
//            excl[block] o prefix(p - 1) (the prefix alone in block 0
//            without a carry; the carry's, or zeros, at p = 0), from the
//            solve's m1t columns alone, then the predicted mean and variance
//            mu_p = H.(A_p b), s_p = H (A_p C A_p^T + Q_p) H + diag_p.
//
// What bounds it on the card. A composition is a chain of ~13 R dependent
// operations (the R-deep product I + J C, the pivoted elimination and back
// substitution with their divisions, the products after them), and each
// depends on the one before through the 3 R^2 + 2 R values of the state: a
// call is L + ceil(log2(m + 1)) + 1 compositions deep, while it moves only
// 2 R^2 + 4 values a sample. At config 7's N = 1e5 (m = 390, L = 257) the
// chain is ~33 microseconds at one operation's latency and the bytes a few:
// the chain binds, and stage 1's L steps are nearly all of it.
//
// What the design does about it. A composition is spread over a group of
// G lanes, G the next power of two >= R (a group never straddles a warp),
// and reads its operands where they lie: shared memory in stages 1 and 2,
// device memory through L1 in stage 3. Lane i builds and writes row i of A,
// b, C, eta and column i of J. The solve of M X = [Aj^T | etaj - Jj bi |
// Jj Ai], M = I + Jj Ci, runs a column a lane: lane i holds column i of M,
// of Aj^T and of Jj Ai, every lane the column etaj - Jj bi. At each step of
// the elimination the pivot column comes from its lane by __shfl_sync, and
// every lane takes the same first maximal |value| in ascending row order
// (NaN as the plain version has it), swaps the same two rows of its
// columns at or right of the pivot by selects, forms the same multipliers
// and updates its own columns; the back substitution reads the eliminated M
// by __shfl_sync and solves the lane's columns: m1t's row i (for its rows of
// A, b and C), m2 (for eta) and m3's column i (for J's column i). Nothing
// of the chain waits on shared memory but the operands, one __syncwarp a
// step. Each divisor's reciprocal is formed once, off the chains of its
// quotients, and a float32 quotient takes no branch (Divisor). In stage 1
// one warp walks its chains while a second warp brings the next tile of
// elements into shared memory with cp.async and writes the last tile's
// prefixes out of it; the two meet at one barrier a tile. Stages 0 and 3
// are one item a group, all positions at once; stage 0's loads and stores
// are coalesced through shared tiles. Every loop over R unrolls (R is a
// template parameter), so no state lives in local memory up to R = 8;
// past it a composition's columns outgrow the registers and spill. Past R
// = 8 a lane group is 16 lanes, stage 1's tiles live in dynamic shared
// memory, and stages 0 and 2 take half the threads a block where their
// tiles would outgrow 48 KB of static shared memory.
//
// Every product, sum, difference and quotient is rounded on its own through
// rn.cuh (a float32 quotient through Divisor, which gives __fdiv_rn's
// bits), in the order of the plain version (every sum over its index in
// ascending order), so kernel and plain version agree bit for bit.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

#include "rn.cuh"

namespace {

constexpr int kMaxR = 16;
constexpr int kWarp = 32;
constexpr int kGroupThreads = 128;  // stages 0 and 3: a group of lanes an item
constexpr int kTreeThreads = 64;    // stage 2: a group of lanes an item, its operands staged
constexpr int kPrefixWarps = 2;     // stage 1: a warp walks, a warp stages
constexpr int kMaxTile = 16;        // stage 1: at most this many steps a tile
constexpr int kWideBytes = 96 * 1024;  // stage 1 past R = 8: its tiles' dynamic shared memory

using rn::Rn;

// lanes a group: the next power of two >= R
__host__ __device__ constexpr int group_lanes(int r) {
  return r <= 1 ? 1 : r <= 2 ? 2 : r <= 4 ? 4 : r <= 8 ? 8 : 16;
}

// offsets in a packed element: A, b, C, eta, J, each row-major
// (ops/kalman.py::pack_carry)
template <int R>
struct Pack {
  static constexpr int A = 0, B = R * R, C = R * R + R, ETA = 2 * R * R + R,
                       J = 2 * R * R + 2 * R, S = 3 * R * R + 2 * R;
};

// stages 0 and 2's threads a block: kGroupThreads and kTreeThreads, halved
// where a block's tiles would outgrow 48 KB of static shared memory (stage
// 0 in float64 at R >= 13, stage 2 in float64 at R = 16)
template <typename T, int R>
__host__ __device__ constexpr int element_threads() {
  return sizeof(T) * (kGroupThreads / group_lanes(R)) * (2 * R * R + Pack<R>::S) <= 48 * 1024
             ? kGroupThreads
             : kGroupThreads / 2;
}

template <typename T, int R>
__host__ __device__ constexpr int tree_threads() {
  return sizeof(T) * (kTreeThreads / group_lanes(R)) * 2 * Pack<R>::S <= 48 * 1024
             ? kTreeThreads
             : kTreeThreads / 2;
}

// stage 1's shared memory a block: tiles of TS elements a chain coming in
// and of their prefixes going out, two of each, and one identity record; TS
// as large as fits in 46 KB of static shared memory (past R = 8, kWideBytes
// of dynamic shared memory), at most kMaxTile
template <typename T, int R>
struct PrefixTile {
  static constexpr int G = group_lanes(R), CW = kWarp / G, S = Pack<R>::S;
  static constexpr bool kDynamic = R > 8;
  static constexpr int kFixed = S;
  static constexpr int kRoom =
      (kDynamic ? kWideBytes : 46 * 1024) / static_cast<int>(sizeof(T)) - kFixed;
  static constexpr int TS0 = (kRoom - 4 * CW) / (4 * CW * S);
  static constexpr int TS = TS0 < 1 ? 1 : TS0 > kMaxTile ? kMaxTile : TS0;
  static constexpr int kRec = TS * S + 1;  // a chain's tile, an odd count
  static constexpr int bytes = static_cast<int>(sizeof(T)) * (4 * CW * kRec + kFixed);
};

__host__ __device__ constexpr unsigned group_mask(int g, int base) {
  return g >= kWarp ? 0xffffffffu : ((1u << g) - 1u) << base;
}

__device__ __forceinline__ float mag(float x) { return fabsf(x); }
__device__ __forceinline__ double mag(double x) { return fabs(x); }

// a / d as Rn<T>::div rounds it, with a zero a kept off the division's slow
// path (a subroutine call that stalls the warp): 0 / d is a zero signed by a
// and d, which a * d gives for every finite nonzero d; an infinite, zero or
// NaN d takes the division
template <typename T>
__device__ __forceinline__ T div_rn(T a, T d) {
  return a == T(0) && isfinite(d) && d != T(0) ? Rn<T>::mul(a, d) : Rn<T>::div(a, d);
}

// The float32 reciprocal estimate (MUFU.RCP): exact at zero, infinite and
// NaN arguments. Where no card compiles this, the exact reciprocal.
__device__ __forceinline__ float rcp_estimate(float d) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
#else
  return 1.0f / d;
#endif
}

// A divisor d and what quot needs of it, formed once for all the
// quotients over d and off their chains.
//
// In float32 the quotient comes without a branch from float64 (rn::Wide),
// correctly rounded for every finite nonzero a and d. The other
// operands take a product that gives the division's own result: a * d for a
// finite nonzero d (a zero, infinite or NaN a), else a * rcp(d) (d zero,
// infinite or NaN). __fdiv_rn instead sends zero and tiny numerators to a
// subroutine that stalls the warp: at config 7's N = 1e4, 6% of the back
// substitution's numerators are zero and 4.5% below 2^-100, and a warp of 8
// chains meets one at most division sites. Float64 divides with div_rn.
template <typename T>
struct Divisor;

template <>
struct Divisor<float> {
  float d, rs;
  rn::Wide w;
  bool ok;
  __device__ __forceinline__ explicit Divisor(float v)
      : d(v), rs(rcp_estimate(v)), w(v), ok(isfinite(v) & (v != 0.0f)) {}
  __device__ __forceinline__ float quot(float a) const {
    const float q = w.quot(a);
    const float other = __fmul_rn(a, ok ? d : rs);
    return ok & isfinite(a) & (a != 0.0f) ? q : other;
  }
};

template <>
struct Divisor<double> {
  double d;
  __device__ __forceinline__ explicit Divisor(double v) : d(v) {}
  __device__ __forceinline__ double quot(double a) const { return div_rn(a, d); }
};

// one element (4 or 8 bytes) from device to shared memory with cp.async
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async copies 4 or 8 bytes here");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(sizeof(T))
               : "memory");
}

// until every copy this thread started has landed
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The element of one position (ops/kalman.py::_elements) on a group: a, q
// this position's A_k and Q_k (row-major), out its packed record. Lane i
// owns row i; qh and HA of the other rows come by __shfl_sync. Lanes past R
// repeat row R - 1 and write nothing; nothing is written unless `write`.
template <typename T, int R>
__device__ __forceinline__ void element(const T* a, const T* q, const T* __restrict__ H, T d,
                                        T y, T* out, int i, int base, unsigned mask,
                                        bool write) {
  using O = Rn<T>;
  using P = Pack<R>;
  const int ir = i < R ? i : R - 1;
  T h[R];
#pragma unroll
  for (int j = 0; j < R; ++j) h[j] = H[j];
  T qh = O::mul(q[ir * R], h[0]);
#pragma unroll
  for (int j = 1; j < R; ++j) qh = O::add(qh, O::mul(q[ir * R + j], h[j]));
  T hqh = O::mul(h[0], __shfl_sync(mask, qh, base));
#pragma unroll
  for (int k = 1; k < R; ++k) hqh = O::add(hqh, O::mul(h[k], __shfl_sync(mask, qh, base + k)));
  hqh = O::add(hqh, d);
  const Divisor<T> dh(hqh);
  const T kk = dh.quot(qh), ry = dh.quot(y);
  T imkh[R];
#pragma unroll
  for (int j = 0; j < R; ++j) imkh[j] = O::sub(ir == j ? T(1) : T(0), O::mul(kk, h[j]));
  T ha = O::mul(a[ir], h[0]);
#pragma unroll
  for (int k = 1; k < R; ++k) ha = O::add(ha, O::mul(a[k * R + ir], h[k]));
  write = write && i < R;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    T accA = O::mul(imkh[0], a[j]);
    T accC = O::mul(imkh[0], q[j]);
#pragma unroll
    for (int l = 1; l < R; ++l) {
      accA = O::add(accA, O::mul(imkh[l], a[l * R + j]));
      accC = O::add(accC, O::mul(imkh[l], q[l * R + j]));
    }
    const T jj = dh.quot(O::mul(ha, __shfl_sync(mask, ha, base + j)));
    if (write) {
      out[P::A + ir * R + j] = accA;
      out[P::C + ir * R + j] = accC;
      out[P::J + ir * R + j] = jj;
    }
  }
  if (write) {
    out[P::B + ir] = O::mul(kk, y);
    out[P::ETA + ir] = O::mul(ha, ry);
  }
}

// a[col] <-> a[p] for a runtime p > col, by selects (no indexed registers)
template <typename T, int R>
__device__ __forceinline__ void swap_rows(T (&a)[R], int col, int p) {
  const T c = a[col];
  T v = c;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (k > col && k == p) {
      v = a[k];
      a[k] = c;
    }
  }
  a[col] = v;
}

// The composition ei o ej (ei earlier) on a group: ops/kalman.py::_combine.
// ei, ej packed records anywhere; out the result's record (kFull) or,
// without kFull, its b at out[0 .. R) and C at out[R ..) from the solve's
// m1t columns alone. out overlaps neither ei nor ej, and the caller
// separates one call's reads of ei and ej from the next call's writes.
//
// The solve of M X = [Aj^T | etaj - Jj bi | Jj Ai], M = I + Jj Ci, runs a
// column a lane: lane i holds column i of M, of Aj^T and of Jj Ai, and
// every lane the column etaj - Jj bi. At each step of the elimination the
// pivot column comes from its lane by __shfl_sync, and every lane takes the
// same first maximal |value|, swaps the same two rows of its columns at or
// right of the pivot, forms the same multipliers and updates its own
// columns. The back substitution reads the eliminated M by __shfl_sync and
// solves the lane's own columns: m1t's row i (which its rows of A, b and C
// need), m2 (for eta) and m3's column i (whence J's column i). Lane i then
// writes its row i of A, b, C, eta and its column i of J, each group of
// outputs after all are done, unless `write` is false; lanes past R repeat
// lane R - 1 and write nothing.
template <typename T, int R, bool kFull>
__device__ __forceinline__ void compose(const T* ei, const T* ej, T* out, int i, int base,
                                        unsigned mask, bool write) {
  using O = Rn<T>;
  using P = Pack<R>;
  constexpr int oB = kFull ? P::B : 0, oC = kFull ? P::C : R;
  const int ir = i < R ? i : R - 1;
  write = write && i < R;

  // the lane's columns: mc of M, ac of Aj^T, vc = etaj - Jj bi, gc of Jj Ai
  T mc[R], ac[R], vc[R], gc[R];
  {
    T cc[R], ai[R], bb[R];
#pragma unroll
    for (int l = 0; l < R; ++l) {
      cc[l] = ei[P::C + l * R + ir];
      if constexpr (kFull) {
        ai[l] = ei[P::A + l * R + ir];
        bb[l] = ei[P::B + l];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T* jr = ej + P::J + r * R;
      T acc = O::mul(jr[0], cc[0]);
#pragma unroll
      for (int l = 1; l < R; ++l) acc = O::add(acc, O::mul(jr[l], cc[l]));
      mc[r] = O::add(r == ir ? T(1) : T(0), acc);
      ac[r] = ej[P::A + ir * R + r];
      if constexpr (kFull) {
        T jb = O::mul(jr[0], bb[0]);
        T g = O::mul(jr[0], ai[0]);
#pragma unroll
        for (int l = 1; l < R; ++l) {
          jb = O::add(jb, O::mul(jr[l], bb[l]));
          g = O::add(g, O::mul(jr[l], ai[l]));
        }
        vc[r] = O::sub(ej[P::ETA + r], jb);
        gc[r] = g;
      }
    }
  }
  // t1 = bi + Ci etaj, this lane's row
  T t1 = O::mul(ei[P::C + ir * R], ej[P::ETA]);
#pragma unroll
  for (int l = 1; l < R; ++l) t1 = O::add(t1, O::mul(ei[P::C + ir * R + l], ej[P::ETA + l]));
  t1 = O::add(ei[P::B + ir], t1);

  // elimination with partial pivoting (the first maximal |value|); columns
  // left of the pivot are not updated, as nothing reads them again
#pragma unroll
  for (int col = 0; col < R - 1; ++col) {
    T pc[R];
#pragma unroll
    for (int k = col; k < R; ++k) pc[k] = __shfl_sync(mask, mc[k], base + col);
    T best = mag(pc[col]);
    int p = col;
#pragma unroll
    for (int k = col + 1; k < R; ++k) {
      const T v = mag(pc[k]);
      if (v > best) {
        best = v;
        p = k;
      }
    }
    swap_rows<T, R>(pc, col, p);
    if (ir >= col) swap_rows<T, R>(mc, col, p);
    swap_rows<T, R>(ac, col, p);
    if constexpr (kFull) {
      swap_rows<T, R>(vc, col, p);
      swap_rows<T, R>(gc, col, p);
    }
    const bool own = ir > col;
    const Divisor<T> dp(pc[col]);
#pragma unroll
    for (int r = col + 1; r < R; ++r) {
      const T f = dp.quot(pc[r]);
      if (own) mc[r] = O::sub(mc[r], O::mul(f, mc[col]));
      ac[r] = O::sub(ac[r], O::mul(f, ac[col]));
      if constexpr (kFull) {
        vc[r] = O::sub(vc[r], O::mul(f, vc[col]));
        gc[r] = O::sub(gc[r], O::mul(f, gc[col]));
      }
    }
  }

  // back substitution of the lane's columns: m1t's row ir (x0), m2 (x1)
  // and m3's column ir (x2), the eliminated M's row rr from its lanes
  T x0[R], x1[R], x2[R];
#pragma unroll
  for (int rr = R - 1; rr >= 0; --rr) {
    T s0 = ac[rr], s1 = kFull ? vc[rr] : T(0), s2 = kFull ? gc[rr] : T(0);
#pragma unroll
    for (int j = rr + 1; j < R; ++j) {
      const T u = __shfl_sync(mask, mc[rr], base + j);
      s0 = O::sub(s0, O::mul(u, x0[j]));
      if constexpr (kFull) {
        s1 = O::sub(s1, O::mul(u, x1[j]));
        s2 = O::sub(s2, O::mul(u, x2[j]));
      }
    }
    const Divisor<T> dv(__shfl_sync(mask, mc[rr], base + rr));
    x0[rr] = dv.quot(s0);
    if constexpr (kFull) {
      x1[rr] = dv.quot(s1);
      x2[rr] = dv.quot(s2);
    }
  }

  // the outputs, all computed before any is stored (no store sits between
  // the loads): eta = Ai^T m2 + etai; J's column ir = Ai^T m3[:, ir] +
  // Ji[:, ir]; b = m1t t1 + bj; C = (m1t Ci) Aj^T + Cj; A = m1t Ai
  T et = T(0), jc[R], ar[R];
  if constexpr (kFull) {
    et = O::mul(ei[P::A + ir], x1[0]);
#pragma unroll
    for (int j = 1; j < R; ++j) et = O::add(et, O::mul(ei[P::A + j * R + ir], x1[j]));
    et = O::add(et, ei[P::ETA + ir]);
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      T acc = O::mul(ei[P::A + rr], x2[0]);
#pragma unroll
      for (int j = 1; j < R; ++j) acc = O::add(acc, O::mul(ei[P::A + j * R + rr], x2[j]));
      jc[rr] = O::add(acc, ei[P::J + rr * R + ir]);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      T acc = O::mul(x0[0], ei[P::A + j]);
#pragma unroll
      for (int k = 1; k < R; ++k) acc = O::add(acc, O::mul(x0[k], ei[P::A + k * R + j]));
      ar[j] = acc;
    }
  }
  T bn = O::mul(x0[0], __shfl_sync(mask, t1, base));
#pragma unroll
  for (int k = 1; k < R; ++k) bn = O::add(bn, O::mul(x0[k], __shfl_sync(mask, t1, base + k)));
  bn = O::add(bn, ej[P::B + ir]);
  T t2[R];
#pragma unroll
  for (int l = 0; l < R; ++l) {
    T acc = O::mul(x0[0], ei[P::C + l]);
#pragma unroll
    for (int k = 1; k < R; ++k) acc = O::add(acc, O::mul(x0[k], ei[P::C + k * R + l]));
    t2[l] = acc;
  }
  T cr[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    T acc = O::mul(t2[0], ej[P::A + j * R]);
#pragma unroll
    for (int l = 1; l < R; ++l) acc = O::add(acc, O::mul(t2[l], ej[P::A + j * R + l]));
    cr[j] = O::add(acc, ej[P::C + ir * R + j]);
  }
  if (write) {
    out[oB + ir] = bn;
#pragma unroll
    for (int j = 0; j < R; ++j) out[oC + ir * R + j] = cr[j];
    if constexpr (kFull) {
      out[P::ETA + ir] = et;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        out[P::J + j * R + ir] = jc[j];
        out[P::A + ir * R + j] = ar[j];
      }
    }
  }
}

// the identity element's value at packed offset e
template <typename T, int R>
__device__ __forceinline__ T identity_at(int e) {
  return e < R * R && e / R == e % R ? T(1) : T(0);
}

// Stage 0: the elements of positions [p0, p0 + NP) of the flattened [B N]
// axis, a group a position, through shared tiles: A and Q come in and the
// records go out in coalesced runs (a block's positions are contiguous).
template <typename T, int R>
__global__ void __launch_bounds__(element_threads<T, R>())
kalman_element_kernel(const T* __restrict__ A, const T* __restrict__ Q,
                      const T* __restrict__ H, const T* __restrict__ diag,
                      const T* __restrict__ y, long long total, T* __restrict__ elems) {
  constexpr int TH = element_threads<T, R>();
  constexpr int G = group_lanes(R), NP = TH / G, RR = R * R, S = Pack<R>::S;
  __shared__ T t_a[NP * RR], t_q[NP * RR], t_e[NP * S];
  static_assert(sizeof(T) * NP * (2 * RR + S) <= 48 * 1024,
                "stage 0's tiles fit in 48 KB of static shared memory");
  const long long p0 = static_cast<long long>(blockIdx.x) * NP;
  const int cnt = static_cast<int>(total - p0 < NP ? total - p0 : NP);
  for (int e = threadIdx.x; e < cnt * RR; e += TH) {
    t_a[e] = A[p0 * RR + e];
    t_q[e] = Q[p0 * RR + e];
  }
  __syncthreads();
  const int g = threadIdx.x / G, i = threadIdx.x % G, base = (threadIdx.x % kWarp) - i;
  const int gc = g < cnt ? g : cnt - 1;
  element<T, R>(t_a + gc * RR, t_q + gc * RR, H, diag[p0 + gc], y[p0 + gc], t_e + gc * S, i,
                base, group_mask(G, base), g < cnt);
  __syncthreads();
  for (int e = threadIdx.x; e < cnt * S; e += TH) elems[p0 * S + e] = t_e[e];
}

// Stage 1: chain c = (row, block) of the block's CW composes its positions
// from the identity, a group of lanes a chain on warp 0, and overwrites each
// element of elems with its inclusive prefix. Warp 1 brings tile t + 1 (TS
// elements of every chain) into shared memory with cp.async and writes tile
// t - 1's prefixes out of it while warp 0 walks tile t; one barrier a tile.
// A step reads the prefix before it (the identity record at a chain's first
// step) and the staged element and writes the new prefix into the outgoing
// tile, one __syncwarp a step. The kernel's body, on the block's tiles
// t_in, t_out [2][CW][kRec] and identity record:
template <typename T, int R>
__device__ __forceinline__ void prefix_walk(int b, int n, int length, int m,
                                            T* __restrict__ elems,
                                            T (*t_in)[PrefixTile<T, R>::CW][PrefixTile<T, R>::kRec],
                                            T (*t_out)[PrefixTile<T, R>::CW][PrefixTile<T, R>::kRec],
                                            T* ident) {
  using L = PrefixTile<T, R>;
  constexpr int G = L::G, CW = L::CW, S = L::S, TS = L::TS;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long chains = static_cast<long long>(b) * m;
  const long long c0 = static_cast<long long>(blockIdx.x) * CW;
  const int tiles = (length + TS - 1) / TS;
  // chain c's first position in the flattened [B N] axis and its positions
  auto span = [&](int c, long long& lo, int& cnt) {
    const long long ch = c0 + c;
    if (ch >= chains) {
      lo = 0;
      cnt = 0;
      return;
    }
    const int row = static_cast<int>(ch / m), blk = static_cast<int>(ch % m);
    const int first = blk * length;
    cnt = n - first < length ? n - first : length;
    lo = static_cast<long long>(row) * n + first;
  };

  if (warp == 1) {
    auto stage = [&](int t) {
      for (int c = 0; c < CW; ++c) {
        long long lo;
        int cnt;
        span(c, lo, cnt);
        const int k = cnt - t * TS < TS ? cnt - t * TS : TS;
        const T* src = elems + (lo + static_cast<long long>(t) * TS) * S;
        T* dst = t_in[t & 1][c];
        for (int e = lane; e < k * S; e += kWarp) copy_async(dst + e, src + e);
      }
    };
    auto flush = [&](int t) {
      for (int c = 0; c < CW; ++c) {
        long long lo;
        int cnt;
        span(c, lo, cnt);
        const int k = cnt - t * TS < TS ? cnt - t * TS : TS;
        T* dst = elems + (lo + static_cast<long long>(t) * TS) * S;
        const T* src = t_out[t & 1][c];
        for (int e = lane; e < k * S; e += kWarp) dst[e] = src[e];
      }
    };
    stage(0);
    copy_wait_all();
    __syncthreads();
    for (int t = 0; t <= tiles; ++t) {
      if (t > 0) flush(t - 1);
      if (t + 1 < tiles) stage(t + 1);
      copy_wait_all();
      __syncthreads();
    }
    return;
  }

  const int g = lane / G, i = lane % G, base = g * G;
  const unsigned mask = group_mask(G, base);
  long long lo;
  int cnt;
  span(g, lo, cnt);
  for (int e = lane; e < S; e += kWarp) ident[e] = identity_at<T, R>(e);
  const T* prev = ident;
  __syncthreads();
  for (int t = 0; t <= tiles; ++t) {
    if (t < tiles) {
      const int k = cnt - t * TS < TS ? cnt - t * TS : TS;
      const T* ej = t_in[t & 1][g];
      T* out = t_out[t & 1][g];
      for (int s = 0; s < k; ++s, ej += S, out += S) {
        compose<T, R, true>(prev, ej, out, i, base, mask, true);
        __syncwarp(mask);
        prev = out;
      }
    }
    __syncthreads();
  }
}

// the tiles in static shared memory up to R = 8, dynamic past it
template <typename T, int R>
__global__ void __launch_bounds__(kPrefixWarps * kWarp)
kalman_prefix_kernel(int b, int n, int length, int m, T* __restrict__ elems) {
  using L = PrefixTile<T, R>;
  using Tiles = T[L::CW][L::kRec];
  if constexpr (L::kDynamic) {
    extern __shared__ __align__(16) unsigned char k1_smem[];
    T* const base = reinterpret_cast<T*>(k1_smem);
    prefix_walk<T, R>(b, n, length, m, elems, reinterpret_cast<Tiles*>(base),
                      reinterpret_cast<Tiles*>(base + 2 * L::CW * L::kRec),
                      base + 4 * L::CW * L::kRec);
  } else {
    __shared__ T t_in[2][L::CW][L::kRec], t_out[2][L::CW][L::kRec];
    __shared__ T ident[L::S];
    static_assert(L::bytes <= 48 * 1024, "stage 1's tiles fit in 48 KB of static shared memory");
    prefix_walk<T, R>(b, n, length, m, elems, t_in, t_out, ident);
  }
}

// Stage 2, one level: item x of row `row` of [B, leaves] becomes
// in[x - h] o in[x] for x >= h, else in[x]. `in` null reads the leaves:
// carry_in (when given) and each block's last prefix in elems. h = 0 copies
// (a lone leaf). carry_out, when given, takes each row's last item. A
// group brings its two operands into shared memory, then composes them.
template <typename T, int R>
__global__ void __launch_bounds__(tree_threads<T, R>())
kalman_tree_kernel(const T* __restrict__ carry_in, int b, int n, int length, int leaves, int h,
                   const T* __restrict__ elems, const T* __restrict__ in, T* __restrict__ out,
                   T* __restrict__ carry_out) {
  constexpr int G = group_lanes(R), NG = tree_threads<T, R>() / G, S = Pack<R>::S;
  __shared__ T ops[NG][2][S];
  static_assert(sizeof(T) * NG * 2 * S <= 48 * 1024, "stage 2's operands fit in 48 KB");
  const int g = threadIdx.x / G, i = threadIdx.x % G, base = (threadIdx.x % kWarp) - i;
  const unsigned mask = group_mask(G, base);
  const long long items = static_cast<long long>(b) * leaves;
  const long long it0 = static_cast<long long>(blockIdx.x) * NG + g;
  const bool live = it0 < items;
  const long long it = live ? it0 : items - 1;
  const int row = static_cast<int>(it / leaves), x = static_cast<int>(it % leaves);
  auto at = [&](int j) -> const T* {
    if (in) return in + (static_cast<long long>(row) * leaves + j) * S;
    if (carry_in) {
      if (j == 0) return carry_in + static_cast<long long>(row) * S;
      --j;
    }
    const long long end = static_cast<long long>(j + 1) * length;
    return elems + (static_cast<long long>(row) * n + (end < n ? end : n) - 1) * S;
  };
  T* dst = out + it * S;
  if (h > 0 && x >= h) {
    const T* ei = at(x - h);
    const T* ej = at(x);
    for (int e = i; e < S; e += G) {
      ops[g][0][e] = ei[e];
      ops[g][1][e] = ej[e];
    }
    __syncwarp(mask);
    compose<T, R, true>(ops[g][0], ops[g][1], dst, i, base, mask, live);
  } else if (live) {
    const T* src = at(x);
    for (int e = i; e < S; e += G) dst[e] = src[e];
  }
  if (carry_out && x == leaves - 1) {
    __syncwarp(mask);
    if (live)
      for (int e = i; e < S; e += G) carry_out[static_cast<long long>(row) * S + e] = dst[e];
  }
}

// Stage 3: position p of the flattened [B N] axis, a group a position. The
// filtered (b, C) at p - 1 goes to the group's shared record, then
// mu_p = H.(A_p b) and s_p = H (A_p C A_p^T + Q_p) H + diag_p, lane i
// holding row i and the sums over rows taken by every lane in the plain
// order from __shfl_sync (ops/kalman.py::_innovation).
template <typename T, int R>
__global__ void __launch_bounds__(kGroupThreads)
kalman_innovation_kernel(const T* __restrict__ A, const T* __restrict__ Q,
                         const T* __restrict__ H, const T* __restrict__ diag,
                         const T* __restrict__ carry_in, int b, int n, int length, int leaves,
                         const T* __restrict__ elems, const T* __restrict__ tree,
                         T* __restrict__ mu, T* __restrict__ s) {
  using O = Rn<T>;
  using P = Pack<R>;
  constexpr int G = group_lanes(R), NG = kGroupThreads / G, S = P::S;
  constexpr int F = R + R * R;  // a filtered (b, C)
  __shared__ T fs[NG][F];
  const int g = threadIdx.x / G, i = threadIdx.x % G, base = (threadIdx.x % kWarp) - i;
  const int ir = i < R ? i : R - 1;
  const unsigned mask = group_mask(G, base);
  const long long items = static_cast<long long>(b) * n;
  const long long it0 = static_cast<long long>(blockIdx.x) * NG + g;
  const bool live = it0 < items;
  const long long it = live ? it0 : items - 1;
  const int row = static_cast<int>(it / n), pp = static_cast<int>(it % n);
  T* const f = fs[g];
  if (pp == 0) {
    const T* c = carry_in ? carry_in + static_cast<long long>(row) * S : nullptr;
    for (int e = i; e < F; e += G) f[e] = c ? c[P::B + e] : T(0);
  } else {
    const int j = (pp - 1) / length - (carry_in ? 0 : 1);
    const T* prefix = elems + (it - 1) * S;
    if (j < 0) {
      for (int e = i; e < F; e += G) f[e] = prefix[P::B + e];
    } else {
      compose<T, R, false>(tree + (static_cast<long long>(row) * leaves + j) * S, prefix, f,
                           i, base, mask, true);
    }
  }
  __syncwarp(mask);
  T h[R];
#pragma unroll
  for (int j = 0; j < R; ++j) h[j] = H[j];
  const T* a = A + it * R * R;
  const T* ar = a + ir * R;
  T mi = O::mul(ar[0], f[0]);
#pragma unroll
  for (int k = 1; k < R; ++k) mi = O::add(mi, O::mul(ar[k], f[k]));
  T t[R];
#pragma unroll
  for (int l = 0; l < R; ++l) {
    T acc = O::mul(ar[0], f[R + l]);
#pragma unroll
    for (int k = 1; k < R; ++k) acc = O::add(acc, O::mul(ar[k], f[R + k * R + l]));
    t[l] = acc;
  }
  const T* qr = Q + it * R * R + ir * R;
  T ph = T(0);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    T acc = O::mul(t[0], a[j * R]);
#pragma unroll
    for (int l = 1; l < R; ++l) acc = O::add(acc, O::mul(t[l], a[j * R + l]));
    acc = O::add(acc, qr[j]);
    ph = j == 0 ? O::mul(acc, h[0]) : O::add(ph, O::mul(acc, h[j]));
  }
  T mu_p = O::mul(h[0], __shfl_sync(mask, mi, base));
  T s_p = O::mul(h[0], __shfl_sync(mask, ph, base));
#pragma unroll
  for (int k = 1; k < R; ++k) {
    mu_p = O::add(mu_p, O::mul(h[k], __shfl_sync(mask, mi, base + k)));
    s_p = O::add(s_p, O::mul(h[k], __shfl_sync(mask, ph, base + k)));
  }
  if (live && i == 0) {
    mu[it] = mu_p;
    s[it] = O::add(s_p, diag[it]);
  }
}

// L and m (ops/kalman.py::block_geometry) and the scan's levels
__host__ __device__ inline void geometry_of(int n, int nb, int* length, int* m) {
  *length = (n + nb - 1) / nb;
  *m = (n + *length - 1) / *length;
}

inline int tree_levels(int leaves) {
  int d = 0;
  while ((1 << d) < leaves) ++d;
  return d;
}

inline int grid_of(long long items, int per_block) {
  return static_cast<int>((items + per_block - 1) / per_block);
}

}  // namespace

namespace kalman_k {

// The launches of one width R. kalman.cu instantiates R <= 8 and declares
// the wider ones extern; PERIODICITY_KALMAN_WIDTH(R) instantiates one in the
// translation unit of its own.
template <typename T, int R>
struct Width {
  static cudaError_t launch(const T* A, const T* Q, const T* H, const T* diag, const T* y,
                            const T* carry_in, int b, int n, int nb, T* elems, T* tree, T* mu,
                            T* s, T* carry_out, cudaStream_t stream);
  // the launch geometry: out = {lanes a group, positions a stage-0 block,
  // stage-0 blocks, chains a stage-1 block, stage-1 blocks, stage-1
  // threads, steps a stage-1 tile, L, m, leaves, stage-2 launches, items a
  // stage-3 block, stage-3 blocks, items a stage-2 block, stage-2 blocks}
  static void geometry(int b, int n, int nb, int carry, int* out);
  // the compiled resources of the four stages' kernels: out = {local
  // memory bytes a thread, registers a thread, shared memory bytes a block
  // (static, and stage 1's dynamic past R = 8)} for stage 0, 1, 2 and 3 in
  // turn
  static cudaError_t attributes(int* out);
};

template <typename T, int R>
cudaError_t Width<T, R>::launch(const T* A, const T* Q, const T* H, const T* diag, const T* y,
                                const T* carry_in, int b, int n, int nb, T* elems, T* tree,
                                T* mu, T* s, T* carry_out, cudaStream_t stream) {
  using L = PrefixTile<T, R>;
  constexpr int G = group_lanes(R), NG = kGroupThreads / G, S = Pack<R>::S;
  constexpr int TE = element_threads<T, R>(), TT = tree_threads<T, R>();
  if constexpr (L::kDynamic) {
    // stage 1's shared-memory limit, raised once a device (the call costs
    // host time and the answer never changes)
    static std::atomic<unsigned long long> raised{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev % 64);
    if (!(raised.load() & bit)) {
      err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&kalman_prefix_kernel<T, R>),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
      if (err != cudaSuccess) return err;
      raised.fetch_or(bit);
    }
  }
  int length, m;
  geometry_of(n, nb, &length, &m);
  const long long total = static_cast<long long>(b) * n;
  const int leaves = m + (carry_in ? 1 : 0);
  kalman_element_kernel<T, R><<<grid_of(total, TE / G), TE, 0, stream>>>(A, Q, H, diag, y, total,
                                                                         elems);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kalman_prefix_kernel<T, R><<<grid_of(static_cast<long long>(b) * m, L::CW),
                               kPrefixWarps * kWarp, L::kDynamic ? L::bytes : 0, stream>>>(
      b, n, length, m, elems);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int levels = tree_levels(leaves);
  const int launches = levels > 0 ? levels : 1;
  T* buf[2] = {tree, tree + static_cast<long long>(b) * leaves * S};
  for (int d = 0; d < launches; ++d) {
    kalman_tree_kernel<T, R><<<grid_of(static_cast<long long>(b) * leaves, TT / G), TT, 0,
                               stream>>>(
        carry_in, b, n, length, leaves, levels > 0 ? 1 << d : 0, elems,
        d > 0 ? buf[(d - 1) & 1] : nullptr, buf[d & 1], d + 1 == launches ? carry_out : nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  kalman_innovation_kernel<T, R><<<grid_of(total, NG), kGroupThreads, 0, stream>>>(
      A, Q, H, diag, carry_in, b, n, length, leaves, elems, buf[(launches - 1) & 1], mu, s);
  return cudaGetLastError();
}

template <typename T, int R>
void Width<T, R>::geometry(int b, int n, int nb, int carry, int* out) {
  constexpr int G = group_lanes(R), NG = kGroupThreads / G;
  constexpr int TE = element_threads<T, R>(), TT = tree_threads<T, R>();
  int length, m;
  geometry_of(n, nb, &length, &m);
  const long long total = static_cast<long long>(b) * n;
  const int leaves = m + (carry ? 1 : 0);
  const int levels = tree_levels(leaves);
  out[0] = G;
  out[1] = TE / G;
  out[2] = grid_of(total, TE / G);
  out[3] = PrefixTile<T, R>::CW;
  out[4] = grid_of(static_cast<long long>(b) * m, PrefixTile<T, R>::CW);
  out[5] = kPrefixWarps * kWarp;
  out[6] = PrefixTile<T, R>::TS;
  out[7] = length;
  out[8] = m;
  out[9] = leaves;
  out[10] = levels > 0 ? levels : 1;
  out[11] = NG;
  out[12] = grid_of(total, NG);
  out[13] = TT / G;
  out[14] = grid_of(static_cast<long long>(b) * leaves, TT / G);
}

template <typename T, int R>
cudaError_t Width<T, R>::attributes(int* out) {
  const void* fns[4] = {reinterpret_cast<const void*>(&kalman_element_kernel<T, R>),
                        reinterpret_cast<const void*>(&kalman_prefix_kernel<T, R>),
                        reinterpret_cast<const void*>(&kalman_tree_kernel<T, R>),
                        reinterpret_cast<const void*>(&kalman_innovation_kernel<T, R>)};
  for (int k = 0; k < 4; ++k) {
    cudaFuncAttributes a{};
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[k]);
    if (err != cudaSuccess) return err;
    out[3 * k] = static_cast<int>(a.localSizeBytes);
    out[3 * k + 1] = a.numRegs;
    out[3 * k + 2] = static_cast<int>(a.sharedSizeBytes) +
                     (k == 1 && PrefixTile<T, R>::kDynamic ? PrefixTile<T, R>::bytes : 0);
  }
  return cudaSuccess;
}

}  // namespace kalman_k

// one width's instantiation, in the translation unit that owns it, and its
// declaration in the others
#define PERIODICITY_KALMAN_WIDTH(RR)          \
  template struct kalman_k::Width<float, RR>; \
  template struct kalman_k::Width<double, RR>;
#define PERIODICITY_KALMAN_EXTERN(RR)                \
  extern template struct kalman_k::Width<float, RR>; \
  extern template struct kalman_k::Width<double, RR>;
