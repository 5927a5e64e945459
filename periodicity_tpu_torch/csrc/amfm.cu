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
// each pass is a chain of dependent block-wide steps: the extrema's scan,
// the knots, the solve (ceil(log2 cnt) PCR levels over the cnt valid
// knots), the Hermite evaluation with the division, and one max reduction.
// Bytes are few (X and t in, A and F out, once). So the longest row's
// chain bounds the launch.
//
// What the design does about it. One thread block per row, 512 threads,
// with t, F, A, |F|, the maxima's round masks and one envelope's knots and
// double-buffered rows in dynamic shared memory (74 KB at N = 2048 in
// float32, 148 KB in float64), addressed as shared memory (LDS, STS), or
// in global scratch where they do not fit (float64 above N ~ 3200), through
// a second instance of the same code. Rows retire on their own (a finished
// block exits), and no host read happens inside the loop. One row keeps
// all four schedulers of an SM issuing, so a second row on the SM would
// mostly wait for them: one block an SM, 128 registers a thread. A pass
// has a barrier for each dependent step and no more:
//   - the division sweep writes F, A and |F| and each warp's max of |F|;
//     the barrier that ends it publishes the max, which is the stop test
//     and, in the next pass, the constant envelope (the max is exact in
//     any order, so the stop flag is the plain version's bit);
//   - the maxima come from one sweep of ballots (a sample above both
//     neighbours) wherever no two neighbours tie or are unordered, which a
//     vote on the sweep's barrier confirms; else S1's plateau pass
//     (envelope.cuh::extrema) redoes them. The knots are S1's;
//   - a system of capacity below 32 takes S1's Thomas solve; every other
//     one a block-wide PCR over its valid rows, a row a thread (a second
//     row past 512 rows), each row one record of four, double-buffered,
//     one barrier a level; in float32 the level's barrier
//     votes from the fifth level on, and the levels end where the rest
//     cannot change the envelope (below);
//   - the derivatives go out with the knots as records (time, value,
//     derivative), which the Hermite evaluation reads, a thread's samples
//     side by side;
//   - float32 quotients take quot_fast's path and, for finite nonzero
//     operands outside it (the PCR couplings shrink past 2^-60 and
//     through the subnormals, where __fdiv_rn leaves its fast path),
//     rn::Wide's float64-refined quotient;
//     float64 quotients are rn::Checked (one reciprocal a divisor,
//     accepted where its residual proves the correctly rounded quotient,
//     else div_rn).
//
// The early end of the PCR levels. Once every valid row has a = c = 0 (of
// either sign) with b finite and nonzero and d finite, every later level
// gives alpha = beta = +-0, so b keeps its bits and d keeps its bits unless
// it is a zero, whose sign may change; the derivatives d / b then differ
// from the plain version's at most in the sign of a zero. That sign never
// reaches the envelope where pad_width >= 1 and t rises strictly (checked
// once a launch): every sample then lies in [x0, x1) of its interval, so
// u is in [0, 1], the Hermite weights h00, h10, h01 are >= +0 and the knot
// values (maxima of |F|) are >= +0 or NaN, and a partial sum of the
// evaluation is never -0, so adding a signed zero term leaves its bits.
// In float32 the couplings underflow to zero after ~7 levels (config 9:
// every system of more than 128 rows), so up to 3 of 10 levels go; in
// float64 only systems past ~1000 rows could end early, so it never votes.
//
// Every floating-point operation is rounded on its own (rn.cuh) in the
// plain version's order, so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

#include "envelope.cuh"
#include "rn.cuh"

namespace {

using namespace envelope;

// The rounds a thread takes side by side in a sweep: in float32 all of its
// rounds at N <= 2048; in float64 one (more would spill registers).
template <typename T>
constexpr int kSide = sizeof(T) == 4 ? 4 : 1;

#ifdef AMFM_SPLIT
// The stage split, compiled only with -DAMFM_SPLIT (chip_points.py's
// amfm_split group builds this unit alone so): thread 0 of each block
// stamps clock64() at a barrier after every stage of a pass and keeps, for
// the first kSplitRows rows and kSplitPasses passes, the cycles of each
// stage and the pass's shape in amfm_split_buf (read with
// amfm_split_read). The barriers are the split's own: the default build
// has none of them and no stamp.
constexpr int kSplitRows = 512, kSplitPasses = 16, kSplitSlots = 24;
// slots: 0 |F| (fused into the division: 0), 1 extrema, 2 knots, 3 the
// Thomas solve, 4 Hermite and the division, 5 the stop test; 6 the knot
// count, 7 the path (SplitPath), 8 PCR levels run, 9 whether the plateau
// pass ran, 10 the block solve's row build, 11 its derivatives, 12-23 its
// levels one by one
enum SplitPath { kPathFlat = 0, kPathThomas = 1, kPathBlock = 2 };
__device__ long long amfm_split_buf[kSplitRows * kSplitPasses * kSplitSlots];

// thread 0's slots and its last stamp, in static shared memory (so that
// the stamps hold no register of their own)
__shared__ long long split_slot[kSplitSlots + 1];

struct Split {
  __device__ void start() {
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int s = 0; s < kSplitSlots; ++s) split_slot[s] = 0;
      split_slot[kSplitSlots] = clock64();
    }
  }
  // cycles since the last stamp into slot s, after a barrier
  __device__ void stamp(int s) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long now = clock64();
      split_slot[s] += now - split_slot[kSplitSlots];
      split_slot[kSplitSlots] = now;
    }
  }
  // a value into slot s (thread 0's)
  __device__ void note(int s, long long v) {
    if (threadIdx.x == 0) split_slot[s] = v;
  }
  __device__ void store(int row, int pass) const {
    if (threadIdx.x == 0 && row < kSplitRows && pass < kSplitPasses)
      for (int s = 0; s < kSplitSlots; ++s)
        amfm_split_buf[(row * kSplitPasses + pass) * kSplitSlots + s] = split_slot[s];
  }
};
#define SPLIT(stmt) stmt
#else
struct Split {};
#define SPLIT(stmt)
#endif

// One row's working arrays, carved from one byte range.
template <typename T>
struct Work {
  T* t;            // [n] the grid
  T* F;            // [n] the FM part
  T* A;            // [n] the AM part
  T* x;            // [n] |F|
  Rounds<1> rd;    // the maxima of |F|, round by round
  Knots<T, 1> kn;  // the envelope's knots and rows
};

template <typename T>
__host__ __device__ size_t carve(int n, int k, char* base, Work<T>& w) {
  Carve c{base};
  w.t = c.take<T>(n);
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

// max over the warp, to every lane, of values >= +0 or NaN with the sign
// bit clear (|F|): in float32 the bit patterns order as the values do,
// NaN above all, so one integer reduction
__device__ __forceinline__ float warp_max(float v) {
  return __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(v)));
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the block's max from the warps' maxima in sh, to every thread
template <typename T>
__device__ __forceinline__ T block_max(const T* sh) {
  return warp_max(sh[(threadIdx.x & 31) % kWarps]);
}

// N1's quotients a / d, rounded as Rn<T>::div rounds them: fast, the
// branch-free path and whether it is that quotient; slow, the quotient
// for any operands; one and two (Quot), the fast paths with one branch to
// slow. float32: envelope.cuh's quot_fast, else rn::Wide for finite nonzero
// operands (the PCR levels' couplings, which shrink past 2^-60 and through
// the subnormals, where __fdiv_rn leaves its fast path), else div_rn.
// float64: rn::Checked, a zero numerator over a finite nonzero d as a * d
// (div_rn's zero), anything the residual does not prove by div_rn.
template <typename T>
struct QuotPath;

template <>
struct QuotPath<float> {
  static __device__ __forceinline__ float fast(float a, float d, bool& ok) {
    return quot_fast(a, d, &ok);
  }
  static __device__ __forceinline__ bool wide(float a, float d) {
    return isfinite(a) & (a != 0.0f) & isfinite(d) & (d != 0.0f);
  }
  static __device__ __forceinline__ float slow(float a, float d) {
    return wide(a, d) ? rn::Wide(d).quot(a) : div_rn(a, d);
  }
};

template <>
struct QuotPath<double> {
  static __device__ __forceinline__ double fast(double a, double d, bool& ok) {
    const rn::Checked<double> c(d);
    ok = true;
    const double q = c.quot(a, ok);
    const bool zero = (a == 0.0) & c.in;
    ok |= zero;
    return zero ? __dmul_rn(a, d) : q;
  }
  static __device__ __forceinline__ double slow(double a, double d) { return div_rn(a, d); }
};

template <typename T>
struct Quot : QuotPath<T> {
  using P = QuotPath<T>;
  static __device__ __forceinline__ T one(T a, T d) {
    bool ok;
    T q = P::fast(a, d, ok);
    if (!ok) q = P::slow(a, d);
    return q;
  }
  static __device__ __forceinline__ void two(T a1, T d1, T a2, T d2, T& q1, T& q2) {
    bool ok1, ok2;
    q1 = P::fast(a1, d1, ok1);
    q2 = P::fast(a2, d2, ok2);
    if (!(ok1 & ok2)) {
      if (!ok1) q1 = P::slow(a1, d1);
      if (!ok2) q2 = P::slow(a2, d2);
    }
  }
};

// Records of four (a Row: a tridiagonal row a, b, c, d, or a knot: time,
// value, derivative, unused) in one buffer of the knots' system arrays
// (four arrays of ld, buffer h at sys(0, h, 0)), loaded and stored whole:
// float32 as one 16-byte record (LDS.128), float64 as two 16-byte halves
// in two arrays of ld pairs (a lane stride of 32 bytes would put two lanes
// of a quarter warp on the same banks).
template <typename T>
struct Recs;

template <>
struct Recs<float> {
  float* p;
  int ld;
  __device__ __forceinline__ Row<float> get(int i) const {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    return {v.x, v.y, v.z, v.w};
  }
  __device__ __forceinline__ void put(int i, const Row<float>& r) const {
    reinterpret_cast<float4*>(p)[i] = make_float4(r.a, r.b, r.c, r.d);
  }
};

template <>
struct Recs<double> {
  double* p;
  int ld;
  __device__ __forceinline__ Row<double> get(int i) const {
    const double2 lo = reinterpret_cast<const double2*>(p)[i];
    const double2 hi = reinterpret_cast<const double2*>(p + 2 * ld)[i];
    return {lo.x, lo.y, hi.x, hi.y};
  }
  __device__ __forceinline__ void put(int i, const Row<double>& r) const {
    reinterpret_cast<double2*>(p)[i] = make_double2(r.a, r.b);
    reinterpret_cast<double2*>(p + 2 * ld)[i] = make_double2(r.c, r.d);
  }
};

template <typename T>
__device__ __forceinline__ Recs<T> recs(const Knots<T, 1>& kn, int h) {
  return {kn.sys(0, h, 0), kn.ld};
}

// Stages 1-2 where no neighbours tie: the maxima of x are the samples
// 1 <= i <= n-2 above both neighbours (scipy's plateau rule has nothing
// else to find), one ballot a round, kNR rounds' loads side by side, with
// the counts as extrema() leaves them. Returns whether this thread saw two
// neighbours equal or unordered (a NaN), where the plateau pass must run
// instead.
template <int kNR, typename T>
__device__ bool maxima_untied(const T* x, int n, const Rounds<1>& rd, WarpTotals& wt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nr = rounds(n);
  int count = 0;
  bool tie = false;
  for (int j0 = 0; j0 < nr; j0 += kNR) {
    T left[kNR], mid[kNR], right[kNR];
#pragma unroll
    for (int u = 0; u < kNR; ++u) {
      const int i = 32 * (warp * nr + j0 + u) + lane;
      const bool live = j0 + u < nr;
      mid[u] = live && i < n ? x[i] : T(0);
      right[u] = live && i + 1 < n ? x[i + 1] : T(0);
      left[u] = live && i >= 1 && i < n ? x[i - 1] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kNR; ++u) {
      const int r = warp * nr + j0 + u;
      const int i = 32 * r + lane;
      const bool live = j0 + u < nr;  // the same on every lane
      const bool in = live && i + 1 < n;
      const T c = mid[u];
      tie |= in && !(c < right[u] || c > right[u]);
      const unsigned m = __ballot_sync(kFull, in && i >= 1 && c > left[u] && c > right[u]);
      if (live && lane == 0) {
        rd.mask[0][r] = m;
        rd.before[0][r] = count;
      }
      count += __popc(m);
    }
  }
  if (lane == 0) wt.count[0][warp] = count;
  return tie;
}

// Stage 6 over this thread's rounds, kNR side by side: the envelope at
// each sample (envelope.cuh's hermite on the knot records, with N1's
// quotients; the constant fmax where !ok), F <- F / env, A <- A env and
// |F|; returns the thread's max of |F|. Each quotient's fast path runs for
// the kNR samples together and one branch redoes any it does not prove.
template <int kNR, typename T>
__device__ T divide(const Work<T>& W, const Recs<T>& kq, const Extrema<1>& ex, int n, int w,
                    int cnt, bool ok, T fmax) {
  using R = Rn<T>;
  const int lane = threadIdx.x & 31;
  const int nr = rounds(n);
  const int r0 = (threadIdx.x >> 5) * nr;
  T m = T(0);
  for (int j0 = 0; j0 < nr; j0 += kNR) {
    int idx[kNR];
    bool live[kNR];
    T env[kNR], f[kNR];
#pragma unroll
    for (int u = 0; u < kNR; ++u) {
      const int q = r0 + j0 + u;
      idx[u] = 32 * q + lane;
      live[u] = j0 + u < nr && idx[u] < n;
      env[u] = fmax;
    }
    if (ok) {
      T num[kNR], h[kNR], u_[kNR];
      Row<T> k0[kNR], k1[kNR];
      bool all = true, oku[kNR];
#pragma unroll
      for (int u = 0; u < kNR; ++u) {
        // hi = searchsorted(knots, t[i], "right"), from the running count
        const int hi = w + count_at(W.rd, ex, 0, live[u] ? r0 + j0 + u : r0, lane);
        const int j = min(max(hi - 1, 0), cnt - 2);
        k0[u] = kq.get(j);
        k1[u] = kq.get(j + 1);
        h[u] = R::sub(k1[u].a, k0[u].a);
        num[u] = R::sub(W.t[live[u] ? idx[u] : 0], k0[u].a);
        u_[u] = Quot<T>::fast(num[u], h[u], oku[u]);
        all &= oku[u] | !live[u];
      }
      if (!all) {
#pragma unroll
        for (int u = 0; u < kNR; ++u)
          if (live[u] && !oku[u]) u_[u] = Quot<T>::slow(num[u], h[u]);
      }
#pragma unroll
      for (int u = 0; u < kNR; ++u) {
        const T uu0 = u_[u];
        const T omu = R::sub(T(1), uu0);
        const T omu2 = R::mul(omu, omu);
        const T h00 = R::mul(R::add(T(1), R::mul(T(2), uu0)), omu2);
        const T h10 = R::mul(uu0, omu2);
        const T uu = R::mul(uu0, uu0);
        const T h01 = R::mul(uu, R::sub(T(3), R::mul(T(2), uu0)));
        const T h11 = R::mul(uu, R::sub(uu0, T(1)));
        env[u] = R::add(R::add(R::add(R::mul(h00, k0[u].b), R::mul(R::mul(h10, h[u]), k0[u].c)),
                               R::mul(h01, k1[u].b)),
                        R::mul(R::mul(h11, h[u]), k1[u].c));
      }
    }
    T fv[kNR];
    bool all = true, okf[kNR];
#pragma unroll
    for (int u = 0; u < kNR; ++u) {
      fv[u] = W.F[live[u] ? idx[u] : 0];
      f[u] = Quot<T>::fast(fv[u], env[u], okf[u]);
      all &= okf[u] | !live[u];
    }
    if (!all) {
#pragma unroll
      for (int u = 0; u < kNR; ++u)
        if (live[u] && !okf[u]) f[u] = Quot<T>::slow(fv[u], env[u]);
    }
#pragma unroll
    for (int u = 0; u < kNR; ++u) {
      if (live[u]) {
        const int i = idx[u];
        W.F[i] = f[u];
        W.A[i] = R::mul(W.A[i], env[u]);
        W.x[i] = fabs(f[u]);
        m = max_nan(m, fabs(f[u]));
      }
    }
  }
  return m;
}

// the block's count of maxima and those in the warps before this thread's,
// from the warps' counts (extrema()'s last step)
__device__ __forceinline__ Extrema<1> counts(const WarpTotals& wt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int v = lane < kWarps ? wt.count[0][lane] : 0;
  Extrema<1> ex;
  ex.count[0] = __reduce_add_sync(kFull, v);
  ex.before[0] = __reduce_add_sync(kFull, lane < warp ? v : 0);
  ex.zero = 0;
  return ex;
}

// a coupling left, or a row the early end does not cover
template <typename T>
__device__ __forceinline__ bool live(const Row<T>& r) {
  return r.a != T(0) || r.c != T(0) || !(isfinite(r.b) && r.b != T(0) && isfinite(r.d));
}

// The knot records from the derivatives s of S1's Thomas solve, into kq;
// ends on a barrier.
template <typename T>
__device__ void pack_knots(int c, const Knots<T, 1>& kn, const T* s, const Recs<T>& kq) {
  for (int i = threadIdx.x; i < c; i += kThreads) kq.put(i, {kn.pt(0)[i], kn.pv(0)[i], s[i], T(0)});
  __syncthreads();
}

// Stages 4-5 for a system of c valid rows at capacity >= 32: the knots'
// derivatives by PCR over the valid rows, the block's threads a row each
// (a second past kThreads rows), the rows as records in
// the two buffers and one barrier a level. In float32 the barrier votes
// from the fifth level on whether any row is live; where none is and
// may_end holds, the levels end (the header's argument). Returns the knot
// records, in the buffer the last level read; *levels gets the levels run.
// Ends on a barrier.
template <typename T>
__device__ Recs<T> solve_block(int c, const Knots<T, 1>& kn, bool may_end, int* levels,
                               Split& sp) {
  const int tid = threadIdx.x;
  const T* x = kn.pt(0);
  const T* y = kn.pv(0);
  for (int i = tid; i < c; i += kThreads) recs(kn, 0).put(i, spline_row(x, y, c, i));
  __syncthreads();
  SPLIT(sp.stamp(10));
  const Row<T> id = identity_row<T>();
  int src = 0;
  *levels = 0;
  for (int s = 1; s < c; s *= 2) {
    const Recs<T> in = recs(kn, src), out = recs(kn, src ^ 1);
    bool any = false;
    for (int i = tid; i < c; i += kThreads) {
      const Row<T> o = pcr_level<T, Quot<T>>(in.get(i), i >= s ? in.get(i - s) : id,
                                             i + s < c ? in.get(i + s) : id);
      out.put(i, o);
      any |= live(o);
    }
    src ^= 1;
    ++*levels;
    // the vote, where it can end the levels: in float32 from the fifth
    // level on (the couplings shrink from ~1/4 of the diagonal, squared
    // each level); float64 underflows past 2^-1074 only beyond ~10 levels
    bool more = true;
    if (sizeof(T) == 4 && s >= 16)
      more = __syncthreads_or(any);
    else
      __syncthreads();
    SPLIT(sp.stamp(min(11 + *levels, kSplitSlots - 1)));
    if (!more && may_end) break;
  }
  // the derivatives d / b, with the knots, into the buffer the last level
  // read
  const Recs<T> in = recs(kn, src), kq = recs(kn, src ^ 1);
  for (int i = tid; i < c; i += kThreads) {
    const Row<T> q = in.get(i);
    kq.put(i, {x[i], y[i], Quot<T>::one(q.d, q.b), T(0)});
  }
  __syncthreads();
  SPLIT(sp.stamp(11));
  return kq;
}

// kShared: the row's arrays are in the block's dynamic shared memory (the
// compiler then addresses them as shared, with LDS and STS), else in the
// global scratch
template <typename T, bool kShared>
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
  const int warp = tid >> 5;
  const int w = pad_width;
  const int k = capacity(n, w);
  Work<T> W;
  carve<T>(n, k, kShared ? smem : scratch + static_cast<size_t>(r) * row_bytes, W);
  const T* x0 = X + static_cast<size_t>(r) * n;
  // t, F = X, A = 1, |F| and its max; whether t rises strictly
  T m = T(0);
  bool rising = true;
  for (int i = tid; i < n; i += kThreads) {
    const T ti = t[i];
    const T xi = x0[i];
    W.t[i] = ti;
    W.F[i] = xi;
    W.A[i] = T(1);
    W.x[i] = fabs(xi);
    m = max_nan(m, fabs(xi));
    if (i + 1 < n) rising &= ti < t[i + 1];
  }
  m = warp_max(m);
  if (lane == 0) shm[warp] = m;
  const bool may_end = __syncthreads_and(rising) && w >= 1;
  // max|F| of the current F: the constant envelope, and the stop test
  T fmax = block_max(shm);
  int it = 0;

  while (it < n_iter) {
    Split sp;
    SPLIT(sp.start());
    // 1-2. the maxima of |F| and their running counts
    constexpr int kNR = kSide<T>;
    const bool tie = __syncthreads_or(maxima_untied<kNR>(W.x, n, W.rd, wt));
    const Extrema<1> ex = tie ? extrema(W.x, n, W.rd, wt) : counts(wt);
    SPLIT(sp.stamp(1));
    SPLIT(sp.note(9, tie));
    const int n_int = ex.count[0];
    const int cnt[1] = {n_int + 2 * w};
    const bool ok = n_int >= max(w, 1) && cnt[0] >= 4;
    Recs<T> kq = recs(W.kn, 0);
    if (ok) {
      // 3-5. the padded knots, the system and the knots' derivatives
      place_knots(W.t, W.x, n, w, W.rd, ex, W.kn);
      SPLIT(sp.stamp(2));
      if (k < kPcrMinSize) {
        // S1's Thomas recursion over the capacity (in buffer 1)
        const T* sd[1];
        solve_derivatives(cnt, k, W.kn, sd);
        pack_knots(cnt[0], W.kn, sd[0], kq);
        SPLIT(sp.stamp(3));
      } else {
        int levels;
        kq = solve_block(cnt[0], W.kn, may_end, &levels, sp);
        SPLIT(sp.note(8, levels));
      }
    }
    // 6. the envelope at every sample, the division, |F| and its max
    m = divide<kNR>(W, kq, ex, n, w, cnt[0], ok, fmax);
    m = warp_max(m);
    if (lane == 0) shm[warp] = m;
    __syncthreads();
    SPLIT(sp.stamp(4));
    fmax = block_max(shm);
    const bool done = R::sub(fmax, T(1)) < eps;
    SPLIT(sp.stamp(5));
    SPLIT(sp.note(6, ok ? cnt[0] : 0));
    SPLIT(sp.note(7, !ok ? kPathFlat : k < kPcrMinSize ? kPathThomas : kPathBlock));
    SPLIT(sp.store(r, it));
    ++it;
    if (done) break;
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

// N1's float32 quotient (Quot<float>::one) against __fdiv_rn on n operand
// pairs, to the bit pattern: mode 0 hashed bit patterns; 1 numerators from
// the subnormals to 2^-61 over divisors inside quot_fast's window (the PCR
// levels' couplings); 2 numerators inside the window over divisors outside
// it; 3 such numerators over hashed divisors. out[0] gets the pairs that
// differ, out[1] those that took rn::Wide.
__global__ void quot_check_kernel(unsigned long long n, int mode, unsigned long long* out) {
  unsigned long long bad = 0, wide = 0;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * static_cast<unsigned long long>(blockDim.x) + threadIdx.x;
       i < n; i += stride) {
    const unsigned long long h = rn::mix(i * 8 + mode);
    unsigned ua = static_cast<unsigned>(h), ud = static_cast<unsigned>(h >> 32);
    const unsigned ea = (ua >> 23) & 0xffu, ed = (ud >> 23) & 0xffu;
    if (mode == 1 || mode == 3) ua = (ua & 0x807fffffu) | (ea % 67u) << 23;
    if (mode == 1) ud = (ud & 0x807fffffu) | (ed % 121u + 67u) << 23;
    if (mode == 2) {
      ua = (ua & 0x807fffffu) | (ea % 121u + 67u) << 23;
      const unsigned out_e = ed % 134u;
      ud = (ud & 0x807fffffu) | (out_e < 67u ? out_e : out_e + 121u) << 23;
    }
    const float a = __uint_as_float(ua), d = __uint_as_float(ud);
    bool exact;
    quot_fast(a, d, &exact);
    wide += !exact && Quot<float>::wide(a, d) ? 1 : 0;
    bad += __float_as_uint(Quot<float>::one(a, d)) != __float_as_uint(__fdiv_rn(a, d)) ? 1 : 0;
  }
  atomicAdd(out, bad);
  atomicAdd(out + 1, wide);
}

// Bytes of one row's arrays, and the dynamic shared memory a block may use:
// the arrays go there when they fit, else to global scratch.
template <typename T>
cudaError_t plan(int n, int pad_width, size_t* bytes, size_t* limit) {
  Work<T> w;
  *bytes = carve<T>(n, capacity(n, pad_width), nullptr, w);
  return shared_limit(limit);
}

template <typename T>
const void* kernel_of(bool shared) {
  return shared ? reinterpret_cast<const void*>(&amfm_kernel<T, true>)
                : reinterpret_cast<const void*>(&amfm_kernel<T, false>);
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
  const T e = static_cast<T>(eps);
  if (in_shared) {
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel_of<T>(true), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(limit));
      if (err != cudaSuccess) return err;
    }
    amfm_kernel<T, true><<<rows, kThreads, bytes, stream>>>(t, X, n, n_iter, pad_width, e, A, F,
                                                            passes, nullptr, bytes);
  } else {
    amfm_kernel<T, false><<<rows, kThreads, 0, stream>>>(
        t, X, n, n_iter, pad_width, e, A, F, passes, static_cast<char*>(scratch), bytes);
  }
  return cudaGetLastError();
}

// The launch for `rows` rows of n samples on the current device, 8 ints:
// threads a block, rows a block, blocks, blocks an SM (the occupancy
// calculator's at the launch's dynamic shared memory), SMs, whether the
// arrays are in shared memory, bytes a row, waves.
template <typename T>
cudaError_t geometry(int n, int pad_width, int rows, int* out) {
  size_t bytes = 0, limit = 0;
  cudaError_t err = plan<T>(n, pad_width, &bytes, &limit);
  if (err != cudaSuccess) return err;
  const bool in_shared = bytes <= limit;
  const void* fn = kernel_of<T>(in_shared);
  if (in_shared)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(limit));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        in_shared ? bytes : 0);
  if (err != cudaSuccess) return err;
  const int slots = per_sm * sms;
  out[0] = kThreads;
  out[1] = 1;
  out[2] = rows;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = in_shared ? 1 : 0;
  out[6] = static_cast<int>(bytes);
  out[7] = slots > 0 ? (rows + slots - 1) / slots : 0;
  return cudaSuccess;
}

// Local memory and registers a thread and static shared memory a block of
// both instances: the arrays in shared memory, then in global scratch. 6
// ints.
template <typename T>
cudaError_t attributes(int* out) {
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, kernel_of<T>(i == 0));
    if (err != cudaSuccess) return err;
    out[3 * i] = static_cast<int>(fa.localSizeBytes);
    out[3 * i + 1] = fa.numRegs;
    out[3 * i + 2] = static_cast<int>(fa.sharedSizeBytes);
  }
  return cudaSuccess;
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

// the launch geometry (geometry above), 8 ints
int amfm_geometry(int n, int pad_width, int elem_size, int rows, int* out) {
  if (n < 1 || n > kMaxN || pad_width < 0 || rows < 1 || (elem_size != 4 && elem_size != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(elem_size == 8 ? geometry<double>(n, pad_width, rows, out)
                                         : geometry<float>(n, pad_width, rows, out));
}

// local memory and registers a thread and static shared memory a block of
// the kernel's two instances in the given element size (attributes above):
// 6 ints
int amfm_kernel_attributes(int elem_size, int* out) {
  if (elem_size == 4) return static_cast<int>(attributes<float>(out));
  if (elem_size == 8) return static_cast<int>(attributes<double>(out));
  return static_cast<int>(cudaErrorInvalidValue);
}

// the float32 quotient check above (a card test)
int amfm_quot_check_f32(unsigned long long n, int mode, unsigned long long* out,
                        cudaStream_t stream) {
  if (mode < 0 || mode > 3) return static_cast<int>(cudaErrorInvalidValue);
  quot_check_kernel<<<132 * 8, 256, 0, stream>>>(n, mode, out);
  return static_cast<int>(cudaGetLastError());
}

#ifdef AMFM_SPLIT
// the split buffer (kSplitRows x kSplitPasses x kSplitSlots long longs) to
// host memory
int amfm_split_read(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, amfm_split_buf, sizeof(amfm_split_buf)));
}
#endif

}  // extern "C"
