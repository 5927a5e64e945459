// EMD's whole sift loop for Hopper (sm_90a): S1. Plain C interface, loaded
// with ctypes by periodicity_tpu_torch/ops/_kernels.py; its wrapper and
// plain version are ops/emd.py::sift_machine / sift_machine_plain.
//
// It replaces no Pallas kernel. In the JAX package one IMF extraction is a
// lax.while_loop on the device (periodicity_tpu/ops/emd.py:238-263) and a
// batch is the pool's segment loop (:332-406), both compiled whole by XLA.
// In eager PyTorch one sift is several hundred launches (each PCR level of
// the two spline solves alone is ~25) and the loop needs a host read a
// step, so the whole state machine becomes one launch here.
//
// What it computes, per member b of Y [B, N] on the shared grid t [N]: the
// unified state machine of _emd_pool_segment's step (emd.py:354-373), run
// until the member is done. One step is one sift of the series being
// sifted (cur):
//   - the local maxima of cur and of -cur with scipy's plateau rule, and
//     the zero crossings (sign-bit changes);
//   - the upper and lower envelopes: the interior extrema, odd-reflected by
//     pad_width extrema about t[0] and t[N-1], as knots of a masked
//     not-a-knot cubic spline (first-derivative form, a tridiagonal solve
//     of capacity K = N/2 + 4 + 2 pad_width: parallel cyclic reduction at
//     K >= 32, the Thomas recursion below), evaluated at every sample;
//   - mu = (upper + lower)/2, sigma = |mu / ((upper - lower)/2)|, and the
//     IMF test on integer counts: #(sigma > theta_1) below the count limit
//     that JAX's float mean(.) < alpha gives (computed on the host), no
//     sigma >= theta_2, |zero crossings - extrema| <= 1;
//   - then subtract mu, or accept the mode (IMF, or max_iter sifts), or end
//     the member where it has too few extrema; after max_modes modes it is
//     done too.
// Outputs: modes [B, max_modes, N] (zeroed by the wrapper; slots past the
// member's count stay zero), residue [B, N], cur [B, N] (the series being
// sifted when the member ended), kmode [B] and units [B] (sifts made).
//
// What bounds it. A member is a chain of dependent sifts, hundreds to
// thousands of them, and each sift is a chain of dependent block-wide
// steps: two block scans, the knot scatter, the rows, ceil(log2 K) PCR
// levels (a division and 4 dependent operations each), the Hermite
// evaluation and two reductions. Bytes are few (the series in and the
// modes out, once). So the longest member's chain of dependent operations
// bounds the launch, not the bytes.
//
// What the design does about it. One thread block per member, 512
// threads, with the member's working arrays in dynamic shared memory: the
// whole chain runs with no global memory traffic and no host involvement,
// and members retire on their own (a block that is done exits), so the
// launch is the lane-retiring pool. Every block-wide step is one barrier or
// two. Where the arrays do not fit in the block's shared memory (float64 at
// N = 2048, 229 KB), they live in global scratch that the wrapper
// allocates, through the same code; they then stay in L2. With fewer
// members than SMs (config 10: 50 members on 132 SMs) most of the card
// idles: splitting a member over a cluster of blocks is the first thing a
// redesign looks at.
//
// The capacity buffers' filler knots past the valid count (emd.py:79-80,
// 142-144) never reach a result: the masked system makes their rows
// identity rows, the evaluation reads knots below the count only, and a
// sift with too few extrema (where the count is clamped up to 4 and the
// fillers would enter) changes nothing. So the kernel builds only the
// valid knots and skips the envelopes of such a sift.
//
// Every floating-point operation is rounded on its own (rn.cuh) in the
// order the plain version computes it, so kernel and plain version agree
// bit for bit: PyTorch's (1 - t) ** 2 is (1 - t) * (1 - t) on both devices,
// and the divisions by 2 are exact either as a division or as a product
// by 0.5.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "rn.cuh"

namespace {

using rn::Rn;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1 << 20;
// three counts of up to 21 bits packed into one 64-bit scan value
constexpr int kField = 21;
constexpr unsigned long long kFieldMask = (1ull << kField) - 1;
// smallest system PCR solves (the JAX package's _PCR_MIN_SIZE)
constexpr int kPcrMinSize = 32;

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~static_cast<size_t>(15); }

// One member's working arrays, carved from one byte range.
template <typename T>
struct Work {
  T* cur;                // [n] the series being sifted
  T* res;                // [n] the residue
  T* mu;                 // [n] the envelope mean of this sift
  long long* keys;       // [n] block-scan values
  unsigned char* flags;  // [n] bit 0 upper extremum, 1 lower, 2 zero crossing
  T* pt[2];              // [K] padded knot times, upper and lower envelope
  T* pv[2];              // [K] padded knot values
  T* sys[2][2][4];       // [envelope][buffer][a, b, c, d] [K] tridiagonal rows
};

// Points w's arrays into the byte range at base; returns its size in bytes.
template <typename T>
__host__ __device__ size_t carve(int n, int k, char* base, Work<T>& w) {
  size_t off = 0;
  auto at = [&](size_t bytes) {
    char* p = base + off;
    off += align16(bytes);
    return p;
  };
  w.cur = reinterpret_cast<T*>(at(sizeof(T) * n));
  w.res = reinterpret_cast<T*>(at(sizeof(T) * n));
  w.mu = reinterpret_cast<T*>(at(sizeof(T) * n));
  w.keys = reinterpret_cast<long long*>(at(sizeof(long long) * n));
  w.flags = reinterpret_cast<unsigned char*>(at(n));
  for (int e = 0; e < 2; ++e) {
    w.pt[e] = reinterpret_cast<T*>(at(sizeof(T) * k));
    w.pv[e] = reinterpret_cast<T*>(at(sizeof(T) * k));
    for (int s = 0; s < 2; ++s)
      for (int j = 0; j < 4; ++j) w.sys[e][s][j] = reinterpret_cast<T*>(at(sizeof(T) * k));
  }
  return off;
}

__host__ __device__ inline int capacity(int n, int pad_width) { return n / 2 + 4 + 2 * pad_width; }

// (hi, lo) 32-bit halves of a scan value
__device__ __forceinline__ long long pack2(int hi, int lo) {
  return static_cast<long long>((static_cast<unsigned long long>(static_cast<unsigned>(hi)) << 32) |
                                static_cast<unsigned>(lo));
}
__device__ __forceinline__ int hi32(long long v) { return static_cast<int>(v >> 32); }
__device__ __forceinline__ int lo32(long long v) {
  return static_cast<int>(static_cast<unsigned>(static_cast<unsigned long long>(v)));
}

struct PairMax {
  __device__ long long operator()(long long a, long long b) const {
    return pack2(max(hi32(a), hi32(b)), max(lo32(a), lo32(b)));
  }
};

struct Add {
  __device__ long long operator()(long long a, long long b) const { return a + b; }
};

// In-place inclusive scan of v[0, n) under op (associative), each thread a
// contiguous chunk; returns the total to every thread. Ends on a barrier.
template <typename Op>
__device__ long long block_scan(long long* v, int n, Op op, long long ident, long long* sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * per);
  const int hi = min(n, lo + per);
  long long acc = ident;
  for (int i = lo; i < hi; ++i) {
    acc = op(acc, v[i]);
    v[i] = acc;
  }
  long long x = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(y, x);
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < kWarps ? sh[lane] : ident;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = op(y, s);
    }
    if (lane < kWarps) sh[lane] = s;
  }
  __syncthreads();
  long long excl = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) excl = ident;
  if (warp > 0) excl = op(sh[warp - 1], excl);
  for (int i = lo; i < hi; ++i) v[i] = op(excl, v[i]);
  const long long total = sh[kWarps - 1];
  __syncthreads();
  return total;
}

// Sum of x over the block, to every thread. Ends on a barrier.
__device__ long long block_sum(long long x, long long* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = x;
  __syncthreads();
  long long total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += sh[w];
  __syncthreads();
  return total;
}

__device__ __forceinline__ int field(long long v, int f) {
  return static_cast<int>((static_cast<unsigned long long>(v) >> (kField * f)) & kFieldMask);
}

// Row i of envelope e's masked not-a-knot system over the knots (x, y)
// with c >= 4 valid ones (ops/spline.py::spline_derivatives, count given),
// as PCR's (a, b, c, d): a[0] = 0, c[k-1] = 0, identity rows past c.
template <typename T>
__device__ void spline_row(const T* x, const T* y, int c, int k, int i, T* a, T* b, T* cc,
                           T* d) {
  using R = Rn<T>;
  T lower, diag, upper, rhs;
  if (i >= c) {
    lower = T(0), diag = T(1), upper = T(0), rhs = T(0);
  } else if (i == c - 1) {
    const T dx_l = R::sub(x[c - 1], x[c - 2]);
    const T dx_m = R::sub(x[c - 2], x[c - 3]);
    const T sl_l = R::div(R::sub(y[c - 1], y[c - 2]), dx_l);
    const T sl_m = R::div(R::sub(y[c - 2], y[c - 3]), dx_m);
    const T dn = R::sub(x[c - 1], x[c - 3]);
    // (dx_l dx_l sl_m + (2 dn + dx_l) dx_m sl_l) / dn
    const T bn = R::div(R::add(R::mul(R::mul(dx_l, dx_l), sl_m),
                               R::mul(R::mul(R::add(R::mul(T(2), dn), dx_l), dx_m), sl_l)),
                        dn);
    lower = dn, diag = dx_m, upper = T(0), rhs = bn;
  } else if (i == 0) {
    const T dx0 = R::sub(x[1], x[0]);
    const T dx1 = R::sub(x[2], x[1]);
    const T s0 = R::div(R::sub(y[1], y[0]), dx0);
    const T s1 = R::div(R::sub(y[2], y[1]), dx1);
    const T d0 = R::sub(x[2], x[0]);
    // ((dx0 + 2 d0) dx1 s0 + dx0 dx0 s1) / d0
    const T b0 = R::div(R::add(R::mul(R::mul(R::add(dx0, R::mul(T(2), d0)), dx1), s0),
                               R::mul(R::mul(dx0, dx0), s1)),
                        d0);
    lower = T(0), diag = dx1, upper = d0, rhs = b0;
  } else {
    const T dxa = R::sub(x[i], x[i - 1]);  // dx[i-1]
    const T dxb = R::sub(x[i + 1], x[i]);  // dx[i]
    const T sa = R::div(R::sub(y[i], y[i - 1]), dxa);
    const T sb = R::div(R::sub(y[i + 1], y[i]), dxb);
    lower = dxb;
    diag = R::mul(T(2), R::add(dxa, dxb));
    upper = dxa;
    rhs = R::mul(T(3), R::add(R::mul(dxb, sa), R::mul(dxa, sb)));
  }
  *a = i == 0 ? T(0) : lower;
  *b = diag;
  *cc = i == k - 1 ? T(0) : upper;
  *d = rhs;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
emd_sift_kernel(const T* __restrict__ t, const T* __restrict__ Y, int n, int max_modes,
                int max_iter, int pad_width, T theta_1, T theta_2, int imf_limit,
                T* __restrict__ modes, T* __restrict__ residue_out, T* __restrict__ cur_out,
                int* __restrict__ kmode_out, int* __restrict__ units_out, char* scratch,
                size_t member_bytes) {
  using R = Rn<T>;
  extern __shared__ __align__(16) char smem[];
  __shared__ long long sh[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int w = pad_width;
  const int k = capacity(n, w);
  Work<T> W;
  carve<T>(n, k, scratch ? scratch + static_cast<size_t>(b) * member_bytes : smem, W);
  const T* y = Y + static_cast<size_t>(b) * n;
  for (int i = tid; i < n; i += kThreads) {
    W.cur[i] = y[i];
    W.res[i] = y[i];
  }
  const T t0 = t[0];
  const T tl = t[n - 1];
  int kmode = 0, it = 0, units = 0;
  bool done = n < 4;
  __syncthreads();

  while (!done) {
    // 1. plateau runs: forward cummax of the last change at or before i
    //    (high half) and, over the reversed index, of minus the first change
    //    at or after i (low half), as ops/peaks.py::local_maxima_info
    for (int p = tid; p < n; p += kThreads) {
      int kl = -1;
      if (p >= 1) {
        const T a = W.cur[p - 1], c = W.cur[p];
        const bool gt = c > a, lt = c < a;
        if (gt || lt) kl = 2 * p + (gt ? 1 : 0);
      }
      const int q = n - 1 - p;
      int kr = 2 * (n - 1) + 1;
      if (q <= n - 2) {
        const T a = W.cur[q], c = W.cur[q + 1];
        const bool gt = c > a, lt = c < a;
        if (gt || lt) kr = 2 * q + (lt ? 1 : 0);
      }
      W.keys[p] = pack2(kl, -kr);
    }
    __syncthreads();
    block_scan(W.keys, n, PairMax(), pack2(INT_MIN, INT_MIN), sh);
    // 2. maxima of cur (bit 0) and of -cur (bit 1), zero crossings (bit 2)
    for (int i = tid; i < n; i += kThreads) {
      const int vl = hi32(W.keys[i]);
      const int vr = -lo32(W.keys[n - 1 - i]);
      const bool has_l = vl >= 0;
      const int run_start = has_l ? (vl >> 1) : 0;
      const int run_end = vr >> 1;
      const bool mid = i == ((run_start + run_end) >> 1) && run_end <= n - 2 && has_l;
      const bool up = mid && (vl & 1) && (vr & 1);
      const bool lo = mid && !(vl & 1) && !(vr & 1);
      const bool zc = i < n - 1 && (signbit(W.cur[i + 1]) != signbit(W.cur[i]));
      W.flags[i] = static_cast<unsigned char>(up | (lo << 1) | (zc << 2));
    }
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const unsigned f = W.flags[i];
      W.keys[i] = static_cast<long long>((f & 1u) | (static_cast<unsigned long long>((f >> 1) & 1u)
                                                     << kField) |
                                         (static_cast<unsigned long long>((f >> 2) & 1u)
                                          << (2 * kField)));
    }
    __syncthreads();
    const long long total = block_scan(W.keys, n, Add(), 0, sh);
    const int n_int[2] = {field(total, 0), field(total, 1)};
    const int n_zero = field(total, 2);
    const int cnt[2] = {n_int[0] + 2 * w, n_int[1] + 2 * w};
    const bool ok = n_int[0] >= w && n_int[1] >= w && cnt[0] >= 4 && cnt[1] >= 4;

    bool is_imf = false;
    if (ok) {
      // 3. the padded knots: interior extremum j at slot w + j; the first w
      //    also reflected about t[0] to slot w-1-j, the last w about t[N-1]
      //    to slot 2 n_int + w - 1 - j (ops/emd.py::_pad_reflect_drop)
      for (int i = tid; i < n; i += kThreads) {
        const unsigned f = W.flags[i];
        if (!(f & 3u)) continue;
        const int e = (f & 1u) ? 0 : 1;
        const int j = field(W.keys[i], e) - 1;
        const T tv = t[i];
        const T v = e ? -W.cur[i] : W.cur[i];
        T* pt = W.pt[e];
        T* pv = W.pv[e];
        pt[w + j] = tv;
        pv[w + j] = v;
        if (j < w) {
          pt[w - 1 - j] = R::sub(R::mul(T(2), t0), tv);
          pv[w - 1 - j] = v;
        }
        if (j >= n_int[e] - w) {
          const int s = 2 * n_int[e] + w - 1 - j;
          pt[s] = R::sub(R::mul(T(2), tl), tv);
          pv[s] = v;
        }
      }
      __syncthreads();
      // 4. the two systems' rows into buffer 0
      for (int r = tid; r < 2 * k; r += kThreads) {
        const int e = r / k, i = r - e * k;
        T* const* s0 = W.sys[e][0];
        spline_row(W.pt[e], W.pv[e], cnt[e], k, i, &s0[0][i], &s0[1][i], &s0[2][i], &s0[3][i]);
      }
      __syncthreads();
      // 5. the knots' first derivatives
      const T* sd[2];
      if (k >= kPcrMinSize) {
        // PCR: level by level the coupling to rows i -+ s, out-of-range
        // rows as identity rows (ops/spline.py::tridiagonal_solve_pcr)
        int src = 0;
        for (int s = 1; s < k; s *= 2, src ^= 1) {
          for (int r = tid; r < 2 * k; r += kThreads) {
            const int e = r / k, i = r - e * k;
            T* const* in = W.sys[e][src];
            T* const* out = W.sys[e][src ^ 1];
            const T a = in[0][i], bb = in[1][i], c = in[2][i], d = in[3][i];
            const bool up = i >= s, dn = i + s < k;
            const T a_u = up ? in[0][i - s] : T(0), b_u = up ? in[1][i - s] : T(1);
            const T c_u = up ? in[2][i - s] : T(0), d_u = up ? in[3][i - s] : T(0);
            const T a_d = dn ? in[0][i + s] : T(0), b_d = dn ? in[1][i + s] : T(1);
            const T c_d = dn ? in[2][i + s] : T(0), d_d = dn ? in[3][i + s] : T(0);
            const T alpha = R::div(-a, b_u);
            const T beta = R::div(-c, b_d);
            out[0][i] = R::mul(alpha, a_u);
            out[2][i] = R::mul(beta, c_d);
            out[1][i] = R::add(R::add(bb, R::mul(alpha, c_u)), R::mul(beta, a_d));
            out[3][i] = R::add(R::add(d, R::mul(alpha, d_u)), R::mul(beta, d_d));
          }
          __syncthreads();
        }
        for (int r = tid; r < 2 * k; r += kThreads) {
          const int e = r / k, i = r - e * k;
          W.sys[e][src ^ 1][0][i] = R::div(W.sys[e][src][3][i], W.sys[e][src][1][i]);
        }
        sd[0] = W.sys[0][src ^ 1][0];
        sd[1] = W.sys[1][src ^ 1][0];
      } else {
        // Thomas, one thread a system (ops/spline.py::tridiagonal_solve)
        if (tid == 0 || tid == 32) {
          const int e = tid == 0 ? 0 : 1;
          T* const* in = W.sys[e][0];
          T* cp = W.sys[e][1][0];
          T* dp = W.sys[e][1][1];
          T* xs = W.sys[e][1][2];
          T cp_prev = T(0), dp_prev = T(0);
          for (int i = 0; i < k; ++i) {
            const T denom = R::sub(in[1][i], R::mul(in[0][i], cp_prev));
            dp_prev = R::div(R::sub(in[3][i], R::mul(in[0][i], dp_prev)), denom);
            cp_prev = R::div(in[2][i], denom);
            cp[i] = cp_prev;
            dp[i] = dp_prev;
          }
          T x_next = T(0);
          for (int i = k - 1; i >= 0; --i) {
            x_next = R::sub(dp[i], R::mul(cp[i], x_next));
            xs[i] = x_next;
          }
        }
        sd[0] = W.sys[0][1][2];
        sd[1] = W.sys[1][1][2];
      }
      __syncthreads();
      // 6. the envelopes at every sample (ops/spline.py::spline_eval with
      //    hi = pad_width + #extrema <= i), mu and sigma, and the counts
      long long gt = 0, not_lt = 0;
      for (int i = tid; i < n; i += kThreads) {
        const long long cs = W.keys[i];
        const T ti = t[i];
        T env[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int hi = w + field(cs, e);
          const int j = min(max(hi - 1, 0), cnt[e] - 2);
          const T* x = W.pt[e];
          const T* v = W.pv[e];
          const T x0 = x[j], x1 = x[j + 1], y0 = v[j], y1 = v[j + 1];
          const T s0 = sd[e][j], s1 = sd[e][j + 1];
          const T h = R::sub(x1, x0);
          const T u = R::div(R::sub(ti, x0), h);
          const T omu = R::sub(T(1), u);
          const T omu2 = R::mul(omu, omu);
          const T h00 = R::mul(R::add(T(1), R::mul(T(2), u)), omu2);
          const T h10 = R::mul(u, omu2);
          const T uu = R::mul(u, u);
          const T h01 = R::mul(uu, R::sub(T(3), R::mul(T(2), u)));
          const T h11 = R::mul(uu, R::sub(u, T(1)));
          env[e] = R::add(R::add(R::add(R::mul(h00, y0), R::mul(R::mul(h10, h), s0)),
                                 R::mul(h01, y1)),
                          R::mul(R::mul(h11, h), s1));
        }
        const T upper = env[0];
        const T lower = -env[1];
        const T mu = R::mul(R::add(upper, lower), T(0.5));
        const T amp = R::mul(R::sub(upper, lower), T(0.5));
        const T sigma = fabs(R::div(mu, amp));
        W.mu[i] = mu;
        gt += sigma > theta_1 ? 1 : 0;
        not_lt += sigma < theta_2 ? 0 : 1;
      }
      const long long counts = block_sum(gt | (not_lt << 32), sh);
      const int n_gt = static_cast<int>(counts & 0xffffffffll);
      const int n_not_lt = static_cast<int>(counts >> 32);
      const int gap = n_zero - (n_int[0] + n_int[1]);
      is_imf = n_gt < imf_limit && n_not_lt == 0 && gap <= 1 && gap >= -1;
    }

    // 7. the state machine's step (emd.py:354-373)
    const bool apply = ok && !is_imf;
    const int it1 = it + 1;
    const bool finished = !ok || is_imf || it1 >= max_iter;
    const bool accept = finished && ok;
    const int knext = kmode + (accept ? 1 : 0);
    const bool done_next = (finished && !ok) || knext >= max_modes;
    T* mode_row = modes + (static_cast<size_t>(b) * max_modes + kmode) * n;
    for (int i = tid; i < n; i += kThreads) {
      const T c = W.cur[i];
      const T nc = apply ? R::sub(c, W.mu[i]) : c;
      T r = W.res[i];
      if (accept) {
        mode_row[i] = nc;
        r = R::sub(r, nc);
        W.res[i] = r;
      }
      W.cur[i] = (finished && !done_next) ? r : nc;
    }
    kmode = knext;
    done = done_next;
    it = finished ? 0 : it1;
    ++units;
    __syncthreads();
  }

  T* res_row = residue_out + static_cast<size_t>(b) * n;
  T* cur_row = cur_out + static_cast<size_t>(b) * n;
  for (int i = tid; i < n; i += kThreads) {
    res_row[i] = W.res[i];
    cur_row[i] = W.cur[i];
  }
  if (tid == 0) {
    kmode_out[b] = kmode;
    units_out[b] = units;
  }
}

// Bytes of one member's arrays, and the dynamic shared memory a block may
// use on the current device (the opt-in limit less the static slots and a
// margin): the arrays go there when they fit, else to global scratch.
template <typename T>
cudaError_t plan(int n, int pad_width, size_t* bytes, size_t* shared_limit) {
  Work<T> w;
  *bytes = carve<T>(n, capacity(n, pad_width), nullptr, w);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *shared_limit = static_cast<size_t>(optin) - 1024;
  return cudaSuccess;
}

template <typename T>
cudaError_t emd_sift(const T* t, const T* Y, int n, int b, int max_modes, int max_iter,
                     int pad_width, double theta_1, double theta_2, int imf_limit, T* modes,
                     T* residue, T* cur, int* kmode, int* units, void* scratch,
                     cudaStream_t stream) {
  if (n < 1 || n > kMaxN || b < 1 || max_modes < 1 || max_iter < 1 || pad_width < 0)
    return cudaErrorInvalidValue;
  size_t bytes = 0, limit = 0;
  cudaError_t err = plan<T>(n, pad_width, &bytes, &limit);
  if (err != cudaSuccess) return err;
  const bool in_shared = bytes <= limit;
  if (!in_shared && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = in_shared ? bytes : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&emd_sift_kernel<T>),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(limit));
    if (err != cudaSuccess) return err;
  }
  emd_sift_kernel<T><<<b, kThreads, smem, stream>>>(
      t, Y, n, max_modes, max_iter, pad_width, static_cast<T>(theta_1), static_cast<T>(theta_2),
      imf_limit, modes, residue, cur, kmode, units,
      in_shared ? nullptr : static_cast<char*>(scratch), bytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Global scratch bytes one member needs: 0 where its arrays fit in a
// block's shared memory on the current device; minus a cudaError on error.
int emd_sift_scratch_bytes(int n, int pad_width, int elem_size) {
  if (n < 1 || n > kMaxN || pad_width < 0 || (elem_size != 4 && elem_size != 8))
    return -static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0, limit = 0;
  const cudaError_t err = elem_size == 8 ? plan<double>(n, pad_width, &bytes, &limit)
                                         : plan<float>(n, pad_width, &bytes, &limit);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return bytes <= limit ? 0 : static_cast<int>(bytes);
}

int emd_sift_f32(const float* t, const float* Y, int n, int b, int max_modes, int max_iter,
                 int pad_width, double theta_1, double theta_2, int imf_limit, float* modes,
                 float* residue, float* cur, int* kmode, int* units, void* scratch,
                 cudaStream_t stream) {
  return static_cast<int>(emd_sift<float>(t, Y, n, b, max_modes, max_iter, pad_width, theta_1,
                                          theta_2, imf_limit, modes, residue, cur, kmode, units,
                                          scratch, stream));
}

int emd_sift_f64(const double* t, const double* Y, int n, int b, int max_modes, int max_iter,
                 int pad_width, double theta_1, double theta_2, int imf_limit, double* modes,
                 double* residue, double* cur, int* kmode, int* units, void* scratch,
                 cudaStream_t stream) {
  return static_cast<int>(emd_sift<double>(t, Y, n, b, max_modes, max_iter, pad_width,
                                           theta_1, theta_2, imf_limit, modes, residue, cur,
                                           kmode, units, scratch, stream));
}

}  // extern "C"
