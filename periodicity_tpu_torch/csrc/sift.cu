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
// steps: the extrema's scans, the knot scatter, the two envelopes' solves
// (ceil(log2 cnt) PCR levels over the cnt valid knots, a division and 4
// dependent operations each), the Hermite evaluation and a reduction.
// Bytes are few (the series in and the modes out, once). So the longest
// member's chain of dependent operations bounds the launch, not the bytes.
//
// What the design does about it. One thread block per member, 512
// threads, with the member's working arrays in dynamic shared memory: the
// whole chain runs with no global memory traffic and no host involvement,
// and members retire on their own (a block that is done exits), so the
// launch is the lane-retiring pool. The extrema's scans are ballots and
// population counts a warp, three barriers a sift; each envelope's system
// is solved on its valid knots only, by one warp in registers where both
// have at most 64 (most sifts past a member's first mode), else by a group
// of warps an envelope; every floating-point division takes its fast path
// without a branch where the result is known to be the correctly rounded
// one. Where the arrays do not fit in the block's shared memory (float64
// above N ~ 2200; 211 KB at N = 2048), they live in global scratch that
// the wrapper allocates, through the same code; they then stay in L2.
// With fewer members than SMs most of the card idles, but a cluster
// barrier costs ~1200 cycles against ~45 for a block barrier on an H100,
// more than the N-wide stages it would spread save.
//
// The envelope stages (extrema, knots, the spline solve, the Hermite
// evaluation) live in envelope.cuh, which the AM/FM normalization kernel
// (amfm.cu, N1) shares. A sift with too few extrema (where the plain
// version clamps the knot count up to 4 and its filler knots would enter)
// changes nothing, so the kernel skips the envelopes of such a sift.
//
// Every floating-point operation is rounded on its own (rn.cuh) in the
// order the plain version computes it, so kernel and plain version agree
// bit for bit: PyTorch's (1 - t) ** 2 is (1 - t) * (1 - t) on both devices,
// and the divisions by 2 are exact either as a division or as a product
// by 0.5.

#include <cuda_runtime.h>

#include <cstddef>

#include "envelope.cuh"

namespace {

using namespace envelope;

// One member's working arrays, carved from one byte range.
template <typename T>
struct Work {
  T* cur;          // [n] the series being sifted
  T* res;          // [n] the residue
  T* mu;           // [n] the envelope mean of this sift
  Rounds<2> rd;    // the extrema of cur and of -cur, round by round
  Knots<T, 2> kn;  // the upper and lower envelope's knots and rows
};

// Points w's arrays into the byte range at base; returns its size in bytes.
template <typename T>
__host__ __device__ size_t carve(int n, int k, char* base, Work<T>& w) {
  Carve c{base};
  w.cur = c.take<T>(n);
  w.res = c.take<T>(n);
  w.mu = c.take<T>(n);
  carve_rounds(c, n, w.rd);
  carve_knots(c, k, w.kn);
  return c.off;
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
  __shared__ WarpTotals wt;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nr = rounds(n);
  const int r0 = (tid >> 5) * nr;
  const int w = pad_width;
  const int k = capacity(n, w);
  Work<T> W;
  carve<T>(n, k, scratch ? scratch + static_cast<size_t>(b) * member_bytes : smem, W);
  const T* y = Y + static_cast<size_t>(b) * n;
  for (int i = tid; i < n; i += kThreads) {
    W.cur[i] = y[i];
    W.res[i] = y[i];
  }
  int kmode = 0, it = 0, units = 0;
  bool done = n < 4;
  __syncthreads();

  while (!done) {
    // 1-2. the maxima of cur and of -cur, the zero crossings and their
    //      running counts
    const Extrema<2> ex = extrema(W.cur, n, W.rd, wt);
    const int n_int[2] = {ex.count[0], ex.count[1]};
    const int cnt[2] = {n_int[0] + 2 * w, n_int[1] + 2 * w};
    const bool ok = n_int[0] >= w && n_int[1] >= w && cnt[0] >= 4 && cnt[1] >= 4;

    bool is_imf = false;
    if (ok) {
      // 3-5. the padded knots, the two systems and the knots' derivatives
      place_knots(t, W.cur, n, w, W.rd, ex, W.kn);
      const T* sd[2];
      solve_derivatives(cnt, k, W.kn, sd);
      // 6. the envelopes at every sample (ops/spline.py::spline_eval with
      //    hi = pad_width + #extrema <= i), mu and sigma, and the counts
      long long gt = 0, not_lt = 0;
      for (int r = r0; r < r0 + nr; ++r) {
        const int i = 32 * r + lane;
        if (i >= n) break;
        const T ti = t[i];
        const T upper = hermite(W.kn.pt(0), W.kn.pv(0), sd[0], w + count_at(W.rd, ex, 0, r, lane),
                                cnt[0], ti);
        const T lower = -hermite(W.kn.pt(1), W.kn.pv(1), sd[1],
                                 w + count_at(W.rd, ex, 1, r, lane), cnt[1], ti);
        const T mu = R::mul(R::add(upper, lower), T(0.5));
        const T amp = R::mul(R::sub(upper, lower), T(0.5));
        const T sigma = fabs(quot(mu, amp));
        W.mu[i] = mu;
        gt += sigma > theta_1 ? 1 : 0;
        not_lt += sigma < theta_2 ? 0 : 1;
      }
      const long long counts = block_sum(gt | (not_lt << 32), sh);
      const int n_gt = static_cast<int>(counts & 0xffffffffll);
      const int n_not_lt = static_cast<int>(counts >> 32);
      const int gap = ex.zero - (n_int[0] + n_int[1]);
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
cudaError_t plan(int n, int pad_width, size_t* bytes, size_t* limit) {
  Work<T> w;
  *bytes = carve<T>(n, capacity(n, pad_width), nullptr, w);
  return shared_limit(limit);
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

// envelope.cuh::quot in float32 against __fdiv_rn on n operand pairs, to
// the bit pattern: mode 0 hashed bit patterns, 1 the same inside quot's
// exponent window, 2 zero numerators, 3 and 4 every divisor of the window
// (n = 121 2^23) over the numerators 1 and 1.75. out[0] gets the pairs
// that differ, out[1] those on the fast path.
__global__ void quot_check_kernel(unsigned long long n, int mode, unsigned long long* out) {
  unsigned long long bad = 0, fast = 0;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * static_cast<unsigned long long>(blockDim.x) + threadIdx.x;
       i < n; i += stride) {
    const unsigned long long h = rn::mix(i * 8 + mode);
    unsigned ua = static_cast<unsigned>(h), ud = static_cast<unsigned>(h >> 32);
    if (mode == 1) {
      ua = (ua & 0x807fffffu) | (((ua >> 23) & 0xffu) % 121u + 67u) << 23;
      ud = (ud & 0x807fffffu) | (((ud >> 23) & 0xffu) % 121u + 67u) << 23;
    } else if (mode == 2) {
      ua &= 0x80000000u;
    } else if (mode >= 3) {
      ua = mode == 3 ? 0x3f800000u : 0x3fe00000u;
      ud = static_cast<unsigned>(((i >> 23) + 67u) << 23 | (i & 0x7fffffu));
    }
    const float a = __uint_as_float(ua), d = __uint_as_float(ud);
    bool exact;
    quot_fast(a, d, &exact);
    fast += exact ? 1 : 0;
    bad += __float_as_uint(quot(a, d)) != __float_as_uint(__fdiv_rn(a, d)) ? 1 : 0;
  }
  atomicAdd(out, bad);
  atomicAdd(out + 1, fast);
}

}  // namespace

extern "C" {

int emd_sift_quot_check_f32(unsigned long long n, int mode, unsigned long long* out,
                            cudaStream_t stream) {
  quot_check_kernel<<<132 * 8, 256, 0, stream>>>(n, mode, out);
  return static_cast<int>(cudaGetLastError());
}

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
