// Two sequential recursions for Hopper (sm_90a): the cascaded second-order
// IIR filter (R1) and the pentadiagonal LDL^T solve of the smoothing spline
// (R2). Plain C interface, loaded with ctypes by
// periodicity_tpu_torch/ops/_kernels.py.
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
// What bounds them on the card. Each step depends on the one before: at the
// SpottedStar shapes (m = 2146 unknowns, ~2,200 filter steps) a launch moves
// tens of kilobytes, a few hundredths of a microsecond at 3.35 TB/s, while
// its chain of dependent operations takes tens of microseconds at the
// latency of one dependent floating-point operation. The chain binds, not
// the bytes; so the design keeps everything else off the chain: loads,
// stores, the slow path of a division, and the work of other sections.
//
// R1, the filter. A row is a group of W lanes (W the power of two at or
// above the section count NS <= 16; 32 / W rows a warp, a warp a block),
// lane s holding section s's coefficients and state in registers: a
// systolic cascade. At tick t lane s takes step t - kLag s; its input is
// lane s - 1's output of that step, passed by __shfl_up_sync at the tick
// after it was made and used kLag - 1 ticks later, so the shuffle's latency
// is off the state's chain of 4 dependent operations a step. Lane 0 reads
// x, from registers loaded four ticks ahead. A tick outside a lane's steps
// (the ramp at either end) leaves its state alone, so the state after step
// n - 1 is zf. The warp stages a chunk of each row's x in shared memory (16
// ticks at one lane a row, 32 at 2 and 4, 64 at 8, 128 at 16; the next
// chunk waits in registers while this one runs), and the last lane's outputs go through a shared
// tile to one coalesced store a chunk. Chunks where every section is inside
// its steps run without the masks.
//
// R2, the solve. One block of four warps: thread 0 of warp 0 (the walker)
// runs the factor's chain, D_k and the quotients alpha_{k+1}, beta_{k+2};
// thread 0 of warp 1 (the trailer) follows a tile behind with z_k and zd_k,
// which the chain does not need; warps 2 and 3 stage the operands in tiles
// of kTile rows into a ring of slots in dynamic shared memory with
// cp.async, ahead of the walker, and drain the results. A flag a slot for
// each hand-over (ready: staged; walked: factored; done: zd, then x)
// orders them. The walkers read and write shared memory only. Row k's
// operands sit at index k of a slot (main_k, rhs_k, off1_k = b_{k+1},
// off2_k = c_{k+2}), and its results overwrite them in place: D_k over
// main_k, alpha_{k+1} over off1_k, beta_{k+2} over off2_k, zd_k over rhs_k,
// then x_k over zd_k in the backward pass. Four arrays: a system of up to
// 56 (float64) or 112 (float32) tiles, 7,168 or 14,336 rows on an H100,
// stays in shared memory from the first load to the coalesced store of x.
// Past that the ring wraps: a slot's forward results go to the global
// scratch (alpha, beta) and to out (zd) before the slot takes the next
// tile; the backward pass starts on the tiles still resident and the
// stagers bring the earlier ones back, in tiles, ahead of it.
//
// R2's divisions. Each pivot D_k divides alpha_{k+1} (on the chain to
// D_{k+1}), beta_{k+2} and zd_k. When D_k is ready the walker forms one
// reciprocal and its two quotients as rn::Checked, each refined by fused
// multiply-adds and accepted only when its residual proves it correctly
// rounded (rn.cuh states the proof); alpha's is refined from the estimate
// while the reciprocal forms (quot_short), two dependent steps fewer. No
// branch is taken per row: the acceptances of a tile are anded, and a tile
// with a rejected quotient (a zero pivot or numerator, an operand outside
// the window, a refinement one unit off) is walked again from its saved
// state with __ddiv_rn / __fdiv_rn and the zero-pivot guards, its operands
// read from global memory. The trailer does the same for zd. On an H100 at
// m = 2146 the walker's row takes ~120-140 cycles against a chain of ~90
// (a reciprocal estimate, 4 dependent fused multiply-adds and the pivot's 4
// operations); before this design each row waited on three __ddiv_rn.
//
// Every product, sum, difference and quotient is rounded on its own
// (__dmul_rn, __dadd_rn, __dsub_rn, correctly rounded quotients; __f*_rn in
// float32) in the order the plain versions (ops/filters.py::sosfilt_plain,
// ops/spline.py::pentadiagonal_solve_plain) and the JAX scans use, so nvcc
// cannot contract a pair into an FMA: kernel and plain version agree bit for
// bit. The zero-pivot guards of the JAX factor (D == 0 -> 0) are kept.

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <type_traits>

#include "rn.cuh"

namespace {

using rn::Rn;

constexpr unsigned kFull = 0xffffffffu;

// -- R1: the cascaded biquad filter -----------------------------------------

constexpr int kMaxSections = 16;
constexpr int kLag = 2;  // ticks between a section's step and the next's

// ticks a chunk of x and y at W lanes a row: every lane holds 8 of a
// chunk's inputs (16 at W <= 2) while the chunk before runs
__host__ __device__ constexpr int chunk_ticks(int W) { return W >= 8 ? 8 * W : W == 1 ? 16 : 32; }

// (b0, b1, b2, a1, a2) of every section, normalized by a0: at most 640
// bytes of kernel parameters in float64
template <typename T>
struct Coefficients {
  T v[5 * kMaxSections];
};

// One row of the cascade, direct form II transposed, per step and section:
//   out = b0 v + z0;  z0 = (b1 v - a1 out) + z1;  z1 = b2 v - a2 out;  v = out
// coef: (b0, b1, b2, a1, a2) of each of the ns sections, normalized by a0;
// x, y [rows, n]; zi, zf [rows, ns, 2]. W lanes a row, ns <= W.
template <typename T, int W>
__global__ void __launch_bounds__(32)
sosfilt_kernel(const Coefficients<T> coef, const T* __restrict__ x,
               const T* __restrict__ zi, int n, int ns, int rows, T* __restrict__ y,
               T* __restrict__ zf) {
  using R = Rn<T>;
  constexpr int kRows = 32 / W;
  constexpr int kTicks = chunk_ticks(W);
  constexpr int kPre = kRows * kTicks / 32;
  __shared__ T xs[kRows][kTicks + 1];
  __shared__ T ys[kRows][kTicks + 1];
  const int lane = threadIdx.x;
  const int s = lane % W;
  const int g = lane / W;
  const int row0 = blockIdx.x * kRows;
  const bool live = s < ns && row0 + g < rows;
  T b0 = T(0), b1 = T(0), b2 = T(0), a1 = T(0), a2 = T(0), z0 = T(0), z1 = T(0);
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k == s && k < ns) {
      b0 = coef.v[5 * k];
      b1 = coef.v[5 * k + 1];
      b2 = coef.v[5 * k + 2];
      a1 = coef.v[5 * k + 3];
      a2 = coef.v[5 * k + 4];
    }
  if (live) {
    z0 = zi[(static_cast<size_t>(row0 + g) * ns + s) * 2];
    z1 = zi[(static_cast<size_t>(row0 + g) * ns + s) * 2 + 1];
  }
  // the last section's step at tick t is t - shift
  const int shift = (ns - 1) * kLag;
  const int chunks = n > 0 ? (n + shift + kTicks - 1) / kTicks : 0;
  // this lane's share of chunk c's x: element lane + 32 i of the chunk's
  // kRows x kTicks, row by row
  T pre[kPre];
  auto fetch = [&](int c) {
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int e = lane + 32 * i, j = e / kTicks, col = c * kTicks + e % kTicks;
      pre[i] = row0 + j < rows && col < n ? x[static_cast<size_t>(row0 + j) * n + col] : T(0);
    }
  };
  auto park = [&]() {
#pragma unroll
    for (int i = 0; i < kPre; ++i) xs[(lane + 32 * i) / kTicks][(lane + 32 * i) % kTicks] = pre[i];
  };
  fetch(0);
  park();
  __syncwarp();
  fetch(1);

  T last = T(0);     // this lane's output at the tick before
  T held[kLag];      // received from the lane before, oldest first
#pragma unroll
  for (int k = 0; k < kLag; ++k) held[k] = T(0);
  auto run = [&](int t0, auto masked) {
    // x four ticks ahead of its use
    T xcur[4], xnext[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xcur[i] = xs[g][i];
#pragma unroll
    for (int k = 0; k < kTicks; ++k) {
      if (k % 4 == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) xnext[i] = xs[g][k + 4 + i < kTicks ? k + 4 + i : kTicks - 1];
      }
      T got = last;
      if constexpr (W > 1) got = __shfl_up_sync(kFull, last, 1, W);
#pragma unroll
      for (int h = 0; h + 1 < kLag; ++h) held[h] = held[h + 1];
      held[kLag - 1] = got;
      // the lane before made held[0] kLag ticks ago: this lane's step
      const T v = s == 0 ? xcur[k % 4] : held[0];
      const T out = R::add(R::mul(b0, v), z0);
      const T n0 = R::add(R::sub(R::mul(b1, v), R::mul(a1, out)), z1);
      const T n1 = R::sub(R::mul(b2, v), R::mul(a2, out));
      if constexpr (decltype(masked)::value) {
        const int u = t0 + k - s * kLag;
        const bool step = u >= 0 && u < n;
        z0 = step ? n0 : z0;
        z1 = step ? n1 : z1;
      } else {
        z0 = n0;
        z1 = n1;
      }
      last = out;
      if (s == ns - 1) ys[g][k] = out;
      if (k % 4 == 3) {
#pragma unroll
        for (int i = 0; i < 4; ++i) xcur[i] = xnext[i];
      }
    }
  };
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * kTicks;
    if (t0 >= shift && t0 + kTicks <= n)
      run(t0, std::false_type{});
    else
      run(t0, std::true_type{});
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int e = lane + 32 * i, j = e / kTicks, u = t0 + e % kTicks - shift;
      if (row0 + j < rows && u >= 0 && u < n)
        y[static_cast<size_t>(row0 + j) * n + u] = ys[j][e % kTicks];
    }
    park();
    __syncwarp();
    fetch(c + 2);
  }
  if (live) {
    zf[(static_cast<size_t>(row0 + g) * ns + s) * 2] = z0;
    zf[(static_cast<size_t>(row0 + g) * ns + s) * 2 + 1] = z1;
  }
}

// a warp a block, 32 / W rows a warp
template <typename T, int W>
cudaError_t launch_sosfilt(const Coefficients<T>& coef, const T* x, const T* zi, int n, int ns,
                           int rows, T* y, T* zf, cudaStream_t stream) {
  constexpr int kRows = 32 / W;
  sosfilt_kernel<T, W><<<(rows + kRows - 1) / kRows, 32, 0, stream>>>(coef, x, zi, n, ns, rows,
                                                                       y, zf);
  return cudaGetLastError();
}

// coef_host: [ns, 5] in host memory, copied into the launch's parameters
template <typename T>
cudaError_t sosfilt(const T* coef_host, const T* x, const T* zi, int n, int ns, int rows, T* y,
                    T* zf, cudaStream_t stream) {
  if (n < 0 || rows < 1 || ns < 1 || ns > kMaxSections) return cudaErrorInvalidValue;
  Coefficients<T> coef = {};
  for (int i = 0; i < 5 * ns; ++i) coef.v[i] = coef_host[i];
  if (ns == 1) return launch_sosfilt<T, 1>(coef, x, zi, n, ns, rows, y, zf, stream);
  if (ns == 2) return launch_sosfilt<T, 2>(coef, x, zi, n, ns, rows, y, zf, stream);
  if (ns <= 4) return launch_sosfilt<T, 4>(coef, x, zi, n, ns, rows, y, zf, stream);
  if (ns <= 8) return launch_sosfilt<T, 8>(coef, x, zi, n, ns, rows, y, zf, stream);
  return launch_sosfilt<T, 16>(coef, x, zi, n, ns, rows, y, zf, stream);
}

static_assert(kMaxSections == 16, "the widest group is 16 lanes");

// -- R2: the pentadiagonal solve ---------------------------------------------

constexpr int kTile = 128;   // rows a slot
constexpr int kStagers = 2;  // warps staging and draining tiles
constexpr int kPentaThreads = 32 * (2 + kStagers);
constexpr int kMaxSlots = 128;

// One slot of the ring: row k0 + j's operands at j, overwritten in place by
// its results (a: main -> D; r: rhs -> zd -> x; b: off1 -> alpha_{k+1};
// c: off2 -> beta_{k+2}). One array with two spare elements, so a walk
// reads two rows past either end of a part without a bound: its loads then
// differ from its stores by constant offsets, and ptxas issues them ahead
// instead of after the stores before them.
template <typename T>
struct Slot {
  T v[4 * kTile + 2];
  __device__ T& a(int j) { return v[j]; }
  __device__ T& r(int j) { return v[kTile + j]; }
  __device__ T& b(int j) { return v[2 * kTile + j]; }
  __device__ T& c(int j) { return v[3 * kTile + j]; }
};

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

// src[k] into dst for k < len, pad past it
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int k, int len, T pad) {
  if (k < len)
    copy_async(dst, src + k);
  else
    *dst = pad;
}

// this warp's copies have landed: publish them to the block under flag
__device__ __forceinline__ void publish(int* flag, int ticket) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __threadfence_block();
  __syncwarp();
  if (threadIdx.x % 32 == 0) *reinterpret_cast<volatile int*>(flag) = ticket;
}

// until flag reaches ticket
__device__ __forceinline__ void await(const int* flag, int ticket) {
  while (*reinterpret_cast<const volatile int*>(flag) < ticket) {
  }
  __threadfence_block();
}

// one thread's writes before it, published under flag
__device__ __forceinline__ void signal(int* flag, int ticket) {
  __threadfence_block();
  *reinterpret_cast<volatile int*>(flag) = ticket;
}

// The symmetric pentadiagonal system with diagonals main [m], off1 [m-1],
// off2 [m-2] and right-hand side rhs [m]. Per row i, with b_i = off1[i-1],
// c_i = off2[i-2] (0 before the bands start):
//   beta_i  = D_{i-2} != 0 ? c_i / D_{i-2} : 0
//   alpha_i = D_{i-1} != 0 ? (b_i - (beta_i alpha_{i-1}) D_{i-2}) / D_{i-1} : 0
//   D_i     = (a_i - (alpha_i alpha_i) D_{i-1}) - (beta_i beta_i) D_{i-2}
//   z_i     = (r_i - alpha_i z_{i-1}) - beta_i z_{i-2};   zd_i = z_i / D_i
// then backwards x_i = (zd_i - alpha_{i+1} x_{i+1}) - beta_{i+2} x_{i+2}.
// The walker takes row k's quotients over D_k at row k, alpha_{k+1} and
// beta_{k+2}; the trailer, a tile behind, z_k and zd_k = z_k / D_k. `slots` slots of
// the ring; past them, alpha and beta go to scratch [2m] and zd to out,
// which ends as x.
template <typename T>
__global__ void __launch_bounds__(kPentaThreads)
pentadiagonal_kernel(const T* __restrict__ main_d, const T* __restrict__ off1,
                     const T* __restrict__ off2, const T* __restrict__ rhs, int m, int slots,
                     T* __restrict__ scratch, T* __restrict__ out) {
  using R = Rn<T>;
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  Slot<T>* ring = reinterpret_cast<Slot<T>*>(ring_bytes);
  // tickets: tile t's forward pass is t + 1, its backward pass 2 nt - t.
  // ready: staged; walked: the factor's row results in the slot; done:
  // zd in the slot (forward), x (backward)
  __shared__ int ready[kMaxSlots], walked[kMaxSlots], done[kMaxSlots];
  for (int i = threadIdx.x; i < slots; i += blockDim.x) ready[i] = walked[i] = done[i] = 0;
  __syncthreads();
  const int nt = (m + kTile - 1) / kTile;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const T zero = T(0);

  if (warp == 0) {
    if (lane != 0) return;
    // forward: the factor, D and the quotients alpha, beta
    T D1 = zero, D2 = zero, al = zero, be = zero, be1 = zero;
    for (int t = 0; t < nt; ++t) {
      Slot<T>& sl = ring[t % slots];
      await(&ready[t % slots], t + 1);
      const int k0 = t * kTile;
      const int len = min(kTile, m - k0);
      const T sD1 = D1, sD2 = D2, sal = al, sbe = be, sbe1 = be1;
      bool ok = true;
      // the operands of the next two rows, read ahead of their use
      T a1 = sl.a(0), b1 = sl.b(0), c1 = sl.c(0);
      T a2 = sl.a(1), b2 = sl.b(1), c2 = sl.c(1);
#pragma unroll 4
      for (int j = 0; j < len; ++j) {
        const T a = a1, b = b1, c = c1;
        a1 = a2, b1 = b2, c1 = c2;
        a2 = sl.a(j + 2), b2 = sl.b(j + 2), c2 = sl.c(j + 2);
        const T D = R::sub(R::sub(a, R::mul(R::mul(al, al), D1)), R::mul(R::mul(be, be), D2));
        const T num = R::sub(b, R::mul(R::mul(be1, al), D1));
        const rn::Checked<T> div(D);
        const T al_next = div.quot_short(num, ok);
        const T be_next = div.quot(c, ok);
        sl.a(j) = D;
        sl.b(j) = al_next;
        sl.c(j) = be_next;
        D2 = D1;
        D1 = D;
        al = al_next;
        be = be1;
        be1 = be_next;
      }
      if (!ok) {  // again with the divisions and the zero-pivot guards
        D1 = sD1, D2 = sD2, al = sal, be = sbe, be1 = sbe1;
        for (int j = 0; j < len; ++j) {
          const int k = k0 + j;
          const T a = main_d[k];
          const T b = k < m - 1 ? off1[k] : zero;
          const T c = k < m - 2 ? off2[k] : zero;
          const T D = R::sub(R::sub(a, R::mul(R::mul(al, al), D1)), R::mul(R::mul(be, be), D2));
          const T num = R::sub(b, R::mul(R::mul(be1, al), D1));
          const T al_next = D != zero ? R::div(num, D) : zero;
          const T be_next = D != zero ? R::div(c, D) : zero;
          sl.a(j) = D;
          sl.b(j) = al_next;
          sl.c(j) = be_next;
          D2 = D1;
          D1 = D;
          al = al_next;
          be = be1;
          be1 = be_next;
        }
      }
      signal(&walked[t % slots], t + 1);
    }
    // the trailer's last tile, then alpha_m, beta_m and beta_{m+1} are 0
    // (the last two tiles are resident)
    await(&done[(nt - 1) % slots], nt);
    ring[(m - 1) / kTile % slots].b((m - 1) % kTile) = zero;
    ring[(m - 1) / kTile % slots].c((m - 1) % kTile) = zero;
    if (m >= 2) ring[(m - 2) / kTile % slots].c((m - 2) % kTile) = zero;
    // backward: x over zd
    T x1 = zero, x2 = zero;
    for (int t = nt - 1; t >= 0; --t) {
      Slot<T>& sl = ring[t % slots];
      if (t < nt - slots) await(&ready[t % slots], 2 * nt - t);
      const int len = min(kTile, m - t * kTile);
      T r1 = sl.r(len - 1), b1 = sl.b(len - 1), c1 = sl.c(len - 1);
      T r2 = sl.r(len - 2), b2 = sl.b(len - 2), c2 = sl.c(len - 2);
#pragma unroll 4
      for (int j = len - 1; j >= 0; --j) {
        const T zd = r1, an = b1, bn = c1;
        r1 = r2, b1 = b2, c1 = c2;
        r2 = sl.r(j - 2), b2 = sl.b(j - 2), c2 = sl.c(j - 2);
        const T xv = R::sub(R::sub(zd, R::mul(an, x1)), R::mul(bn, x2));
        sl.r(j) = xv;
        x2 = x1;
        x1 = xv;
      }
      signal(&done[t % slots], 2 * nt - t);
    }
    return;
  }

  if (warp == 1) {
    if (lane != 0) return;
    // the trailer: z and zd a tile behind the walker
    T z1 = zero, z2 = zero, al = zero, be = zero, be1 = zero;
    for (int t = 0; t < nt; ++t) {
      Slot<T>& sl = ring[t % slots];
      await(&walked[t % slots], t + 1);
      const int k0 = t * kTile;
      const int len = min(kTile, m - k0);
      const T sz1 = z1, sz2 = z2, sal = al, sbe = be, sbe1 = be1;
      bool ok = true;
#pragma unroll 4
      for (int j = 0; j < len; ++j) {
        const T z = R::sub(R::sub(sl.r(j), R::mul(al, z1)), R::mul(be, z2));
        const rn::Checked<T> div(sl.a(j));
        sl.r(j) = div.quot(z, ok);
        z2 = z1;
        z1 = z;
        al = sl.b(j);
        be = be1;
        be1 = sl.c(j);
      }
      if (!ok) {  // again with the division
        z1 = sz1, z2 = sz2, al = sal, be = sbe, be1 = sbe1;
        for (int j = 0; j < len; ++j) {
          const T z = R::sub(R::sub(rhs[k0 + j], R::mul(al, z1)), R::mul(be, z2));
          sl.r(j) = R::div(z, sl.a(j));
          z2 = z1;
          z1 = z;
          al = sl.b(j);
          be = be1;
          be1 = sl.c(j);
        }
      }
      signal(&done[t % slots], t + 1);
    }
    return;
  }

  // the stagers: warp 2 + p takes the tiles t = p (mod kStagers)
  const int p = warp - 2;
  T* alpha = scratch;
  T* beta = scratch + m;
  for (int t = p; t < nt; t += kStagers) {
    Slot<T>& sl = ring[t % slots];
    if (t >= slots) {  // the slot's forward results out first
      const int u = t - slots;
      await(&done[t % slots], u + 1);
      for (int j = lane; j < kTile; j += 32) {
        const int k = u * kTile + j;  // a full tile: u < nt - 1
        alpha[k] = sl.b(j);
        beta[k] = sl.c(j);
        out[k] = sl.r(j);
      }
      __syncwarp();
    }
    for (int j = lane; j < kTile; j += 32) {
      const int k = t * kTile + j;
      // 1 past the bands: the quotients alpha_m, beta_m, beta_{m+1} it
      // gives pass the test (a zero numerator would not) and are then
      // replaced by 0
      stage(&sl.a(j), main_d, k, m, T(0));
      stage(&sl.r(j), rhs, k, m, T(0));
      stage(&sl.b(j), off1, k, m - 1, T(1));
      stage(&sl.c(j), off2, k, m - 2, T(1));
    }
    publish(&ready[t % slots], t + 1);
  }
  // backward: tiles before the resident ones come back from scratch and out
  for (int t = nt - slots - 1; t >= 0; --t) {
    if (t % kStagers != p) continue;
    Slot<T>& sl = ring[t % slots];
    const int u = t + slots;  // the slot's tile, walked backward: x out
    await(&done[t % slots], 2 * nt - u);
    for (int j = lane; j < min(kTile, m - u * kTile); j += 32) out[u * kTile + j] = sl.r(j);
    __syncwarp();
    for (int j = lane; j < kTile; j += 32) {
      const int k = t * kTile + j;
      copy_async(&sl.b(j), alpha + k);
      copy_async(&sl.c(j), beta + k);
      copy_async(&sl.r(j), out + k);
    }
    publish(&ready[t % slots], 2 * nt - t);
  }
  for (int t = p; t < min(slots, nt); t += kStagers) {
    Slot<T>& sl = ring[t];
    await(&done[t], 2 * nt - t);
    for (int j = lane; j < min(kTile, m - t * kTile); j += 32) out[t * kTile + j] = sl.r(j);
  }
}

// The ring's slots on the current device: as many as the block's opt-in
// shared memory holds (at most kMaxSlots), the kernel's limit raised to it
// once a device.
template <typename T>
cudaError_t ring_slots(int* slots) {
  static std::mutex mu;
  static std::map<int, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(dev);
  if (it == cache.end()) {
    const void* fn = reinterpret_cast<const void*>(&pentadiagonal_kernel<T>);
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, fn);
    if (err != cudaSuccess) return err;
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    const int n =
        (optin - static_cast<int>(fa.sharedSizeBytes)) / static_cast<int>(sizeof(Slot<T>));
    if (n < 2) return cudaErrorInvalidConfiguration;
    const int use = n < kMaxSlots ? n : kMaxSlots;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               use * static_cast<int>(sizeof(Slot<T>)));
    if (err != cudaSuccess) return err;
    it = cache.emplace(dev, use).first;
  }
  *slots = it->second;
  return cudaSuccess;
}

// scratch: [2m], used where the system does not fit the ring
template <typename T>
cudaError_t pentadiagonal_solve(const T* main_d, const T* off1, const T* off2, const T* rhs,
                                int m, T* scratch, T* out, cudaStream_t stream) {
  if (m < 1) return cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t err = ring_slots<T>(&cap);
  if (err != cudaSuccess) return err;
  const int nt = (m + kTile - 1) / kTile;
  const int slots = nt < cap ? nt : cap;
  pentadiagonal_kernel<T><<<1, kPentaThreads, slots * sizeof(Slot<T>), stream>>>(
      main_d, off1, off2, rhs, m, slots, scratch, out);
  return cudaGetLastError();
}

// -- card checks ---------------------------------------------------------------

template <typename T>
struct Bits;

template <>
struct Bits<float> {
  using U = unsigned;
  static constexpr int kFrac = 23, kBias = 127, kExpMax = 254;
  static __device__ float of(U u) { return __uint_as_float(u); }
  static __device__ U to(float v) { return __float_as_uint(v); }
};

template <>
struct Bits<double> {
  using U = unsigned long long;
  static constexpr int kFrac = 52, kBias = 1023, kExpMax = 2046;
  static __device__ double of(U u) { return __longlong_as_double(static_cast<long long>(u)); }
  static __device__ U to(double v) { return static_cast<U>(__double_as_longlong(v)); }
};

// rn::Checked<T>'s quotients (quot and quot_short), and Rn<T>::div where
// one is rejected, against Rn<T>::div on n operand pairs, to the bit
// pattern. Modes: 0 hashed bit
// patterns; 1 hashed pairs inside the window; 2 hashed numerators over the
// divisors at every binade edge 2^k, k over every normal exponent: 2^k,
// 2^k (1 + 2^-p), 2^k (1 + 2^(1-p)) and, from the binade below, 2^k (1 -
// 2^-(p+1)), 2^k (1 - 2^-p), 2^k (1 - 2^(3-p)) (p = 23 or 52 fraction bits:
// in float64 1 +- 2^-52, 1 - 2^-49, and 16 - 2^-49 at k = 4), with random
// signs; 3 the same divisors under a = +-1; 4 special operands (zeros of both signs,
// subnormals, infinities, NaN, the largest and smallest normals) against
// hashed ones; 5 the pairs (a[i], d[i]). out[0] gets the pairs where
// either differs, out[1] those quot accepted.
template <typename T>
__global__ void quot_check_kernel(unsigned long long n, int mode, const T* pa, const T* pd,
                                  unsigned long long* out) {
  using B = Bits<T>;
  using U = typename B::U;
  constexpr U kOne = static_cast<U>(B::kBias) << B::kFrac;
  constexpr U kFracMask = (static_cast<U>(1) << B::kFrac) - 1;
  constexpr U kSign = static_cast<U>(1) << (sizeof(U) * 8 - 1);
  unsigned long long bad = 0, fast = 0;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * static_cast<unsigned long long>(blockDim.x) + threadIdx.x;
       i < n; i += stride) {
    const unsigned long long h = rn::mix(i * 8 + mode), h2 = rn::mix(h);
    U ua = static_cast<U>(h), ud = static_cast<U>(sizeof(U) == 8 ? h2 : h >> 32);
    // a random exponent in [-w, w] over a random sign and fraction
    auto windowed = [&](U u, unsigned long long r, unsigned w) {
      const U e = static_cast<U>(r % (2 * w + 1) + B::kBias - w);
      return (u & (kSign | kFracMask)) | e << B::kFrac;
    };
    if (mode == 1) {
      const unsigned w = rn::Checked<T>::kD;
      ua = windowed(ua, h2 >> 40, w);
      ud = windowed(ud, h2 >> 20, w);
    } else if (mode == 2 || mode == 3) {
      // ulps from the edge: 0, 1, 2 above; 1, 2, 16 below
      const unsigned long long v = i % 6, k = (i / 6) % B::kExpMax + 1;  // exponent field 1..max
      const U edge = static_cast<U>(k) << B::kFrac;
      ud = v < 3 ? edge + static_cast<U>(v) : edge - static_cast<U>(v == 5 ? 16 : v - 2);
      ud |= static_cast<U>(h2 & 1) ? kSign : 0;
      ua = mode == 3 ? kOne | (static_cast<U>(h2 >> 1 & 1) ? kSign : 0)
                     : windowed(ua, h2 >> 20, 40);
    } else if (mode == 4) {
      const U special[10] = {0, kSign, 1, kFracMask, static_cast<U>(B::kExpMax + 1) << B::kFrac,
                             (static_cast<U>(B::kExpMax + 1) << B::kFrac) | 1,
                             static_cast<U>(1) << B::kFrac,
                             (static_cast<U>(B::kExpMax) << B::kFrac) | kFracMask,
                             static_cast<U>(h2 & kFracMask), kOne};
      const U s = special[(h2 >> 8) % 10] | (static_cast<U>(h2 >> 4 & 1) ? kSign : 0);
      if (h2 & 1) ua = s; else ud = s;
      if (h2 & 2) ua = special[(h2 >> 16) % 10], ud = s;
    }
    T a = B::of(ua), d = B::of(ud);
    if (mode == 5) a = pa[i], d = pd[i];
    bool ok = true, ok_short = true;
    const rn::Checked<T> div(d);
    const T q = div.quot(a, ok), q_short = div.quot_short(a, ok_short);
    fast += ok ? 1 : 0;
    const T ref = Rn<T>::div(a, d);
    bad += B::to(ok ? q : ref) != B::to(ref) || B::to(ok_short ? q_short : ref) != B::to(ref);
  }
  atomicAdd(out, bad);
  atomicAdd(out + 1, fast);
}

template <typename T>
cudaError_t quot_check(unsigned long long n, int mode, const T* a, const T* d,
                       unsigned long long* out, cudaStream_t stream) {
  if (mode < 0 || mode > 5 || (mode == 5 && (a == nullptr || d == nullptr)))
    return cudaErrorInvalidValue;
  quot_check_kernel<T><<<132 * 8, 256, 0, stream>>>(n, mode, a, d, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attributes(int* out) {
  const void* fns[6] = {reinterpret_cast<const void*>(&pentadiagonal_kernel<T>),
                        reinterpret_cast<const void*>(&sosfilt_kernel<T, 1>),
                        reinterpret_cast<const void*>(&sosfilt_kernel<T, 2>),
                        reinterpret_cast<const void*>(&sosfilt_kernel<T, 4>),
                        reinterpret_cast<const void*>(&sosfilt_kernel<T, 8>),
                        reinterpret_cast<const void*>(&sosfilt_kernel<T, 16>)};
  for (int i = 0; i < 6; ++i) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, fns[i]);
    if (err != cudaSuccess) return err;
    out[3 * i] = static_cast<int>(fa.localSizeBytes);
    out[3 * i + 1] = fa.numRegs;
    out[3 * i + 2] = static_cast<int>(fa.sharedSizeBytes);
  }
  return cudaSuccess;
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

// Rows a solve keeps in shared memory on the current device (past them it
// streams through scratch); minus a cudaError on error.
int pentadiagonal_capacity(int elem_size) {
  int slots = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (elem_size == 4) err = ring_slots<float>(&slots);
  if (elem_size == 8) err = ring_slots<double>(&slots);
  return err == cudaSuccess ? slots * kTile : -static_cast<int>(err);
}

int recursions_quot_check_f32(unsigned long long n, int mode, const float* a, const float* d,
                              unsigned long long* out, cudaStream_t stream) {
  return static_cast<int>(quot_check<float>(n, mode, a, d, out, stream));
}

int recursions_quot_check_f64(unsigned long long n, int mode, const double* a, const double* d,
                              unsigned long long* out, cudaStream_t stream) {
  return static_cast<int>(quot_check<double>(n, mode, a, d, out, stream));
}

// local memory, registers and static shared memory of the solve and of the
// filter at 1, 2, 4, 8 and 16 lanes a row: 18 ints
int recursions_kernel_attributes(int elem_size, int* out) {
  if (elem_size == 4) return static_cast<int>(attributes<float>(out));
  if (elem_size == 8) return static_cast<int>(attributes<double>(out));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
