// Phase-fold histograms for every trial frequency, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by periodicity_tpu_torch/ops/_kernels.py.
//
// Replaces the TPU kernel periodicity_tpu/ops/pallas_bls.py::fold_onehot
// and computes the same thing:
//
//     out[p, v, k] = sum_i values[v, i] * [bin_p(i) == k],
//     bin_p(i) = clamp(int(frac(t[i] * f[p]) * n_phi), 0, n_phi - 1) * stride
//                + offsets[i]
//
// with t = float32(t - t[0]) (the epoch is taken off by the caller, in the
// input dtype) and f = float32(1 / period). The bin is the contract: each
// product and difference is rounded on its own (__fmul_rn, __fsub_rn), so
// nvcc cannot contract t * f - floor(t * f) into an FMA and move a sample
// across a bin edge. Every sample lands in the bin the f32 formula gives.
//
// So is the sum: out[p, v, k] is the f32 sum, from +0, of values[v, i] over
// the samples i in bin k, taken in ascending i, each addition rounded on its
// own (__fadd_rn). That is what ops/fold.py::fold_onehot_plain gives on the
// CPU (one index_add_ in index order), so the two agree bit for bit and two
// launches give the same bits. No float atomics: their order is the
// hardware's.
//
// What bounds it on the card. The phase scans launch it once per chunk of
// trial frequencies: at config 11 (N = 2000 samples, 2 rows of 256 bins)
// a chunk of 512 frequencies writes 1 MB of histograms against 26 KB of
// input, about 0.32 us at 3.35 TB/s, and its ~1e6 (frequency, sample)
// pairs of bin arithmetic take about 0.1 us at 67 TFLOP/s. So what sets a
// chunk's time is how much of the card one launch fills and how long the
// chain of dependent steps in a block is; a fixed order adds a chain of
// its own, one addition a sample of the fullest bin (~8 at config 11, ~220
// at the AoV shape of 9 bins). Over all 1e5 frequencies in one launch, the
// writes (205 MB, 61 us) and the bin arithmetic set it.
//
// What the design does about it:
// - One block folds one frequency at a time, and a launch has as many
//   blocks as fit on the card at once, up to one per frequency, each
//   looping over its frequencies: a 512-frequency chunk spreads over all
//   132 SMs. A launch of up to two frequencies per resident block, such as
//   a chunk, takes blocks of 512 threads; a longer one takes blocks of
//   256, of which more fit on the card, so that more frequencies are in
//   flight.
// - Per frequency the block sorts its samples by bin, stably, with a
//   counting sort over 8 bits of the bin a pass (one pass up to 256 bins,
//   two above): warp w holds a contiguous range of samples, 32 at a step;
//   nine ballots give each sample its rank among the equal digits of its
//   step, a per-(digit, warp) count its rank among the warp's earlier
//   steps, and one scan over the counts in (digit, warp) order the place
//   of each. The counts are integers, so the order does not depend on the
//   hardware. Then a thread a histogram cell walks its bin's samples in
//   ascending order and writes the cell, each once and coalesced: no
//   zero-fill pass, no histogram in shared memory, no atomics.
// - Up to N = 2048 samples the times and offsets stay in registers and up
//   to 3 value rows the values in shared memory, loaded once per launch;
//   otherwise a block sorts 2048 samples at a time, in order, reads them
//   for every frequency (they stay in L1 and L2) and carries the cells'
//   sums in shared memory from one tile to the next.
// - floor and the truncation to int come from one add each with directed
//   rounding against a power of two (exact in the ranges where they are
//   used, falling back to floorf outside), full-rate adds in place of
//   the conversion unit's 16 results per clock; the bins are bit-equal.
// - The launch shape (SM count, occupancy, opt-in shared memory) is queried
//   once per device and shared-memory size (launch_cache.cuh).
//
// The TPU kernel's one-hot MXU matmuls, Precision.HIGHEST emulation,
// 32-period program chunk, 512-sample and 128-lane padding and scalar
// prefetch existed for the TPU and have no counterpart here.

#include <cuda_runtime.h>

#include "launch_cache.cuh"

namespace {

constexpr int kTile = 2048;  // samples sorted at a time; the register path takes at most this many
constexpr int kRegRows = 3;  // and at most this many value rows, kept in shared memory
constexpr int kWarp = 32;
constexpr int kDigits = 256;         // a sort pass orders by 8 bits of the bin
constexpr unsigned kNone = 0xffffu;  // a sample with no bin (an offset outside [0, stride))
constexpr unsigned kFullMask = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // opt-in shared memory of a block on sm_90

// floor(x), exactly: for |x| < 2^22, x + 1.5 * 2^23 lies in [2^23, 2^24),
// where the floats are the integers, so rounding the sum down gives
// floor(x) + 1.5 * 2^23.
__device__ __forceinline__ float floor_exact(float x) {
  if (fabsf(x) < 4194304.0f) return __fsub_rn(__fadd_rd(x, 12582912.0f), 12582912.0f);
  return floorf(x);
}

// The contract's bin: clamp(int(frac(t * f) * n_phi), 0, n_phi - 1). y =
// frac * n_phi lies in [0, n_phi] (NaN for a non-finite t * f, which fmaxf
// sends to 0 as the int conversion does); y + 2^23 rounded toward zero
// holds trunc(y) in its mantissa.
__device__ __forceinline__ int phase_bin(float t, float f, float nphi_f, int n_phi) {
  const float x = __fmul_rn(t, f);
  const float phi = __fsub_rn(x, floor_exact(x));
  const float y = fmaxf(__fmul_rn(phi, nphi_f), 0.0f);
  const int pb = __float_as_int(__fadd_rz(y, 8388608.0f)) - 0x4B000000;
  return min(pb, n_phi - 1);
}

// samples a warp holds of a tile of cnt: whole steps of 32, W warps
template <int W>
__device__ __forceinline__ int warp_span(int cnt) {
  return kWarp * (((cnt + kWarp - 1) / kWarp + W - 1) / W);
}

// the sort's counts a digit: one a warp and a pad, so that a warp's
// accesses to different digits fall in different banks
__host__ __device__ constexpr int count_stride(int threads) { return threads / kWarp + 1; }

// shared memory of a block, in bytes: the sort's counts [kDigits][W + 1]
// and warp sums, then `floats` f32 (the value rows
// of the register path, or the cells' sums of a tiled launch), then four
// kTile arrays of 16-bit keys and sample indices
constexpr size_t sort_bytes(int threads) {
  return sizeof(int) * (static_cast<size_t>(kDigits) * count_stride(threads) + kWarp) +
         4 * sizeof(unsigned short) * kTile;
}

// counts [kDigits][W] (a digit's row count_stride apart) become their
// exclusive prefix sums in (digit, warp) order; returns the sum. A thread
// takes E = 8 of a digit's counts. Three barriers, the first after every
// warp's counts.
template <int kThreads>
__device__ __forceinline__ int scan_counts(int* counts, int* wsum) {
  constexpr int W = kThreads / kWarp, E = kDigits * W / kThreads, CS = count_stride(kThreads);
  static_assert(W % E == 0, "a thread's counts lie in one digit's row");
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int* mine = counts + threadIdx.x / (W / E) * CS + threadIdx.x % (W / E) * E;
  __syncthreads();
  int c[E];
  int sum = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    c[e] = mine[e];
    sum += c[e];
  }
  int inc = sum;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == kWarp - 1) wsum[warp] = inc;
  __syncthreads();
  int base = inc - sum, total = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int s = wsum[w];
    if (w < warp) base += s;
    total += s;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    mine[e] = base;
    base += c[e];
  }
  __syncthreads();
  return total;
}

// The lanes of this warp whose digit d (0 .. kDigits, kDigits for no
// item) equals this lane's, from one ballot a bit: __match_any_sync takes
// a pass a distinct value, and a step of 32 samples over 256 bins holds
// nearly 32 of them.
__device__ __forceinline__ unsigned match_digit(unsigned d) {
  unsigned peers = kFullMask;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const unsigned bit = (d >> b) & 1u;
    const unsigned ones = __ballot_sync(kFullMask, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

// One stable counting pass over the 8 bits of the keys at `shift`. This
// thread's items are key[s], item[s] at positions warp * M + s * 32 + lane
// of the pass's order (key kNone: no item). Writes every item's key and
// sample index at its place in the digit-sorted order (dkey may be null);
// returns the number of items. counts keeps the digits' exclusive
// offsets, warp w's at column w, until the next pass.
template <int kThreads>
__device__ __forceinline__ int sort_pass(const unsigned (&key)[kTile / kThreads],
                                         const unsigned (&item)[kTile / kThreads], int steps,
                                         int shift, int* counts, int* wsum,
                                         unsigned short* dkey, unsigned short* ditem) {
  constexpr int S = kTile / kThreads, CS = count_stride(kThreads);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  for (int e = threadIdx.x; e < kDigits * CS; e += kThreads) counts[e] = 0;
  __syncthreads();
  int rank[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    rank[s] = 0;
    if (s < steps) {
      const bool valid = key[s] != kNone;
      // the samples with no bin share a digit of their own
      const unsigned d = valid ? (key[s] >> shift) & (kDigits - 1) : kDigits;
      const unsigned peers = match_digit(d);
      const int leader = __ffs(peers) - 1;
      int old = 0;
      if (valid && lane == leader) {
        old = counts[d * CS + warp];
        counts[d * CS + warp] = old + __popc(peers);
      }
      old = __shfl_sync(kFullMask, old, leader);
      rank[s] = old + __popc(peers & ((1u << lane) - 1u));
      __syncwarp();
    }
  }
  const int total = scan_counts<kThreads>(counts, wsum);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s < steps && key[s] != kNone) {
      const int at = counts[((key[s] >> shift) & (kDigits - 1)) * CS + warp] + rank[s];
      if (dkey) dkey[at] = static_cast<unsigned short>(key[s]);
      ditem[at] = static_cast<unsigned short>(item[s]);
    }
  }
  __syncthreads();
  return total;
}

// the first place in a[0 .. n) whose key is >= k (a sorted)
__device__ __forceinline__ int lower_bound(const unsigned short* a, int n, unsigned k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < k)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// kReg: at most kTile samples, their times and offsets in registers and,
// with at most kRegRows value rows, the values in shared memory. Otherwise
// the samples are read for every frequency, kTile at a time, and a launch
// of more than kTile samples carries the cells' sums in shared memory.
// 64 registers a thread, so that two 512-thread blocks (four of 256) share
// an SM.
template <bool kReg, int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
fold_kernel(const float* __restrict__ t, const float* __restrict__ values,
            const int* __restrict__ offsets, const float* __restrict__ freqs,
            int n, int nv, int p, int n_phi, int stride, float* __restrict__ out) {
  constexpr int W = kThreads / kWarp, S = kTile / kThreads, CS = count_stride(kThreads);
  extern __shared__ __align__(16) unsigned char fold_smem[];
  const int nbins = n_phi * stride;
  const int cells = nv * nbins;
  const bool tiled = n > kTile;
  const bool shared_rows = kReg && nv <= kRegRows;
  int* const counts = reinterpret_cast<int*>(fold_smem);
  int* const wsum = counts + kDigits * CS;
  float* const fl = reinterpret_cast<float*>(wsum + kWarp);  // value rows or cells' sums
  unsigned short* const key_a =
      reinterpret_cast<unsigned short*>(fl + (shared_rows ? nv * n : tiled ? cells : 0));
  unsigned short* const key_b = key_a + kTile;
  unsigned short* const item_a = key_b + kTile;
  unsigned short* const item_b = item_a + kTile;
  const bool two_pass = nbins > kDigits;
  const float nphi_f = static_cast<float>(n_phi);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;

  float rt[S];
  int roff[S];
  if (kReg) {
    const int span = warp_span<W>(n);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = warp * span + s * kWarp + lane;
      const bool in = s * kWarp < span && i < n;
      rt[s] = in ? t[i] : 0.0f;
      roff[s] = (in && offsets != nullptr) ? offsets[i] : 0;
    }
    if (shared_rows)
      for (int e = threadIdx.x; e < nv * n; e += kThreads) fl[e] = values[e];
  }
  // each frequency is loaded one frequency ahead, off the path that
  // follows the barrier
  float f_next = freqs[blockIdx.x];
  __syncthreads();

  for (int q = blockIdx.x; q < p; q += gridDim.x) {
    const float f = f_next;
    if (q + gridDim.x < p) f_next = freqs[q + gridDim.x];
    for (int t0 = 0; t0 < n; t0 += kTile) {
      const int cnt = min(kTile, n - t0);
      const int span = warp_span<W>(cnt), steps = span / kWarp;
      // this thread's samples of the tile and their bins
      unsigned key[S], item[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int pos = warp * span + s * kWarp + lane;
        item[s] = static_cast<unsigned>(pos);
        key[s] = kNone;
        if (s < steps && pos < cnt) {
          const int b = kReg ? phase_bin(rt[s], f, nphi_f, n_phi) * stride + roff[s]
                             : phase_bin(t[t0 + pos], f, nphi_f, n_phi) * stride +
                                   (offsets != nullptr ? offsets[t0 + pos] : 0);
          if (b >= 0 && b < nbins) key[s] = static_cast<unsigned>(b);
        }
      }
      int total = sort_pass<kThreads>(key, item, steps, 0, counts, wsum,
                                      two_pass ? key_a : nullptr, item_a);
      if (two_pass) {
        // the second pass takes the first's order, a warp a contiguous range
        const int span2 = warp_span<W>(total), steps2 = span2 / kWarp;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int pos = warp * span2 + s * kWarp + lane;
          const bool in = s < steps2 && pos < total;
          key[s] = in ? key_a[pos] : kNone;
          item[s] = in ? item_a[pos] : 0u;
        }
        total = sort_pass<kThreads>(key, item, steps2, 8, counts, wsum, key_b, item_b);
      }
      const unsigned short* const order = two_pass ? item_b : item_a;
      // a thread a cell: its bin's samples in ascending order, from +0 (or
      // the tiles before), each addition rounded on its own
      const bool last = t0 + kTile >= n;
      for (int c = threadIdx.x; c < cells; c += kThreads) {
        const int v = c / nbins, k = c - v * nbins;
        int lo, hi;
        if (two_pass) {
          lo = lower_bound(key_b, total, static_cast<unsigned>(k));
          hi = lower_bound(key_b, total, static_cast<unsigned>(k + 1));
        } else {
          lo = counts[k * CS];
          hi = k + 1 < kDigits ? counts[(k + 1) * CS] : total;
        }
        const float* row = shared_rows ? fl + v * n : values + static_cast<size_t>(v) * n + t0;
        float acc = tiled && t0 > 0 ? fl[c] : 0.0f;
#pragma unroll 4
        for (int j = lo; j < hi; ++j) acc = __fadd_rn(acc, row[order[j]]);
        if (last)
          out[static_cast<size_t>(q) * cells + c] = acc;
        else
          fl[c] = acc;
      }
      __syncthreads();
    }
  }
}

template <bool kReg, int kThreads>
int launch_fold(const float* t, const float* values, const int* offsets, const float* freqs,
                int n, int nv, int p, int n_phi, int stride, float* out, size_t floats,
                int blocks, cudaStream_t stream) {
  const size_t smem = sort_bytes(kThreads) + floats * sizeof(float);
  fold_kernel<kReg, kThreads><<<blocks, kThreads, smem, stream>>>(t, values, offsets, freqs, n,
                                                                  nv, p, n_phi, stride, out);
  return static_cast<int>(cudaGetLastError());
}

// A launch of up to two frequencies per resident block takes blocks of
// 512 threads, whose sort has half the steps a warp; a longer launch loops
// its blocks over many frequencies and takes blocks of 256 threads, of
// which more fit on the card, so that more frequencies are in flight.
template <bool kReg>
int launch_path(const float* t, const float* values, const int* offsets, const float* freqs,
                int n, int nv, int p, int n_phi, int stride, float* out, cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(nv) * n_phi * stride;
  const size_t floats = kReg && nv <= kRegRows ? static_cast<size_t>(nv) * n
                        : n > kTile             ? cells
                                                : 0;
  int resident = 0;
  cudaError_t err = launch_cache::resident_blocks(
      reinterpret_cast<const void*>(fold_kernel<kReg, 512>), 512,
      sort_bytes(512) + floats * sizeof(float), kMaxSmem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p <= 2 * resident) {
    return launch_fold<kReg, 512>(t, values, offsets, freqs, n, nv, p, n_phi, stride, out,
                                  floats, p < resident ? p : resident, stream);
  }
  err = launch_cache::resident_blocks(reinterpret_cast<const void*>(fold_kernel<kReg, 256>), 256,
                                      sort_bytes(256) + floats * sizeof(float), kMaxSmem,
                                      &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_fold<kReg, 256>(t, values, offsets, freqs, n, nv, p, n_phi, stride, out, floats,
                                p < resident ? p : resident, stream);
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 on success), or the error of the launch set-up. `offsets` may be null.
// The caller checks shapes, dtypes and contiguity, and that nv * n_phi *
// stride cells (at most 29056) fit beside the sort in 227 KB.
extern "C" int fold_onehot_f32(const float* t, const float* values,
                               const int* offsets, const float* freqs, int n,
                               int nv, int p, int n_phi, int stride,
                               float* out, void* stream) {
  if (p <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kTile)
    return launch_path<true>(t, values, offsets, freqs, n, nv, p, n_phi, stride, out, s);
  return launch_path<false>(t, values, offsets, freqs, n, nv, p, n_phi, stride, out, s);
}
