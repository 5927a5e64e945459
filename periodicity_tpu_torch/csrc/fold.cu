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
// What bounds it on the card. The phase scans launch it once per chunk of
// trial frequencies: at config 11 (N = 2000 samples, 2 rows of 256 bins)
// a chunk of 512 frequencies writes 1 MB of histograms against 26 KB of
// input, about 0.32 us at 3.35 TB/s, and its ~1e6 (frequency, sample)
// pairs of bin arithmetic take about 0.1 us at 67 TFLOP/s. So what sets a
// chunk's time is how much of the card one launch fills and how long the
// chain of dependent steps in a block is. Over all 1e5 frequencies in one
// launch, the writes (205 MB, 61 us) and the bin arithmetic set it.
//
// What the design does about it:
// - One block folds one frequency at a time, and a launch has as many
//   blocks as fit on the card at once, up to one per frequency, each
//   looping over its frequencies: a 512-frequency chunk spreads over all
//   132 SMs (the first design put a frequency on each warp: 64 blocks).
//   A launch of up to two frequencies per resident block, such as a chunk,
//   takes blocks of 512 threads, which halve each thread's serial chain of
//   atomics; a longer one takes blocks of 256, of which more fit on the
//   card, so that more frequencies are in flight.
// - Each thread owns a contiguous run of ceil(N / threads) time-sorted
//   samples. Up to N = 2048 and 3 value rows it loads them into registers
//   once per launch; otherwise it reads them for every frequency (they
//   stay in L1 and L2).
// - It walks its run in time order and sums samples that fall in the same
//   bin as the one before in registers, so a shared atomic is paid per run
//   of equal bins, not per sample (at long periods neighbouring samples
//   often share a bin). Shared f32 atomics are compare-and-swap loops on
//   this card, and they, not the bytes, set the pace of a launch. Lanes
//   of a warp own neighbouring runs, so their atomics rarely meet on one
//   bin.
// - floor and the truncation to int come from one add each with directed
//   rounding against a power of two (exact in the ranges where they are
//   used, falling back to floorf outside), full-rate adds in place of
//   the conversion unit's 16 results per clock; the bins are bit-equal.
// - The block's two shared histograms alternate between frequencies, so
//   each frequency needs one barrier: after its atomics, the block writes
//   the histogram out, each cell once and coalesced, and zeroes it while
//   the next frequency fills the other one. No zero-fill pass over the
//   output, no global atomics, no padding.
// - The launch shape (SM count, occupancy, opt-in shared memory) is queried
//   once per device and shared-memory size (launch_cache.cuh).
//
// The TPU kernel's one-hot MXU matmuls, Precision.HIGHEST emulation,
// 32-period program chunk, 512-sample and 128-lane padding and scalar
// prefetch existed for the TPU and have no counterpart here.
//
// Sums: shared f32 atomics add runs in an order the hardware picks. Rows of
// ones (counts) are integers below 2^24 and so exact; weighted rows equal
// the plain version up to the order of addition.

#include <climits>

#include <cuda_runtime.h>

#include "launch_cache.cuh"

namespace {

constexpr int kRegSamples = 2048;  // the register path: at most this many samples
constexpr int kRegRows = 3;  // and this many value rows
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

// kRows > 0: exactly kRows value rows and at most kRegSamples samples,
// held in registers. kRows == 0: any nv and N, the samples read from
// global memory for every frequency.
template <int kRows, int kThreads>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ t, const float* __restrict__ values,
            const int* __restrict__ offsets, const float* __restrict__ freqs,
            int n, int nv, int p, int n_phi, int stride, float* __restrict__ out) {
  extern __shared__ float hist[];  // two [nv, nbins] histograms
  constexpr int kR = kRows > 0 ? kRows : 1;
  constexpr int kK = kRows > 0 ? kRegSamples / kThreads : 1;
  const int nbins = n_phi * stride;
  const int cells = nv * nbins;
  const float nphi_f = static_cast<float>(n_phi);
  const int run = (n + kThreads - 1) / kThreads;
  const int first = min(static_cast<int>(threadIdx.x) * run, n);
  const int last = min(first + run, n);

  for (int i = threadIdx.x; i < 2 * cells; i += kThreads) hist[i] = 0.0f;
  float rt[kK];
  float rv[kR][kK];
  int roff[kK];
  if (kRows > 0) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int i = first + k;
      const bool in = i < last;
      rt[k] = in ? t[i] : 0.0f;
      roff[k] = (in && offsets != nullptr) ? offsets[i] : 0;
#pragma unroll
      for (int v = 0; v < kR; ++v) rv[v][k] = in ? values[static_cast<size_t>(v) * n + i] : 0.0f;
    }
  }
  // each frequency is loaded one frequency ahead, off the path that
  // follows the barrier
  float f_next = freqs[blockIdx.x];
  __syncthreads();

  int buf = 0;
  for (int q = blockIdx.x; q < p; q += gridDim.x, buf ^= 1) {
    float* h = hist + buf * cells;
    const float f = f_next;
    if (q + gridDim.x < p) f_next = freqs[q + gridDim.x];
    // walk this thread's samples in time order; `bin` is the bin of the
    // current run of equal bins (INT_MIN before the first), whose sums are
    // added to the histogram when the run ends. A bin outside [0, nbins)
    // (an offset outside [0, stride)) adds nothing.
    int bin = INT_MIN;
    if (kRows > 0) {
      float s[kR];
#pragma unroll
      for (int v = 0; v < kR; ++v) s[v] = 0.0f;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        if (first + k < last) {
          const int b = phase_bin(rt[k], f, nphi_f, n_phi) * stride + roff[k];
          if (b != bin) {
            if (bin >= 0 && bin < nbins) {
#pragma unroll
              for (int v = 0; v < kR; ++v) atomicAdd(&h[v * nbins + bin], s[v]);
            }
            bin = b;
#pragma unroll
            for (int v = 0; v < kR; ++v) s[v] = rv[v][k];
          } else {
#pragma unroll
            for (int v = 0; v < kR; ++v) s[v] += rv[v][k];
          }
        }
      }
      if (bin >= 0 && bin < nbins) {
#pragma unroll
        for (int v = 0; v < kR; ++v) atomicAdd(&h[v * nbins + bin], s[v]);
      }
    } else {
      // a run [start, i) of equal bins is summed row by row when it ends
      int start = first;
      for (int i = first; i <= last; ++i) {
        const int b = i < last ? phase_bin(t[i], f, nphi_f, n_phi) * stride +
                                     (offsets != nullptr ? offsets[i] : 0)
                               : INT_MIN;
        if (b != bin || i == last) {
          if (bin >= 0 && bin < nbins) {
            for (int v = 0; v < nv; ++v) {
              const float* row = values + static_cast<size_t>(v) * n;
              float s = 0.0f;
              for (int j = start; j < i; ++j) s += row[j];
              atomicAdd(&h[v * nbins + bin], s);
            }
          }
          bin = b;
          start = i;
        }
      }
    }
    __syncthreads();
    // write this frequency's histogram out and zero it; the next frequency
    // fills the other one, and its barrier orders this zeroing before the
    // frequency after it
    float* dst = out + static_cast<size_t>(q) * cells;
    for (int k = threadIdx.x; k < cells; k += kThreads) {
      dst[k] = h[k];
      h[k] = 0.0f;
    }
  }
}

template <int kRows, int kThreads>
int launch_fold(const float* t, const float* values, const int* offsets, const float* freqs,
                int n, int nv, int p, int n_phi, int stride, float* out, size_t smem,
                int blocks, cudaStream_t stream) {
  fold_kernel<kRows, kThreads><<<blocks, kThreads, smem, stream>>>(t, values, offsets, freqs, n,
                                                                    nv, p, n_phi, stride, out);
  return static_cast<int>(cudaGetLastError());
}

// A launch of up to two frequencies per resident block takes blocks of
// 512 threads, which halve each thread's serial chain of atomics on the
// path of its one or two rounds. A longer launch loops its blocks over
// many frequencies and takes blocks of 256 threads, of which more fit on
// the card, so that more frequencies are in flight.
template <int kRows>
int launch_rows(const float* t, const float* values, const int* offsets, const float* freqs,
                int n, int nv, int p, int n_phi, int stride, float* out, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(nv) * n_phi * stride * sizeof(float);
  int resident = 0;
  cudaError_t err = launch_cache::resident_blocks(
      reinterpret_cast<const void*>(fold_kernel<kRows, 512>), 512, smem, kMaxSmem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p <= 2 * resident) {
    return launch_fold<kRows, 512>(t, values, offsets, freqs, n, nv, p, n_phi, stride, out, smem,
                                   p < resident ? p : resident, stream);
  }
  err = launch_cache::resident_blocks(reinterpret_cast<const void*>(fold_kernel<kRows, 256>), 256,
                                      smem, kMaxSmem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_fold<kRows, 256>(t, values, offsets, freqs, n, nv, p, n_phi, stride, out, smem,
                                 p < resident ? p : resident, stream);
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 on success), or the error of the launch set-up. `offsets` may be null.
// The caller checks shapes, dtypes and contiguity, and that the block's two
// f32 histograms, 2 * nv * n_phi * stride * 4 bytes, fit in 227 KB.
extern "C" int fold_onehot_f32(const float* t, const float* values,
                               const int* offsets, const float* freqs, int n,
                               int nv, int p, int n_phi, int stride,
                               float* out, void* stream) {
  if (p <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kRegSamples && nv <= kRegRows) {
    switch (nv) {
      case 1:
        return launch_rows<1>(t, values, offsets, freqs, n, nv, p, n_phi, stride, out, s);
      case 2:
        return launch_rows<2>(t, values, offsets, freqs, n, nv, p, n_phi, stride, out, s);
      default:
        return launch_rows<3>(t, values, offsets, freqs, n, nv, p, n_phi, stride, out, s);
    }
  }
  return launch_rows<0>(t, values, offsets, freqs, n, nv, p, n_phi, stride, out, s);
}
