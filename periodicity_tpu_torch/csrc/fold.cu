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
// What bounds it on the card: the histogram writes. BLS at its benchmark
// shape (N = 2000 samples, P = 1e5 trial periods, nv = 2 rows of 256 bins)
// writes P * nv * nbins * 4 B = 204.8 MB, about 61 us at 3.35 TB/s, against
// 24 KB of input. The bin arithmetic is about P * N * 6 = 1.2e9 f32
// operations, about 18 us at 67 TFLOP/s. The shared-memory atomics (one per
// sample and row) sit between the two and are not counted in either.
//
// What the design does about it: each output cell is written exactly once,
// with coalesced stores, and nothing else touches the output (no zero-fill
// pass, no global atomics, no padding arrays). A block of 256 threads
// stages t, the value rows and the offsets in shared memory once, when
// they fit, and streams them from global memory (L2) otherwise. Each warp
// owns one trial frequency at a time and a private nv x nbins histogram in
// shared memory: its lanes add their samples with shared atomics, each lane
// walking its own contiguous run of the time-sorted samples so that the
// lanes of one atomic rarely hit the same bin, then the warp writes the
// histogram out row by row and zeroes it for its next frequency, with no
// block-wide barrier inside the loop. The ragged edges of N and P are
// masked by the loop bounds.
//
// The TPU kernel's one-hot MXU matmuls, Precision.HIGHEST emulation,
// 32-period program chunk, 512-sample and 128-lane padding and scalar
// prefetch existed for the TPU and have no counterpart here.
//
// Sums: shared f32 atomics add in an order the hardware picks. Rows of
// ones (counts) are integers below 2^24 and so exact; weighted rows equal
// the plain version up to the order of addition.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// t, values and offsets are staged only while the block's shared memory
// stays under this, so that at least two blocks fit on an SM
constexpr size_t kStageBudget = 100 * 1024;

__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ t, const float* __restrict__ values,
            const int* __restrict__ offsets, const float* __restrict__ freqs,
            int n, int nv, int p, int n_phi, int stride, int staged,
            float* __restrict__ out) {
  extern __shared__ float smem[];
  const int nbins = n_phi * stride;
  const int cells = nv * nbins;  // one histogram
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* hist = smem + warp * cells;

  const float* ts = t;
  const float* vs = values;
  const int* offs = offsets;
  if (staged) {
    float* s_t = smem + kWarps * cells;
    float* s_v = s_t + n;
    int* s_off = reinterpret_cast<int*>(s_v + static_cast<size_t>(nv) * n);
    for (int i = threadIdx.x; i < n; i += kThreads) s_t[i] = t[i];
    for (int i = threadIdx.x; i < nv * n; i += kThreads) s_v[i] = values[i];
    if (offsets != nullptr) {
      for (int i = threadIdx.x; i < n; i += kThreads) s_off[i] = offsets[i];
      offs = s_off;
    }
    ts = s_t;
    vs = s_v;
  }
  for (int i = threadIdx.x; i < kWarps * cells; i += kThreads) smem[i] = 0.0f;
  __syncthreads();

  const float nphi_f = static_cast<float>(n_phi);
  // each lane takes a contiguous run of samples, so that the 32 lanes of
  // an atomic are far apart in time and, for most periods, in phase (time
  // is sorted: neighbouring samples share a bin at long periods). An odd
  // run length keeps the lanes' shared-memory reads on distinct banks.
  const int run = ((n + 31) / 32) | 1;
  const int first = lane * run;
  const int last = min(first + run, n);
  for (int q = blockIdx.x * kWarps + warp; q < p; q += gridDim.x * kWarps) {
    const float f = freqs[q];
    for (int i = first; i < last; ++i) {
      float phi = __fmul_rn(ts[i], f);
      phi = __fsub_rn(phi, floorf(phi));
      int pb = static_cast<int>(__fmul_rn(phi, nphi_f));  // truncates, phi >= 0
      pb = min(max(pb, 0), n_phi - 1);
      const int bin = pb * stride + (offs != nullptr ? offs[i] : 0);
      if (bin >= 0 && bin < nbins) {  // an offset outside [0, stride) adds nothing
        for (int v = 0; v < nv; ++v) {
          atomicAdd(&hist[v * nbins + bin], vs[v * n + i]);
        }
      }
    }
    __syncwarp();
    float* dst = out + static_cast<size_t>(q) * cells;
    for (int k = lane; k < cells; k += 32) {
      dst[k] = hist[k];
      hist[k] = 0.0f;
    }
    __syncwarp();
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 on success), or the error of the launch set-up. `offsets` may be null.
// The caller checks shapes, dtypes and contiguity, and that the kWarps
// histograms fit in the block's shared memory (227 KB on sm_90).
extern "C" int fold_onehot_f32(const float* t, const float* values,
                               const int* offsets, const float* freqs, int n,
                               int nv, int p, int n_phi, int stride,
                               float* out, void* stream) {
  if (p <= 0) return static_cast<int>(cudaSuccess);
  const size_t hist_bytes =
      static_cast<size_t>(kWarps) * nv * n_phi * stride * sizeof(float);
  const size_t stage_bytes =
      static_cast<size_t>(n) * (1 + nv + (offsets != nullptr ? 1 : 0)) * sizeof(float);
  const int staged = hist_bytes + stage_bytes <= kStageBudget ? 1 : 0;
  const size_t smem = hist_bytes + (staged ? stage_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_kernel, kThreads,
                                                           smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // one warp per frequency, as many resident blocks as fit, each looping
  // over its frequencies: the staging is paid once per resident block
  const int wanted = (p + kWarps - 1) / kWarps;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = wanted < resident ? wanted : resident;
  fold_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      t, values, offsets, freqs, n, nv, p, n_phi, stride, staged, out);
  return static_cast<int>(cudaGetLastError());
}
