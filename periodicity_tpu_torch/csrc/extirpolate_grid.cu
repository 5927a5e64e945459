// Press-Rybicki spreading ("extirpolation") onto an nfft grid, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// periodicity_tpu_torch/ops/_kernels.py.
//
// Replaces the TPU kernel
// periodicity_tpu/ops/pallas_grid2.py::extirpolate_grid_factored and
// computes the same thing:
//
//     re[ilo[i] + j] += u_re[i] * lag[i, j]
//     im[ilo[i] + j] += u_im[i] * lag[i, j]      for j < taps,
//
// with ilo sorted ascending and ilo[i] + taps <= nfft (no wrap).
//
// What bounds it on the card: the plane writes. The main path spreads
// N = 1e5 samples onto 2^23 and 2^22 cells, i.e. 64 MB + 32 MB of f32
// output per periodogram against ~3 MB of input, so the kernel is a
// store-bandwidth kernel with a sparse gather on the side.
//
// What the design does about it: every cell of both planes is written
// exactly once, with 16-byte vector stores, and nothing else touches the
// planes (no zero-fill pass, no global atomics, no read-modify-write).
// Each block owns a contiguous tile of cells (output-stationary). It finds
// the samples that can reach its tile by binary search on the sorted ilo
// (the bounds of the TPU wrapper's searchsorted), stages them through
// shared memory in chunks (a clustered light curve can put many samples
// in one tile, so the range is never assumed to fit), and each thread sums
// the contributions to its own cells in registers, in sample order. The
// sum is fp32 and deterministic. The TPU kernel's one-hot MXU matmuls and
// bf16 head+tail split existed only because the MXU truncates f32 inputs;
// they have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCellsPerThread = 8;  // two float4 stores per plane
constexpr int kTile = kThreads * kCellsPerThread;  // cells per block
constexpr int kChunk = 512;  // samples staged in shared memory per pass

// First index in a[0, n) with a[index] >= key (a sorted ascending).
__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
spread_kernel(const int* __restrict__ ilo, const float* __restrict__ u_re,
              const float* __restrict__ u_im, const float* __restrict__ lag,
              int n, int taps, int nfft, float* __restrict__ out_re,
              float* __restrict__ out_im) {
  extern __shared__ float smem[];
  int* s_ilo = reinterpret_cast<int*>(smem);
  float* s_ure = smem + kChunk;
  float* s_uim = s_ure + kChunk;
  float* s_lag = s_uim + kChunk;  // [kChunk, taps]
  __shared__ int s_range[2];

  const int tile_base = blockIdx.x * kTile;
  // samples whose taps reach [tile_base, tile_base + kTile)
  if (threadIdx.x == 0) s_range[0] = lower_bound(ilo, n, tile_base - (taps - 1));
  if (threadIdx.x == 1) s_range[1] = lower_bound(ilo, n, tile_base + kTile);
  __syncthreads();
  const int start = s_range[0];
  const int end = s_range[1];

  const int c0 = tile_base + threadIdx.x * kCellsPerThread;
  const int c_last = c0 + kCellsPerThread - 1;
  float acc_re[kCellsPerThread];
  float acc_im[kCellsPerThread];
#pragma unroll
  for (int k = 0; k < kCellsPerThread; ++k) {
    acc_re[k] = 0.0f;
    acc_im[k] = 0.0f;
  }

  for (int base = start; base < end; base += kChunk) {
    const int m = min(kChunk, end - base);
    for (int i = threadIdx.x; i < m; i += kThreads) {
      s_ilo[i] = ilo[base + i];
      s_ure[i] = u_re[base + i];
      s_uim[i] = u_im[base + i];
    }
    const float* lag_chunk = lag + static_cast<size_t>(base) * taps;
    for (int i = threadIdx.x; i < m * taps; i += kThreads) {
      s_lag[i] = lag_chunk[i];
    }
    __syncthreads();
    // this thread's samples: ilo in [c0 - taps + 1, c_last], contiguous
    // because ilo is sorted
    for (int s = lower_bound(s_ilo, m, c0 - (taps - 1));
         s < m && s_ilo[s] <= c_last; ++s) {
      const int off = c0 - s_ilo[s];  // cell c0 + k takes tap off + k
      const float ur = s_ure[s];
      const float ui = s_uim[s];
      const float* l = s_lag + s * taps;
#pragma unroll
      for (int k = 0; k < kCellsPerThread; ++k) {
        const int j = off + k;
        if (j >= 0 && j < taps) {
          acc_re[k] = fmaf(ur, l[j], acc_re[k]);
          acc_im[k] = fmaf(ui, l[j], acc_im[k]);
        }
      }
    }
    __syncthreads();
  }

  // nfft is a power of two >= 512, so c0 < nfft implies c_last < nfft
  if (c0 < nfft) {
    float4* re4 = reinterpret_cast<float4*>(out_re + c0);
    float4* im4 = reinterpret_cast<float4*>(out_im + c0);
    re4[0] = make_float4(acc_re[0], acc_re[1], acc_re[2], acc_re[3]);
    re4[1] = make_float4(acc_re[4], acc_re[5], acc_re[6], acc_re[7]);
    im4[0] = make_float4(acc_im[0], acc_im[1], acc_im[2], acc_im[3]);
    im4[1] = make_float4(acc_im[4], acc_im[5], acc_im[6], acc_im[7]);
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 on success). The caller checks shapes, dtypes, contiguity, and
// 1 <= taps <= 16 (the shared-memory stage stays under 48 KB).
extern "C" int extirpolate_grid_factored_f32(
    const int* ilo, const float* u_re, const float* u_im, const float* lag,
    int n, int taps, int nfft, float* out_re, float* out_im, void* stream) {
  const int blocks = (nfft + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(kChunk) * (3 + taps) * sizeof(float);
  spread_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ilo, u_re, u_im, lag, n, taps, nfft, out_re, out_im);
  return static_cast<int>(cudaGetLastError());
}
