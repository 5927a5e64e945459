// Spreading of unfactored per-tap complex values onto an nfft grid, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// periodicity_tpu_torch/ops/_kernels.py.
//
// Replaces the TPU kernel periodicity_tpu/ops/pallas_grid.py::extirpolate_grid:
//
//     grid[ilo[i] + j] += vals[i, j]      for j < 4,
//
// with ilo sorted ascending, ilo[i] + 4 <= nfft (no wrap), and vals the
// complex64 [N, 4] values as they lie in memory (re, im pairs). It writes
// one interleaved complex64 grid or two f32 planes.
//
// What bounds it on the card: the grid writes. At N = 1e5 and 2^23 cells it
// writes 64 MB of complex64 against 3.6 MB of input, about 21 us at
// 3.35 TB/s. The first design (the factored kernel's template, still used
// by extirpolate_grid.cu) ran a block per 2048-cell tile, and every block
// first waited on two 17-step dependent binary searches in global memory
// and a staging barrier before its first store, empty tiles included; the
// stores were a small part of each block's life.
//
// What this design does about it: every cell is still written exactly
// once (no zero-fill pass, no global atomics), every store instruction
// writes 512 contiguous bytes, and finding a cell's samples is taken off
// the path of the stores:
// - The grid is cut into as many contiguous spans as blocks fit on the
//   card at once (one wave; the spans differ by at most 8 cells), and each
//   block walks its span in tiles of 2048 cells, 8 contiguous cells per
//   thread.
// - A block finds its first sample once, with a search in which the 32
//   lanes of a warp probe 32 points per round: 4 rounds of one load each
//   for N = 1e5.
// - From there the block's samples come in order. A ring of 512 samples
//   in shared memory holds those that can reach the current tile and is
//   topped up only when the tile may need more than it holds, so most
//   tiles wait on no load and no barrier; a tile that no sample reaches
//   stores its zeros at once. A tile that more samples reach than the ring
//   holds (a clustered light curve) has every thread read its own samples
//   from global memory instead: the first design took such a tile in
//   ring-sized passes, each on the few threads whose cells it reached.
// - Each thread sums the taps that reach its 8 cells in registers, in
//   sample order: fp32 and deterministic, the same sums as the first
//   design.
// - A warp's 256 cells (2 KB of complex64) go out through a 2 KB buffer in
//   shared memory, swizzled so that neither side has bank conflicts: a
//   lane's own 8 cells are 64 contiguous bytes, and four 16-byte stores of
//   them from each lane (the first design's pattern) would write every
//   line of the warp's 2 KB in pieces.

#include <cuda_runtime.h>

#include "launch_cache.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 8;  // contiguous cells per thread
constexpr int kTile = kThreads * kCells;  // cells per step of a block
constexpr int kRing = 512;  // staged samples, a power of two
constexpr int kMask = kRing - 1;
constexpr int kTaps = 4;
constexpr int kFloats = 2 * kTaps;  // f32 per sample: re, im of each tap

// First index in a[0, n) with a[index] >= key (a sorted ascending), found by
// the 32 lanes of a warp together: each round probes 32 points of the
// range that holds the answer and keeps the gap between the last probe
// below the key and the first at or above it.
__device__ int warp_lower_bound(const int* __restrict__ a, int n, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0;
  int hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int probe = lo + static_cast<int>(static_cast<long long>(hi - lo) * (lane + 1) / 33);
    const int below = __popc(__ballot_sync(0xffffffffu, a[probe] < key));
    const int p_lo = __shfl_sync(0xffffffffu, probe, below > 0 ? below - 1 : 0);
    const int p_hi = __shfl_sync(0xffffffffu, probe, below < 32 ? below : 31);
    if (below > 0) lo = p_lo + 1;
    if (below < 32) hi = p_hi;
  }
  const bool below = lo + lane < hi && a[lo + lane] < key;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// First index s in [lo, hi) with ilo[s] >= key, over the samples staged in
// the ring (slot s & kMask), else hi.
__device__ __forceinline__ int ring_lower_bound(const int* s_ilo, int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (s_ilo[mid & kMask] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The same over global memory, for a tile whose samples overflow the ring.
__device__ __forceinline__ int global_lower_bound(const int* __restrict__ a, int lo, int hi,
                                                  int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Adds a sample's taps v[0, 4) (re, im pairs) to the cells c0 + k of a
// thread's accumulators that they reach: cell c0 + k takes tap off + k.
__device__ __forceinline__ void add_taps(float (&acc_re)[kCells], float (&acc_im)[kCells],
                                         int off, const float2* v) {
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int j = off + k;
    if (j >= 0 && j < kTaps) {
      const float2 z = v[j];
      acc_re[k] += z.x;
      acc_im[k] += z.y;
    }
  }
}

// Slot of float4 i in a warp's output buffer: the xor spreads both the
// lanes' own float4s (i = 4 * lane + k, or 2 * lane + k) and 32 consecutive
// float4s over all eight 16-byte bank groups.
__device__ __forceinline__ int swizzle(int i) { return i ^ ((i >> 3) & 7); }

// Writes the warp's `count` float4s of output, `kV` per lane in lane order
// (`mine`), to dst[0, count) with every store instruction covering 512
// contiguous bytes, through the warp's 2 KB buffer `buf`.
template <int kV>
__device__ __forceinline__ void warp_store(const float4 (&mine)[kV], bool active, int count,
                                           float4* buf, float4* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  if (active) {
#pragma unroll
    for (int k = 0; k < kV; ++k) buf[swizzle(kV * lane + k)] = mine[k];
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const int i = 32 * k + lane;
    if (i < count) dst[i] = buf[swizzle(i)];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
spread_walk_kernel(const int* __restrict__ ilo, const float* __restrict__ vals, int n, int nfft,
                   float* __restrict__ out_re, float* __restrict__ out_im,
                   float* __restrict__ out_c) {
  __shared__ int s_ilo[kRing];
  __shared__ __align__(16) float s_val[kRing * kFloats];
  __shared__ float4 s_out[kThreads * kCells / 2];  // 2 KB of output a warp
  __shared__ int s_first;

  // this block's span of cells; nfft and the span ends are multiples of 8
  const long long units = nfft / kCells;
  const int span_lo = static_cast<int>(units * blockIdx.x / gridDim.x) * kCells;
  const int span_hi = static_cast<int>(units * (blockIdx.x + 1) / gridDim.x) * kCells;
  if (span_lo >= span_hi) return;

  if (threadIdx.x < 32) {
    const int first = warp_lower_bound(ilo, n, span_lo - (kTaps - 1));
    if (threadIdx.x == 0) s_first = first;
  }
  __syncthreads();
  // Every thread keeps the same copy of the walk's state: `cur` is the
  // first sample that can reach the current tile, and samples [cur, w_hi)
  // are staged in the ring, sample i in slot i & kMask.
  int cur = s_first;
  int w_hi = cur;

  for (int base = span_lo; base < span_hi; base += kTile) {
    const int tile_hi = min(base + kTile, span_hi);
    const int c0 = base + threadIdx.x * kCells;
    float acc_re[kCells];
    float acc_im[kCells];
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      acc_re[k] = 0.0f;
      acc_im[k] = 0.0f;
    }
    // the ring holds every sample that reaches the tile once a staged
    // sample lies past the tile, or none is left; else top it up once
    bool covered = w_hi == n || (w_hi > cur && s_ilo[(w_hi - 1) & kMask] >= tile_hi);
    if (!covered && w_hi - cur < kRing) {
      // over the slots of samples before `cur`, once every thread is done
      // reading them
      __syncthreads();
      const int end = min(n, cur + kRing);
      for (int i = w_hi + threadIdx.x; i < end; i += kThreads) {
        const int slot = i & kMask;
        s_ilo[slot] = ilo[i];
        const float4* src = reinterpret_cast<const float4*>(vals + static_cast<size_t>(i) * kFloats);
        float4* dst = reinterpret_cast<float4*>(s_val + slot * kFloats);
        dst[0] = src[0];
        dst[1] = src[1];
      }
      w_hi = end;
      __syncthreads();
      covered = w_hi == n || s_ilo[(w_hi - 1) & kMask] >= tile_hi;
    }
    if (covered) {
      const bool empty = cur == w_hi || s_ilo[cur & kMask] >= tile_hi;
      if (!empty && c0 < tile_hi) {
        // this thread's samples: ilo in [c0 - 3, c0 + 7], contiguous
        for (int s = ring_lower_bound(s_ilo, cur, w_hi, c0 - (kTaps - 1)); s < w_hi; ++s) {
          const int slot = s & kMask;
          const int off = c0 - s_ilo[slot];  // cell c0 + k takes tap off + k
          if (off < -(kCells - 1)) break;
          add_taps(acc_re, acc_im, off, reinterpret_cast<const float2*>(s_val + slot * kFloats));
        }
      }
      // the next tile's first sample, the first with ilo >= tile_hi - 3,
      // is staged too
      cur = ring_lower_bound(s_ilo, cur, w_hi, tile_hi - (kTaps - 1));
    } else {
      // more samples reach the tile than the ring holds (a clustered light
      // curve): every thread reads its own from global memory, where they
      // stay in L2, and the ring starts again at the next tile
      if (c0 < tile_hi) {
        for (int s = global_lower_bound(ilo, cur, n, c0 - (kTaps - 1)); s < n; ++s) {
          const int off = c0 - ilo[s];
          if (off < -(kCells - 1)) break;
          add_taps(acc_re, acc_im, off,
                   reinterpret_cast<const float2*>(vals + static_cast<size_t>(s) * kFloats));
        }
      }
      cur = global_lower_bound(ilo, cur, n, tile_hi - (kTaps - 1));
      w_hi = cur;
    }

    // the warp's cells of this tile go out through its buffer in shared
    // memory, each store instruction covering 512 contiguous bytes; c0 and
    // the tile's end are multiples of 8, so c0 < tile_hi implies
    // c0 + 7 < tile_hi
    const int warp_c0 = base + (threadIdx.x & ~31) * kCells;
    const int warp_cells = max(0, min(32 * kCells, tile_hi - warp_c0));
    float4* buf = s_out + (threadIdx.x >> 5) * (32 * kCells / 2);
    const bool active = c0 < tile_hi;
    if (out_c != nullptr) {
      const float4 mine[4] = {make_float4(acc_re[0], acc_im[0], acc_re[1], acc_im[1]),
                              make_float4(acc_re[2], acc_im[2], acc_re[3], acc_im[3]),
                              make_float4(acc_re[4], acc_im[4], acc_re[5], acc_im[5]),
                              make_float4(acc_re[6], acc_im[6], acc_re[7], acc_im[7])};
      warp_store<4>(mine, active, warp_cells / 2, buf,
                    reinterpret_cast<float4*>(out_c + 2 * static_cast<size_t>(warp_c0)));
    } else {
      const float4 re[2] = {make_float4(acc_re[0], acc_re[1], acc_re[2], acc_re[3]),
                            make_float4(acc_re[4], acc_re[5], acc_re[6], acc_re[7])};
      const float4 im[2] = {make_float4(acc_im[0], acc_im[1], acc_im[2], acc_im[3]),
                            make_float4(acc_im[4], acc_im[5], acc_im[6], acc_im[7])};
      warp_store<2>(re, active, warp_cells / 4, buf, reinterpret_cast<float4*>(out_re + warp_c0));
      warp_store<2>(im, active, warp_cells / 4, buf, reinterpret_cast<float4*>(out_im + warp_c0));
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 on success), or the error of the launch set-up. vals: the complex64
// [N, 4] values as f32 (re, im) pairs, 16-byte aligned. With out_c
// non-null the grid goes there as interleaved complex64 [nfft] and out_re,
// out_im are not touched; otherwise into the two f32 planes. nfft is a
// multiple of 8.
extern "C" int extirpolate_grid_f32(const int* ilo, const float* vals, int n, int nfft,
                                    float* out_re, float* out_im, float* out_c,
                                    void* stream) {
  int resident = 0;
  const cudaError_t err = launch_cache::resident_blocks(
      reinterpret_cast<const void*>(spread_walk_kernel), kThreads, 0, 0, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (nfft + kTile - 1) / kTile;
  const int blocks = tiles < resident ? tiles : resident;
  spread_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ilo, vals, n, nfft, out_re, out_im, out_c);
  return static_cast<int>(cudaGetLastError());
}
