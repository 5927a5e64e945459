// Press-Rybicki spreading ("extirpolation") onto an nfft grid, for Hopper
// (sm_90a): one span-walk kernel for both spreading entry points. Plain C
// interface, loaded with ctypes by periodicity_tpu_torch/ops/_kernels.py.
//
// extirpolate_grid_factored_f32 replaces the TPU kernel
// periodicity_tpu/ops/pallas_grid2.py::extirpolate_grid_factored (B1, the
// GLS main path, two launches per periodogram):
//
//     grid[ilo[i] + j] += u[i] * lag[i, j]      for j < taps, 1 <= taps <= 16;
//
// extirpolate_grid_f32 replaces periodicity_tpu/ops/pallas_grid.py::
// extirpolate_grid (B3):
//
//     grid[ilo[i] + j] += vals[i, j]            for j < 4,
//
// with ilo sorted ascending and ilo[i] + taps <= nfft (no wrap). Both write
// one interleaved complex64 grid (what cuFFT reads) or two f32 planes.
//
// What bounds it on the card: the grid writes. At N = 1e5 and 2^23 cells it
// writes 64 MB of complex64 against 2.8 MB (factored) or 3.6 MB of input,
// about 20 us at 3.35 TB/s. The first design ran a block per 2048-cell
// tile, and every block first waited on two 17-step dependent binary
// searches in global memory and a staging barrier before its first store,
// empty tiles included; the stores were a small part of each block's life.
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
// - From there the block's samples come in order. A ring in shared memory
//   holds the per-tap values of the samples that can reach the current
//   tile (512 samples at 4 taps, 128 at up to 16) and is topped up only
//   when the tile may need more than it holds, so most tiles wait on no
//   load and no barrier; a tile that no sample reaches stores its zeros at
//   once. A factored sample is staged as its 2 * taps products u * lag,
//   formed as the ring is filled: the sums below are then the same code
//   for both entry points.
// - Each thread sums the taps that reach its 8 cells in registers, in
//   sample order: fp32 and deterministic.
// - A tile that more samples reach than the ring holds (a clustered light
//   curve) is split over the whole block: see dense_tile.
// - A warp's 256 cells (2 KB of complex64) go out through a 2 KB buffer in
//   shared memory, swizzled so that neither side has bank conflicts: a
//   lane's own 8 cells are 64 contiguous bytes, and four 16-byte stores of
//   them from each lane would write every line of the warp's 2 KB in
//   pieces.
//
// Arithmetic: a factored tap is u * lag rounded to f32 on its own
// (__fmul_rn, never contracted into the sum), as the plain version's
// u_re[:, None] * lag rounds it; so at 4 taps the factored kernel gives the
// same bits as the unfactored one fed those products.

#include <cuda_runtime.h>

#include "launch_cache.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCells = 8;  // contiguous cells per thread
constexpr int kTile = kThreads * kCells;  // cells per step of a block
constexpr int kSub = 32 * kCells;  // a warp's cells of a tile
// f32 in the ring's staged values; a dense tile reuses them for its
// partial sums, one float2 per cell of a sub-tile for each warp
constexpr int kStage = 4096;
static_assert(kStage == kWarps * kSub * 2, "the partial sums fill the ring");

// Where a sample's tap values come from. load(i, v) gives sample i's
// taps in v[0, taps) as (re, im) pairs, and zeros above taps.

// The complex64 values [N, 4] as they lie in memory (16-byte aligned).
struct Unfactored {
  static constexpr int kMaxTaps = 4;
  const float* vals;

  __device__ __forceinline__ int taps() const { return 4; }
  __device__ __forceinline__ void load(int i, float2 (&v)[kMaxTaps]) const {
    const float4* src = reinterpret_cast<const float4*>(vals) + 2 * static_cast<size_t>(i);
    const float4 a = __ldg(src);
    const float4 b = __ldg(src + 1);
    v[0] = make_float2(a.x, a.y);
    v[1] = make_float2(a.z, a.w);
    v[2] = make_float2(b.x, b.y);
    v[3] = make_float2(b.z, b.w);
  }
};

// u_re, u_im [N] with lag [N, taps]; kMaxTaps = 4 fixes taps at 4 (every
// estimator path; lag 16-byte aligned), 16 takes any taps in [1, 16] at
// run time.
template <int kMaxTaps_>
struct Factored {
  static constexpr int kMaxTaps = kMaxTaps_;
  const float* u_re;
  const float* u_im;
  const float* lag;
  int n_taps;

  __device__ __forceinline__ int taps() const { return kMaxTaps == 4 ? 4 : n_taps; }
  __device__ __forceinline__ void load(int i, float2 (&v)[kMaxTaps]) const {
    const float a = __ldg(u_re + i);
    const float b = __ldg(u_im + i);
    float l[kMaxTaps];
    if constexpr (kMaxTaps == 4) {
      const float4 row = __ldg(reinterpret_cast<const float4*>(lag) + i);
      l[0] = row.x;
      l[1] = row.y;
      l[2] = row.z;
      l[3] = row.w;
    } else {
      const float* row = lag + static_cast<size_t>(i) * n_taps;
#pragma unroll
      for (int j = 0; j < kMaxTaps; ++j) l[j] = j < n_taps ? __ldg(row + j) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j) v[j] = make_float2(__fmul_rn(a, l[j]), __fmul_rn(b, l[j]));
  }
};

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
// the ring (slot s & mask), else hi.
__device__ __forceinline__ int ring_lower_bound(const int* s_ilo, int mask, int lo, int hi,
                                                int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (s_ilo[mid & mask] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The same over global memory.
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

// Adds a sample's taps v[0, taps) (re, im pairs) to the cells c0 + k of a
// thread's accumulators that they reach: cell c0 + k takes tap off + k.
__device__ __forceinline__ void add_taps(float (&acc_re)[kCells], float (&acc_im)[kCells],
                                         int off, int taps, const float2* v) {
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int j = off + k;
    if (j >= 0 && j < taps) {
      const float2 z = v[j];
      acc_re[k] += z.x;
      acc_im[k] += z.y;
    }
  }
}

// Sample s's base and taps, or -1 and zeros for s >= hi.
template <class Src>
__device__ __forceinline__ void load_sample(const int* __restrict__ ilo, const Src& src, int s,
                                            int hi, int& key, float2 (&vals)[Src::kMaxTaps]) {
  if (s < hi) {
    key = __ldg(ilo + s);
    src.load(s, vals);
  } else {
    key = -1;
#pragma unroll
    for (int j = 0; j < Src::kMaxTaps; ++j) vals[j] = make_float2(0.0f, 0.0f);
  }
}

// A tile [base, tile_hi) that more samples reach than the ring holds (a
// clustered light curve), summed by the whole block: its samples, from
// `cur` on, are read from global memory, where they stay in L2. The tile
// is taken in sub-tiles of 256 cells. For each, warp w sums the w-th
// contiguous eighth of the samples that reach the sub-tile into its own
// partial sums in shared memory, 32 samples at a time: the lanes that hold
// one base add their taps in lane order (a segmented scan over the warp),
// and the last of them adds the run to the partial sum of each tap's cell.
// Then the warp that owns the sub-tile's cells adds the eight partial sums
// in warp order. The split is fixed by the data alone: deterministic, with
// no atomics. Returns the next tile's first sample.
template <class Src>
__device__ __forceinline__ int dense_tile(const int* __restrict__ ilo, const Src& src, int taps,
                                          int n, int cur, int base, int tile_hi, float2* part,
                                          int* s_bounds, float (&acc_re)[kCells],
                                          float (&acc_im)[kCells]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the partial sums overwrite the ring: every thread is done reading it
  if (threadIdx.x <= 2 * kWarps) {
    // the first sample reaching each sub-tile, the first past it, and the
    // next tile's first sample
    const int t = threadIdx.x;
    const int key = t == 2 * kWarps ? tile_hi - (taps - 1)
                                    : base + (t >> 1) * kSub + ((t & 1) ? kSub : -(taps - 1));
    s_bounds[t] = global_lower_bound(ilo, cur, n, key);
  }
  for (int i = threadIdx.x; i < kWarps * kSub; i += kThreads) part[i] = make_float2(0.0f, 0.0f);
  __syncthreads();
  float2* mine = part + warp * kSub;
  for (int sub = 0; sub < kWarps; ++sub) {
    const int sb = base + sub * kSub;
    if (sb >= tile_hi) break;  // the same for the whole block
    const int a = s_bounds[2 * sub];
    const long long m = s_bounds[2 * sub + 1] - a;
    const int hi = a + static_cast<int>(m * (warp + 1) / kWarps);
    // each batch of 32 samples is loaded while the batch before it is
    // summed, all of a sample's taps at once (a load after each tap's
    // __syncwarp would wait on L2 once a tap)
    const int lo = a + static_cast<int>(m * warp / kWarps);
    int next_key;
    float2 next_vals[Src::kMaxTaps];
    load_sample(ilo, src, lo + lane, hi, next_key, next_vals);
    for (int s0 = lo; s0 < hi; s0 += 32) {
      const bool live = s0 + lane < hi;
      const int key = next_key;
      float2 vals[Src::kMaxTaps];
#pragma unroll
      for (int j = 0; j < Src::kMaxTaps; ++j) vals[j] = next_vals[j];
      load_sample(ilo, src, s0 + 32 + lane, hi, next_key, next_vals);
      // the lanes that hold one base are contiguous (ilo is sorted);
      // same[r]: lane - 2^r holds this lane's base
      bool same[5];
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        const int up = __shfl_up_sync(0xffffffffu, key, 1 << r);
        same[r] = lane >= (1 << r) && up == key;
      }
      const int next = __shfl_down_sync(0xffffffffu, key, 1);
      const bool last = live && (lane == 31 || next != key);
#pragma unroll
      for (int j = 0; j < Src::kMaxTaps; ++j) {
        if (j >= taps) break;  // the same for the whole warp
        float2 v = vals[j];
#pragma unroll
        for (int r = 0; r < 5; ++r) {
          const float x = __shfl_up_sync(0xffffffffu, v.x, 1 << r);
          const float y = __shfl_up_sync(0xffffffffu, v.y, 1 << r);
          if (same[r]) {
            v.x += x;
            v.y += y;
          }
        }
        // the last lane of each base holds its run; bases differ, so
        // cells of one tap do too
        const int c = key + j - sb;
        if (last && c >= 0 && c < kSub) {
          float2 p = mine[c];
          p.x += v.x;
          p.y += v.y;
          mine[c] = p;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    if (warp == sub) {
      // this warp's cells of the sub-tile, 8 * lane + k; zeroed after for
      // the next sub-tile
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
          float2& p = part[w * kSub + kCells * lane + k];
          acc_re[k] += p.x;
          acc_im[k] += p.y;
          p = make_float2(0.0f, 0.0f);
        }
      }
    }
    __syncthreads();
  }
  return s_bounds[2 * kWarps];
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

template <class Src>
__global__ void __launch_bounds__(kThreads)
spread_walk_kernel(const int* __restrict__ ilo, const Src src, int n, int nfft,
                   float* __restrict__ out_re, float* __restrict__ out_im,
                   float* __restrict__ out_c) {
  constexpr int kFloats = 2 * Src::kMaxTaps;  // f32 per staged sample
  constexpr int kRing = kStage / kFloats;  // staged samples, a power of two
  constexpr int kMask = kRing - 1;
  __shared__ int s_ilo[kRing];
  __shared__ __align__(16) float s_val[kStage];
  __shared__ float4 s_out[kThreads * kCells / 2];  // 2 KB of output a warp
  __shared__ int s_first;
  __shared__ int s_bounds[2 * kWarps + 1];
  const int taps = src.taps();

  // this block's span of cells; nfft and the span ends are multiples of 8
  const long long units = nfft / kCells;
  const int span_lo = static_cast<int>(units * blockIdx.x / gridDim.x) * kCells;
  const int span_hi = static_cast<int>(units * (blockIdx.x + 1) / gridDim.x) * kCells;
  if (span_lo >= span_hi) return;

  if (threadIdx.x < 32) {
    const int first = warp_lower_bound(ilo, n, span_lo - (taps - 1));
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
        s_ilo[slot] = __ldg(ilo + i);
        float2 v[Src::kMaxTaps];
        src.load(i, v);
        float4* dst = reinterpret_cast<float4*>(s_val + slot * kFloats);
#pragma unroll
        for (int q = 0; q < Src::kMaxTaps / 2; ++q) {
          dst[q] = make_float4(v[2 * q].x, v[2 * q].y, v[2 * q + 1].x, v[2 * q + 1].y);
        }
      }
      w_hi = end;
      __syncthreads();
      covered = w_hi == n || s_ilo[(w_hi - 1) & kMask] >= tile_hi;
    }
    if (covered) {
      const bool empty = cur == w_hi || s_ilo[cur & kMask] >= tile_hi;
      if (!empty && c0 < tile_hi) {
        // this thread's samples: ilo in [c0 - taps + 1, c0 + 7], contiguous
        for (int s = ring_lower_bound(s_ilo, kMask, cur, w_hi, c0 - (taps - 1)); s < w_hi; ++s) {
          const int slot = s & kMask;
          const int off = c0 - s_ilo[slot];  // cell c0 + k takes tap off + k
          if (off < -(kCells - 1)) break;
          add_taps(acc_re, acc_im, off, taps, reinterpret_cast<const float2*>(s_val + slot * kFloats));
        }
      }
      // the next tile's first sample, the first with ilo >= tile_hi -
      // taps + 1, is staged too
      cur = ring_lower_bound(s_ilo, kMask, cur, w_hi, tile_hi - (taps - 1));
    } else {
      // more samples reach the tile than the ring holds; the ring starts
      // again at the next tile
      cur = dense_tile(ilo, src, taps, n, cur, base, tile_hi, reinterpret_cast<float2*>(s_val),
                       s_bounds, acc_re, acc_im);
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

template <class Src>
int launch(const int* ilo, const Src& src, int n, int nfft, float* out_re, float* out_im,
           float* out_c, void* stream) {
  int resident = 0;
  const cudaError_t err = launch_cache::resident_blocks(
      reinterpret_cast<const void*>(spread_walk_kernel<Src>), kThreads, 0, 0, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (nfft + kTile - 1) / kTile;
  const int blocks = tiles < resident ? tiles : resident;
  spread_walk_kernel<Src><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ilo, src, n, nfft, out_re, out_im, out_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` without synchronising and return
// cudaGetLastError() (0 on success), or the error of the launch set-up.
// With out_c non-null the grid goes there as interleaved complex64 [nfft]
// and out_re, out_im are not touched; otherwise into the two f32 planes.
// nfft is a multiple of 8. The callers check shapes, dtypes and
// contiguity.

// u_re, u_im: f32 [N]; lag: f32 [N, taps], 1 <= taps <= 16, 16-byte
// aligned when taps == 4.
extern "C" int extirpolate_grid_factored_f32(const int* ilo, const float* u_re,
                                             const float* u_im, const float* lag, int n,
                                             int taps, int nfft, float* out_re, float* out_im,
                                             float* out_c, void* stream) {
  if (taps == 4) {
    return launch(ilo, Factored<4>{u_re, u_im, lag, 4}, n, nfft, out_re, out_im, out_c, stream);
  }
  return launch(ilo, Factored<16>{u_re, u_im, lag, taps}, n, nfft, out_re, out_im, out_c,
                stream);
}

// vals: the complex64 [N, 4] values as f32 (re, im) pairs, 16-byte aligned.
extern "C" int extirpolate_grid_f32(const int* ilo, const float* vals, int n, int nfft,
                                    float* out_re, float* out_im, float* out_c, void* stream) {
  return launch(ilo, Unfactored{vals}, n, nfft, out_re, out_im, out_c, stream);
}
