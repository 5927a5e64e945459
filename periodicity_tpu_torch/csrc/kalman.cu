// K1's plain C interface at R = 1 to 16 states, and a card check of its
// float32 division. The kernels, their design and what bounds them are in
// kalman.cuh; this unit instantiates R <= 8, and each wider width lives in
// a unit of its own (kalman_r*.cu), which nvcc builds in parallel.

#include "kalman.cuh"

PERIODICITY_KALMAN_EXTERN(9)
PERIODICITY_KALMAN_EXTERN(10)
PERIODICITY_KALMAN_EXTERN(11)
PERIODICITY_KALMAN_EXTERN(12)
PERIODICITY_KALMAN_EXTERN(13)
PERIODICITY_KALMAN_EXTERN(14)
PERIODICITY_KALMAN_EXTERN(15)
PERIODICITY_KALMAN_EXTERN(16)

namespace {

// A check of Divisor<float>::quot against __fdiv_rn on n float32 pairs (a
// card test):
// mode 0 hashed bit patterns anywhere (zeros, subnormals, infinities and
// NaNs included); 1 numerators with exponents from the subnormal range to
// 2^-86 over divisors within 2^+-30 (tiny and subnormal quotients); 2 zero
// numerators; 3 small odd multiples of 2^-149 over powers of two within
// 2^+-8 (quotients on subnormal rounding midpoints); 4 both within
// 2^+-60. out[0] gets the pairs whose bit patterns differ (NaN for NaN),
// out[1] those with finite nonzero operands (the float64 path).
__global__ void quot_check_kernel(unsigned long long n, int mode, unsigned long long* out) {
  unsigned long long bad = 0, fast = 0;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long k = blockIdx.x * static_cast<unsigned long long>(blockDim.x) +
                              threadIdx.x;
       k < n; k += stride) {
    const unsigned long long h = rn::mix(k * 8 + mode);
    unsigned ua = static_cast<unsigned>(h), ud = static_cast<unsigned>(h >> 32);
    if (mode == 1) {
      ua = (ua & 0x807fffffu) | (((ua >> 23) & 0xffu) % 42u) << 23;
      ud = (ud & 0x807fffffu) | (((ud >> 23) & 0xffu) % 61u + 97u) << 23;
    } else if (mode == 2) {
      ua &= 0x80000000u;
    } else if (mode == 3) {
      ua = (ua & 0x80000000u) | ((ua & 0xffffu) | 1u);
      ud = (ud & 0x80000000u) | ((((ud >> 8) & 0xffu) % 17u + 119u) << 23);
    } else if (mode == 4) {
      ua = (ua & 0x807fffffu) | (((ua >> 23) & 0xffu) % 121u + 67u) << 23;
      ud = (ud & 0x807fffffu) | (((ud >> 23) & 0xffu) % 121u + 67u) << 23;
    }
    const float a = __uint_as_float(ua), d = __uint_as_float(ud);
    const float q = Divisor<float>(d).quot(a), w = __fdiv_rn(a, d);
    fast += isfinite(a) & isfinite(d) & (a != 0.0f) & (d != 0.0f) ? 1 : 0;
    bad += (q != q) != (w != w) || (q == q && __float_as_uint(q) != __float_as_uint(w)) ? 1 : 0;
  }
  atomicAdd(out, bad);
  atomicAdd(out + 1, fast);
}

// every grid below 2^31 blocks
bool valid_shape(int b, int n, int r, int nb) {
  return b >= 1 && n >= 1 && nb >= 1 && r >= 1 && r <= kMaxR &&
         static_cast<long long>(b) * n < (1LL << 34);
}

// PERIODICITY_KALMAN_SWITCH(CASE) expands CASE(R) for every width
#define PERIODICITY_KALMAN_SWITCH(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) \
  CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

template <typename T>
cudaError_t blocked(const T* A, const T* Q, const T* H, const T* diag, const T* y,
                    const T* carry_in, int b, int n, int r, int nb, T* elems, T* tree, T* mu,
                    T* s, T* carry_out, cudaStream_t stream) {
  if (!valid_shape(b, n, r, nb)) return cudaErrorInvalidValue;
  switch (r) {
#define PERIODICITY_KALMAN_CASE(RR)                                                         \
  case RR:                                                                                  \
    return kalman_k::Width<T, RR>::launch(A, Q, H, diag, y, carry_in, b, n, nb, elems, tree, \
                                          mu, s, carry_out, stream);
    PERIODICITY_KALMAN_SWITCH(PERIODICITY_KALMAN_CASE)
#undef PERIODICITY_KALMAN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t describe(int b, int n, int r, int nb, int carry, int* geo, int* attr) {
  switch (r) {
#define PERIODICITY_KALMAN_CASE(RR)                                         \
  case RR:                                                                  \
    if (geo) kalman_k::Width<T, RR>::geometry(b, n, nb, carry, geo);        \
    return attr ? kalman_k::Width<T, RR>::attributes(attr) : cudaSuccess;
    PERIODICITY_KALMAN_SWITCH(PERIODICITY_KALMAN_CASE)
#undef PERIODICITY_KALMAN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

static_assert(kMaxR == 16, "the switches above take R = 1..16");

}  // namespace

extern "C" {

int kalman_blocked_f32(const float* A, const float* Q, const float* H, const float* diag,
                       const float* y, const float* carry_in, int b, int n, int r, int nb,
                       float* elems, float* tree, float* mu, float* s, float* carry_out,
                       cudaStream_t stream) {
  return static_cast<int>(
      blocked<float>(A, Q, H, diag, y, carry_in, b, n, r, nb, elems, tree, mu, s, carry_out,
                     stream));
}

int kalman_blocked_f64(const double* A, const double* Q, const double* H, const double* diag,
                       const double* y, const double* carry_in, int b, int n, int r, int nb,
                       double* elems, double* tree, double* mu, double* s, double* carry_out,
                       cudaStream_t stream) {
  return static_cast<int>(
      blocked<double>(A, Q, H, diag, y, carry_in, b, n, r, nb, elems, tree, mu, s, carry_out,
                      stream));
}

int kalman_quot_check_f32(unsigned long long n, int mode, unsigned long long* out,
                          cudaStream_t stream) {
  quot_check_kernel<<<132 * 8, 256, 0, stream>>>(n, mode, out);
  return static_cast<int>(cudaGetLastError());
}

// K1's launch geometry for b rows of n samples at r states over nb blocks,
// with an incoming carry or not, in float32 (elem_size 4) or float64 (8):
// 15 ints (see kalman_k::Width::geometry)
int kalman_blocked_geometry(int b, int n, int r, int nb, int carry, int elem_size, int* out) {
  if (!valid_shape(b, n, r, nb)) return static_cast<int>(cudaErrorInvalidValue);
  if (elem_size == 4) return static_cast<int>(describe<float>(b, n, r, nb, carry, out, nullptr));
  if (elem_size == 8) return static_cast<int>(describe<double>(b, n, r, nb, carry, out, nullptr));
  return static_cast<int>(cudaErrorInvalidValue);
}

// the four stages' compiled resources at r states: 12 ints (see
// kalman_k::Width::attributes)
int kalman_blocked_attributes(int r, int elem_size, int* out) {
  if (r < 1 || r > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  if (elem_size == 4) return static_cast<int>(describe<float>(1, 1, r, 1, 0, nullptr, out));
  if (elem_size == 8) return static_cast<int>(describe<double>(1, 1, r, 1, 0, nullptr, out));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
