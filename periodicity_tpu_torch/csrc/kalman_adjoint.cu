// K2's plain C interface at R = 1 to 16 states. The kernels, their design
// and what bounds them are in kalman_adjoint.cuh; this unit instantiates R
// <= 8, and each wider width lives beside K1's in its unit (kalman_r*.cu),
// which nvcc builds in parallel.

#include "kalman_adjoint.cuh"

PERIODICITY_KALMAN_ADJOINT_EXTERN(9)
PERIODICITY_KALMAN_ADJOINT_EXTERN(10)
PERIODICITY_KALMAN_ADJOINT_EXTERN(11)
PERIODICITY_KALMAN_ADJOINT_EXTERN(12)
PERIODICITY_KALMAN_ADJOINT_EXTERN(13)
PERIODICITY_KALMAN_ADJOINT_EXTERN(14)
PERIODICITY_KALMAN_ADJOINT_EXTERN(15)
PERIODICITY_KALMAN_ADJOINT_EXTERN(16)

namespace {

// every grid below 2^31 blocks
bool valid_adjoint_shape(int b, int n, int r, int nb) {
  return b >= 1 && n >= 1 && nb >= 1 && r >= 1 && r <= kMaxR &&
         static_cast<long long>(b) * n * (3 * r * r + 2 * r) < (1LL << 36);
}

#define PERIODICITY_KALMAN_ADJOINT_SWITCH(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) \
  CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

template <typename T>
cudaError_t adjoint(const T* A, const T* Q, const T* H, const T* diag, const T* y,
                    const T* carry_in, const T* prefixes, const T* dmu, const T* ds,
                    const T* dcarry_out, int b, int n, int r, int nb, T* levels, T* dtree,
                    T* dpre, T* share, T* dA, T* dQ, T* ddiag, T* dy, T* dcarry_in,
                    cudaStream_t stream) {
  if (!valid_adjoint_shape(b, n, r, nb)) return cudaErrorInvalidValue;
  switch (r) {
#define PERIODICITY_KALMAN_ADJOINT_CASE(RR)                                                   \
  case RR:                                                                                    \
    return kalman_k::Adjoint<T, RR>::launch(A, Q, H, diag, y, carry_in, prefixes, dmu, ds,    \
                                            dcarry_out, b, n, nb, levels, dtree, dpre, share, \
                                            dA, dQ, ddiag, dy, dcarry_in, stream);
    PERIODICITY_KALMAN_ADJOINT_SWITCH(PERIODICITY_KALMAN_ADJOINT_CASE)
#undef PERIODICITY_KALMAN_ADJOINT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t describe_adjoint(int b, int n, int r, int nb, int carry, int* geo, int* attr) {
  switch (r) {
#define PERIODICITY_KALMAN_ADJOINT_CASE(RR)                                \
  case RR:                                                                 \
    if (geo) kalman_k::Adjoint<T, RR>::geometry(b, n, nb, carry, geo);     \
    return attr ? kalman_k::Adjoint<T, RR>::attributes(attr) : cudaSuccess;
    PERIODICITY_KALMAN_ADJOINT_SWITCH(PERIODICITY_KALMAN_ADJOINT_CASE)
#undef PERIODICITY_KALMAN_ADJOINT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

static_assert(kMaxR == 16, "the switches above take R = 1..16");

}  // namespace

extern "C" {

int kalman_blocked_adjoint_f32(const float* A, const float* Q, const float* H,
                               const float* diag, const float* y, const float* carry_in,
                               const float* prefixes, const float* dmu, const float* ds,
                               const float* dcarry_out, int b, int n, int r, int nb,
                               float* levels, float* dtree, float* dpre, float* share,
                               float* dA, float* dQ, float* ddiag, float* dy, float* dcarry_in,
                               cudaStream_t stream) {
  return static_cast<int>(adjoint<float>(A, Q, H, diag, y, carry_in, prefixes, dmu, ds,
                                         dcarry_out, b, n, r, nb, levels, dtree, dpre, share,
                                         dA, dQ, ddiag, dy, dcarry_in, stream));
}

int kalman_blocked_adjoint_f64(const double* A, const double* Q, const double* H,
                               const double* diag, const double* y, const double* carry_in,
                               const double* prefixes, const double* dmu, const double* ds,
                               const double* dcarry_out, int b, int n, int r, int nb,
                               double* levels, double* dtree, double* dpre, double* share,
                               double* dA, double* dQ, double* ddiag, double* dy,
                               double* dcarry_in, cudaStream_t stream) {
  return static_cast<int>(adjoint<double>(A, Q, H, diag, y, carry_in, prefixes, dmu, ds,
                                          dcarry_out, b, n, r, nb, levels, dtree, dpre, share,
                                          dA, dQ, ddiag, dy, dcarry_in, stream));
}

// K2's launch geometry for b rows of n samples at r states over nb blocks,
// with an incoming carry or not: 10 ints (see kalman_k::Adjoint::geometry)
int kalman_blocked_adjoint_geometry(int b, int n, int r, int nb, int carry, int elem_size,
                                    int* out) {
  if (!valid_adjoint_shape(b, n, r, nb)) return static_cast<int>(cudaErrorInvalidValue);
  if (elem_size == 4)
    return static_cast<int>(describe_adjoint<float>(b, n, r, nb, carry, out, nullptr));
  if (elem_size == 8)
    return static_cast<int>(describe_adjoint<double>(b, n, r, nb, carry, out, nullptr));
  return static_cast<int>(cudaErrorInvalidValue);
}

// the six kernels' compiled resources at r states: 18 ints (see
// kalman_k::Adjoint::attributes)
int kalman_blocked_adjoint_attributes(int r, int elem_size, int* out) {
  if (r < 1 || r > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  if (elem_size == 4)
    return static_cast<int>(describe_adjoint<float>(1, 1, r, 1, 0, nullptr, out));
  if (elem_size == 8)
    return static_cast<int>(describe_adjoint<double>(1, 1, r, 1, 0, nullptr, out));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
