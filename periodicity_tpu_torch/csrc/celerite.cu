// The celerite kernels' plain C interface: G1, G2 and G3 at R = 1 to 16
// slots. The kernels, their design and what bounds them are in
// celerite.cuh; this unit instantiates R <= 8, and each wider width lives
// in a unit of its own (celerite_r*.cu), which nvcc builds in parallel.

#include "celerite.cuh"

PERIODICITY_CELERITE_EXTERN(9)
PERIODICITY_CELERITE_EXTERN(10)
PERIODICITY_CELERITE_EXTERN(11)
PERIODICITY_CELERITE_EXTERN(12)
PERIODICITY_CELERITE_EXTERN(13)
PERIODICITY_CELERITE_EXTERN(14)
PERIODICITY_CELERITE_EXTERN(15)
PERIODICITY_CELERITE_EXTERN(16)

namespace {

// PERIODICITY_CELERITE_SWITCH(CASE) expands CASE(R) for every width
#define PERIODICITY_CELERITE_SWITCH(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) \
  CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

template <typename T>
cudaError_t forward(const T* A, const T* U, const T* V, const T* P, const T* y, int b, int n,
                    int r, T* D, T* W, T* z, T* s_saved, T* f_saved, cudaStream_t stream) {
  if (b < 1 || n < 1 || (z && !y) || (s_saved && !f_saved)) return cudaErrorInvalidValue;
  switch (r) {
#define PERIODICITY_CELERITE_CASE(RR)                                                      \
  case RR:                                                                                 \
    return celerite_k::Width<T, RR>::forward(A, U, V, P, y, b, n, D, W, z, s_saved, f_saved, \
                                             stream);
    PERIODICITY_CELERITE_SWITCH(PERIODICITY_CELERITE_CASE)
#undef PERIODICITY_CELERITE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t adjoint(const T* U, const T* P, const T* D, const T* W, const T* z,
                    const T* s_saved, const T* f_saved, const T* dD, const T* dz, int b, int n,
                    int r, T* dA, T* dU, T* dV, T* dP, T* dy, cudaStream_t stream) {
  if (b < 1 || n < 1) return cudaErrorInvalidValue;
  switch (r) {
#define PERIODICITY_CELERITE_CASE(RR)                                                    \
  case RR:                                                                               \
    return celerite_k::Width<T, RR>::adjoint(U, P, D, W, z, s_saved, f_saved, dD, dz, b, n, \
                                             dA, dU, dV, dP, dy, stream);
    PERIODICITY_CELERITE_SWITCH(PERIODICITY_CELERITE_CASE)
#undef PERIODICITY_CELERITE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// every kernel's compiled resources at r slots (Width::attributes)
template <typename T>
cudaError_t attributes(int r, int* out) {
  switch (r) {
#define PERIODICITY_CELERITE_CASE(RR) \
  case RR:                            \
    return celerite_k::Width<T, RR>::attributes(out);
    PERIODICITY_CELERITE_SWITCH(PERIODICITY_CELERITE_CASE)
#undef PERIODICITY_CELERITE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t solve(const T* U, const T* P, const T* D, const T* W, const T* Y, int n, int r,
                  int k, T* X, cudaStream_t stream) {
  if (n < 1 || k < 1) return cudaErrorInvalidValue;
  switch (r) {
#define PERIODICITY_CELERITE_CASE(RR) \
  case RR:                            \
    return celerite_k::Width<T, RR>::solve(U, P, D, W, Y, n, k, X, stream);
    PERIODICITY_CELERITE_SWITCH(PERIODICITY_CELERITE_CASE)
#undef PERIODICITY_CELERITE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

static_assert(kMaxR == 16, "the switches above take R = 1..16");

}  // namespace

extern "C" {

int celerite_forward_f32(const float* A, const float* U, const float* V, const float* P,
                         const float* y, int b, int n, int r, float* D, float* W, float* z,
                         float* s_saved, float* f_saved, cudaStream_t stream) {
  return static_cast<int>(forward<float>(A, U, V, P, y, b, n, r, D, W, z, s_saved, f_saved,
                                         stream));
}

int celerite_forward_f64(const double* A, const double* U, const double* V, const double* P,
                         const double* y, int b, int n, int r, double* D, double* W, double* z,
                         double* s_saved, double* f_saved, cudaStream_t stream) {
  return static_cast<int>(forward<double>(A, U, V, P, y, b, n, r, D, W, z, s_saved, f_saved,
                                          stream));
}

int celerite_adjoint_f32(const float* U, const float* P, const float* D, const float* W,
                         const float* z, const float* s_saved, const float* f_saved,
                         const float* dD, const float* dz, int b, int n, int r, float* dA,
                         float* dU, float* dV, float* dP, float* dy, cudaStream_t stream) {
  return static_cast<int>(adjoint<float>(U, P, D, W, z, s_saved, f_saved, dD, dz, b, n, r, dA,
                                         dU, dV, dP, dy, stream));
}

int celerite_adjoint_f64(const double* U, const double* P, const double* D, const double* W,
                         const double* z, const double* s_saved, const double* f_saved,
                         const double* dD, const double* dz, int b, int n, int r, double* dA,
                         double* dU, double* dV, double* dP, double* dy, cudaStream_t stream) {
  return static_cast<int>(adjoint<double>(U, P, D, W, z, s_saved, f_saved, dD, dz, b, n, r, dA,
                                          dU, dV, dP, dy, stream));
}

// G1's launch, and G2's (the same but for its threads): out = {lanes a
// walker, walkers a block, blocks, threads a block, steps a staged tile};
// G3's at r slots: out = {columns a block, blocks, threads a block, rows a
// staged tile}
int celerite_forward_geometry(int b, int r, int* out) {
  if (b < 1 || r < 1 || r > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = group_lanes(r);
  out[1] = kWarp / group_lanes(r);
  out[2] = forward_blocks(b, r);
  out[3] = kForwardWarps * kWarp;
  out[4] = step_tile(r);
  return 0;
}

int celerite_adjoint_geometry(int b, int r, int* out) {
  const int err = celerite_forward_geometry(b, r, out);
  out[3] = kAdjointWarps * kWarp;
  return err;
}

// every celerite kernel's compiled resources at r slots in float32
// (elem_size 4) or float64 (8): 18 ints, {local memory bytes a thread,
// registers a thread, shared memory bytes a block} for G1 with y and the
// saved state, with y, with the saved state, with neither, G2 and G3
int celerite_kernel_attributes(int r, int elem_size, int* out) {
  if (elem_size == 4) return static_cast<int>(attributes<float>(r, out));
  if (elem_size == 8) return static_cast<int>(attributes<double>(r, out));
  return static_cast<int>(cudaErrorInvalidValue);
}

int celerite_solve_geometry(int k, int r, int* out) {
  if (k < 1 || r < 1 || r > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = kColsPerBlock;
  out[1] = solve_blocks(k);
  out[2] = kSolveWarps * kWarp;
  out[3] = solve_row_tile(r);
  return 0;
}

int celerite_solve_f32(const float* U, const float* P, const float* D, const float* W,
                       const float* Y, int n, int r, int k, float* X, cudaStream_t stream) {
  return static_cast<int>(solve<float>(U, P, D, W, Y, n, r, k, X, stream));
}

int celerite_solve_f64(const double* U, const double* P, const double* D, const double* W,
                       const double* Y, int n, int r, int k, double* X, cudaStream_t stream) {
  return static_cast<int>(solve<double>(U, P, D, W, Y, n, r, k, X, stream));
}

}  // extern "C"
