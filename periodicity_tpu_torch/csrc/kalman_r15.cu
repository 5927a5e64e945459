// K1 and its adjoint K2 at R = 15 states (kalman.cuh, kalman_adjoint.cuh), a
// translation unit of their own so that nvcc builds the widths in parallel.

#include "kalman_adjoint.cuh"

PERIODICITY_KALMAN_WIDTH(15)
PERIODICITY_KALMAN_ADJOINT_WIDTH(15)
