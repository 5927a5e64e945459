// K1 at R = 11 states (kalman.cuh), a translation unit of its own so that
// nvcc builds the widths in parallel.

#include "kalman.cuh"

PERIODICITY_KALMAN_WIDTH(11)
