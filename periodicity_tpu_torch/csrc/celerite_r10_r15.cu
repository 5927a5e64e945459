// G1, G2 and G3 at R = 10 and 15 slots (celerite.cuh), a translation unit of
// their own so that nvcc builds the widths in parallel.

#include "celerite.cuh"

PERIODICITY_CELERITE_WIDTH(10)
PERIODICITY_CELERITE_WIDTH(15)
