// G1, G2 and G3 at R = 9 and 16 slots (celerite.cuh), a translation unit of
// their own so that nvcc builds the widths in parallel.

#include "celerite.cuh"

PERIODICITY_CELERITE_WIDTH(9)
PERIODICITY_CELERITE_WIDTH(16)
