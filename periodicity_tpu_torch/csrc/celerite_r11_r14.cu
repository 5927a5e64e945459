// G1, G2 and G3 at R = 11 and 14 slots (celerite.cuh), a translation unit of
// their own so that nvcc builds the widths in parallel.

#include "celerite.cuh"

PERIODICITY_CELERITE_WIDTH(11)
PERIODICITY_CELERITE_WIDTH(14)
