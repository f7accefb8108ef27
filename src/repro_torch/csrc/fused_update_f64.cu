// Kernels A and B for double storage computed in double; see fused_update.cuh.
#include "fused_update.cuh"

extern "C" {

FULL_ENTRY(fused_update_f64, double, double)
TRUNC_ENTRY(fused_update_truncated_f64, double, double)
SCRATCH_ENTRIES

}  // extern "C"
