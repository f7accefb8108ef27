// Kernels A and B for float storage computed in float; see fused_update.cuh.
#include "fused_update.cuh"

extern "C" {

FULL_ENTRY(fused_update_f32, float, float)
TRUNC_ENTRY(fused_update_truncated_f32, float, float)
SCRATCH_ENTRIES

}  // extern "C"
