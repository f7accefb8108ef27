// Kernels A and B for __half storage computed in float; see fused_update.cuh.
#include "fused_update.cuh"

extern "C" {

FULL_ENTRY(fused_update_f16, float, __half)
TRUNC_ENTRY(fused_update_truncated_f16, float, __half)
PLAN_ENTRIES(float, __half)

}  // extern "C"
