// Kernels A and B for __nv_bfloat16 storage computed in float; see fused_update.cuh.
#include "fused_update.cuh"

extern "C" {

FULL_ENTRY(fused_update_bf16, float, __nv_bfloat16)
TRUNC_ENTRY(fused_update_truncated_bf16, float, __nv_bfloat16)
PLAN_ENTRIES(float, __nv_bfloat16)

}  // extern "C"
