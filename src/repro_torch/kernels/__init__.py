"""The port's kernels: a plain PyTorch version and a hand-written CUDA kernel each.

cauchy_matmul   on-the-fly Cauchy product (csrc/cauchy_matmul.cu, kernel C)
fused_update    the whole rank-1 update, full (kernel A) and truncated
                (kernel B), a thread-block cluster per update
                (csrc/fused_update.cuh)
sparse_proj     COO projection S @ mat: the entries bucketed by destination
                row on the card, one lane group per row (csrc/sparse_proj.cu,
                kernel F)
secular_newton  the fixed-count secular root solve, a lane group per root
                (csrc/secular_newton.cu, kernel D)
nearfield       the FMM near field, each Cauchy entry built once in shared
                memory, f64 on the DMMA tensor cores (csrc/nearfield.cu,
                kernel E)
split_bf16x3    the exact split of a float32 tensor into three bf16 planes (and
                a bf16 operand laid out beside them), so the backward's
                float32 products run on the bf16 tensor cores
                (csrc/split_bf16x3.cu; replaces no TPU kernel)
secular_body    the bisection + Newton secular loop the fused body runs
ref             plain oracles; ops: dispatch by device
_build          nvcc build into build/repro_torch/, ctypes loading, launch counts
"""

from repro_torch.kernels import ops, ref  # noqa: F401
