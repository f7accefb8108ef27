"""The port's kernels: a plain PyTorch version and a hand-written CUDA kernel each.

cauchy_matmul   on-the-fly Cauchy product (csrc/cauchy_matmul.cu, kernel C)
fused_update    the whole rank-1 update, full (kernel A) and truncated
                (kernel B), one thread block per update (csrc/fused_update.cuh)
sparse_proj     COO projection S @ mat, one lane group per destination row
                (csrc/sparse_proj.cu, kernel F)
secular_newton  the fixed-count secular root solve, one warp per root
                (csrc/secular_newton.cu, kernel D)
nearfield       the FMM near field, Cauchy blocks built in shared memory
                (csrc/nearfield.cu, kernel E)
secular_body    the bisection + Newton secular loop the fused body runs
ref             plain oracles; ops: dispatch by device
_build          nvcc build into build/repro_torch/, ctypes loading, launch counts
"""

from repro_torch.kernels import ops, ref  # noqa: F401
