"""Core numerics of the port, plain PyTorch over a leading batch dimension.

Every public function also takes the reference's single-member shapes
(no batch axis) and returns its single-member results (``core._single``).

  cheb         Chebyshev nodes and Lagrange operators
  secular      deflation, anchored secular solve, Loewner weights
  cauchy       stable Cauchy products
  fmm          batched Chebyshev FMM for Cauchy sums (near field: kernel E)
  fast         Gerasoulis FAST baseline (host numpy; a benchmark, not a route)
  eigh_update  diagonal-plus-rank-1 eigen-update (Algorithm 6.2)
  svd_update   rank-1 SVD update (Algorithm 6.1) and its truncated form
  engine       SvdEngine: batched entry points, precision, cache accounting
"""

from repro_torch.core.cauchy import (
    cauchy_colnorms_stable,
    cauchy_matmul,
    cauchy_matmul_stable,
    cauchy_matrix,
    cauchy_matvec,
)
from repro_torch.core.eigh_update import (
    EighUpdatePlan,
    apply_update,
    apply_update_batch,
    eigenvalues,
    eigh_update,
    make_plan,
    make_plan_batch,
    materialize_q,
)
from repro_torch.core.engine import EngineCacheInfo, SvdEngine, default_engine
from repro_torch.core.fmm import FmmPlan, build_plan, fmm_apply, fmm_error_bound, fmm_matvec
from repro_torch.core.secular import deflate, loewner_zhat, secular_solve
from repro_torch.core.svd_update import SvdUpdateResult, TruncatedSvd

__all__ = [
    "cauchy_matmul",
    "cauchy_matmul_stable",
    "cauchy_matrix",
    "cauchy_matvec",
    "cauchy_colnorms_stable",
    "EighUpdatePlan",
    "apply_update",
    "apply_update_batch",
    "eigenvalues",
    "eigh_update",
    "make_plan",
    "make_plan_batch",
    "materialize_q",
    "EngineCacheInfo",
    "SvdEngine",
    "default_engine",
    "FmmPlan",
    "build_plan",
    "fmm_apply",
    "fmm_error_bound",
    "fmm_matvec",
    "deflate",
    "loewner_zhat",
    "secular_solve",
    "SvdUpdateResult",
    "TruncatedSvd",
]
