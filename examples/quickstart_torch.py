"""Quickstart of the PyTorch/CUDA port: the paper's rank-1 SVD update through
``repro_torch.api``.

The port's counterpart of ``examples/quickstart.py``, at its sizes and seed:
one state (``SvdState``), one policy (``UpdatePolicy``), one entry point
(``api.update``).  A (200, 300) uniform(1, 9) float64 matrix takes one rank-1
update under ``method="fmm"``.  Both eigen-problems have at least
``FMM_MIN_N`` poles, so the Cauchy products run through the Chebyshev FMM,
whose near field is kernel E (``csrc/nearfield.cu``) on the card.  An FMM
plan that overflows its static box capacity hands its members to the dense
stable product, as the reference's ``lax.cond`` does
(``repro_torch.core.fmm.OVERFLOWED``); the script prints how many did.

Run on the card:          python3 examples/quickstart_torch.py
Run on the CPU (plain):   python3 examples/quickstart_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import fmm  # noqa: E402

M, N = 200, 300


def main(argv=None) -> dict:
    """Run the quickstart; returns the figures it prints (and the updated
    singular values, ``s``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    # A known SVD ...
    a_mat = rng.uniform(1, 9, size=(M, N))                       # paper's experimental setup
    state = api.SvdState.from_dense(a_mat, device=args.device)  # full paper state: u (m,m), v (n,n)

    # ... perturbed by a rank-1 update (a streaming observation, a gradient, ...)
    a = rng.normal(size=M)
    b = rng.normal(size=N)

    # Algorithm 6.1: secular roots + Loewner weights + FMM Cauchy products.
    # The policy names the numerics once; geometry picks the dispatch route.
    policy = api.UpdatePolicy(method="fmm")
    fmm.OVERFLOWED.clear()
    state = api.update(state, a, b, policy)
    overflowed = len(fmm.OVERFLOWED)

    a_hat = a_mat + np.outer(a, b)
    recon = state.materialize().cpu().numpy()
    smax = np.linalg.svd(a_hat, compute_uv=False)[0]
    err = np.max(np.abs(a_hat - recon)) / smax
    u_np = state.u.cpu().numpy()
    ortho = np.max(np.abs(u_np.T @ u_np - np.eye(M)))
    s = state.s.cpu().numpy()

    print(f"device              : {state.device}")
    print(f"updated sigma_max   : {float(s[0]):.6f}")
    print(f"fresh-SVD sigma_max : {smax:.6f}")
    print(f"Eq.32 error         : {err:.3e}   (paper Table 2 reports ~5e-2 at n=50)")
    print(f"orthogonality |U^TU - I|: {ortho:.3e}")
    print(f"FMM plans overflowed: {overflowed} (their members took the dense stable product)")
    assert err < 1e-9
    print("OK")
    return {"sigma_max": float(s[0]), "fresh_sigma_max": float(smax), "eq32_error": float(err),
            "orthogonality": float(ortho), "fmm_plans_overflowed": overflowed, "s": s}


if __name__ == "__main__":
    main()
