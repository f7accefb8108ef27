"""Port parity: the FMM near field's plain version
(``repro_torch.kernels.nearfield.nearfield_plain``, reached on CPU tensors
through ``kernels.ops.nearfield``) against the reference's Pallas kernel in
interpret mode (``repro.kernels.ops.nearfield``, with ``tests/test_kernels.py``'s
tolerances: 1e-11 (f64) and 1e-4 (f32), relative and over max |out|), and,
on a real anchored FMM plan, against the reference's own near field (the
contraction with its precomputed ``near_inv``).  Kernel E against this
plain version on the card is in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref, t
from repro_torch.core import fmm
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.nearfield import nearfield_plain

ROPS = ref("kernels.ops")
RFMM = ref("core.fmm")
TOL = {torch.float64: 1e-11, torch.float32: 1e-4}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


@pytest.mark.parametrize("r,nb,c3,capt", [(2, 4, 12, 6), (5, 8, 24, 12), (9, 16, 48, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nearfield_matches_reference_kernel(r, nb, c3, capt, dtype):
    rng = np.random.default_rng(r * nb)
    w = rng.normal(size=(r, nb, c3))
    x = rng.uniform(0, 1, (nb, c3))
    av = rng.uniform(0, 1, (nb, capt))
    tau = rng.uniform(0, 1e-3, (nb, capt))
    mask = rng.uniform(size=(nb, capt)) > 0.2
    jdt = JDT[dtype]
    want = np.asarray(ROPS.nearfield(*(jnp.asarray(v, jdt) for v in (w, x, av, tau)),
                                     jnp.asarray(mask), interpret=True))
    before = dict(_build.LAUNCHES)
    got = ops.nearfield(*(t(v[None], dtype) for v in (w, x, av, tau)), torch.as_tensor(mask[None]))
    assert _build.LAUNCHES == before                 # CPU tensors take the plain version
    assert got.dtype == dtype and got.shape == (1, r, nb, capt)
    tol = TOL[dtype]
    np.testing.assert_allclose(got[0].numpy(), want, rtol=tol,
                               atol=tol * (float(np.max(np.abs(want))) + 1))


def test_near_field_of_a_plan_matches_reference():
    """On an anchored plan with near-pole targets and padded box slots, the
    port's near field (weights gathered with the invalid slots zeroed, blocks
    built on the fly) equals the reference's contraction with ``near_inv``."""
    rng = np.random.default_rng(12)
    n = 300
    src = np.sort(rng.uniform(0, 1, n))
    anchor = rng.integers(0, n, n)
    tau = rng.normal(size=n) * 1e-9
    tau[::5] = 0.0                                    # exact poles: the 1/0 guard
    w = rng.normal(size=(3, n))
    valid = rng.uniform(size=n) > 0.1
    kw = dict(src_valid=valid, tgt_valid=valid, tgt_anchor=anchor, tgt_tau=tau)
    plan = fmm.build_plan(t(src[None]), t(src[anchor] + tau)[None], p=16,
                          **{k: torch.as_tensor(v[None]) for k, v in kw.items()})
    near = ops.nearfield(*fmm.near_operands(plan, t(w[None])))[0].numpy()
    rplan = RFMM.build_plan(jnp.asarray(src), jnp.asarray(src[anchor] + tau), p=16,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    want = np.einsum("rbc,bct->rbt", w[:, np.asarray(rplan.near_src_idx)],
                     np.asarray(rplan.near_inv))
    assert near.shape == want.shape
    assert float(np.max(np.abs(near - want))) <= 1e-12 * float(np.max(np.abs(want)))


def test_batched_near_field_equals_members():
    rng = np.random.default_rng(13)
    bsz, r, nb, c3, capt = 3, 4, 5, 21, 9
    args = [t(rng.normal(size=(bsz, r, nb, c3))), t(rng.uniform(0, 1, (bsz, nb, c3))),
            t(rng.uniform(0, 1, (bsz, nb, capt))), t(rng.normal(size=(bsz, nb, capt)) * 1e-4),
            torch.as_tensor(rng.uniform(size=(bsz, nb, capt)) > 0.3)]
    args[1][0, 0, 3] = args[2][0, 0, 2]                # a zero denominator (tau 0 there)
    args[3][0, 0, 2] = 0.0
    got = nearfield_plain(*args)
    assert torch.isfinite(got).all()
    for i in range(bsz):
        torch.testing.assert_close(got[i:i + 1], nearfield_plain(*(a[i:i + 1] for a in args)),
                                   rtol=1e-15, atol=0)
    torch.testing.assert_close(TREF.nearfield_ref(*args), got, rtol=0, atol=0)
