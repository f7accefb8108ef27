"""Port parity: the Chebyshev FMM (``repro_torch.core.cheb``, ``core.fmm``)
against the reference's ``repro.core.cheb`` / ``repro.core.fmm`` and against
the dense Cauchy sum, f64 on the CPU (the near field through its plain
version; kernel E on the card is in ``test_torch_cuda.py``).

Tolerances: Chebyshev nodes and Lagrange operators 1e-14; ``fmm_apply``
against the reference ``max(10 fmm_error_bound(p), 1e-12)`` relative to
max |out| (two sums of the same terms in another order), against the dense
sum ``tests/test_fmm.py``'s rule.  ``torch.topk`` orders the ties of the
non-outliers differently from ``lax.top_k``, so the outlier indices are
compared as sets of the real (unmasked) outliers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref, t
from repro_torch.core import cheb, fmm

RCHEB = ref("core.cheb")
RFMM = ref("core.fmm")
RC = ref("core.cauchy")


def _direct(w, src, tgt):
    return np.einsum("rj,ji->ri", w, 1.0 / (tgt[None, :] - src[:, None]))


def _both(src, tgt, w, **kw):
    """The port's and the reference's plan and result on the same inputs
    (the port's with a batch of one)."""
    tkw = {k: t(v[None], torch.bool if v.dtype == bool else
                (torch.long if v.dtype.kind == "i" else torch.float64))
           for k, v in kw.items() if k not in ("p",)}
    plan = fmm.build_plan(t(src[None]), t(tgt[None]), p=kw.get("p", 20), **tkw)
    got = fmm.fmm_apply(plan, t(w[None]))[0].numpy()
    rkw = {k: (jnp.asarray(v) if k != "p" else v) for k, v in kw.items()}
    rplan = RFMM.build_plan(jnp.asarray(src), jnp.asarray(tgt), **rkw)
    want = np.asarray(RFMM.fmm_apply(rplan, jnp.asarray(w)))
    return plan, got, rplan, want


def _rel(a, b, scale):
    return float(np.max(np.abs(a - b)) / scale)


@pytest.mark.parametrize("p", [4, 12, 20])
def test_cheb_matches_reference(p):
    rng = np.random.default_rng(p)
    x = rng.uniform(-1.0, 1.0, (3, 17))        # a leaf box's scaled coordinates
    tt = cheb.cheb_nodes(p, torch.float64)
    np.testing.assert_allclose(tt.numpy(), np.asarray(RCHEB.cheb_nodes(p)), atol=1e-14, rtol=0)
    got = cheb.lagrange_eval(tt, t(x))
    want = np.asarray(RCHEB.lagrange_eval(RCHEB.cheb_nodes(p), jnp.asarray(x)))
    assert got.shape == (p, 3, 17)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-14, rtol=1e-14)
    np.testing.assert_allclose(cheb.lagrange_matrix(tt, t(x)).numpy(),
                               np.asarray(RCHEB.lagrange_matrix(RCHEB.cheb_nodes(p),
                                                                jnp.asarray(x))),
                               atol=1e-14, rtol=1e-14)
    # interpolation is exact for the Lagrange basis at the nodes
    np.testing.assert_allclose(cheb.lagrange_eval(tt, tt).numpy(), np.eye(p), atol=1e-14)


@pytest.mark.parametrize("n", [64, 200, 513])
@pytest.mark.parametrize("p", [8, 16, 24])
def test_fmm_matches_reference_and_direct(n, p):
    """Against the dense sum at every order, and against the reference at
    p = 16 (the reference's plan build runs op by op: seconds a call)."""
    rng = np.random.default_rng(1000 + n + p)
    src = np.sort(rng.uniform(0, 1, n))
    tgt = np.sort(rng.uniform(0, 1, n)) + 1e-7
    w = rng.normal(size=(4, n))
    if p == 16:
        plan, got, rplan, want = _both(src, tgt, w, p=p)
        assert not bool(rplan.overflow)
        assert (plan.nlevs, plan.nb, plan.cap, plan.capt) == (rplan.nlevs, rplan.nb, rplan.cap,
                                                              rplan.capt)
        assert _rel(got, want, np.max(np.abs(want))) < max(10 * fmm.fmm_error_bound(p), 1e-12)
    else:
        plan = fmm.build_plan(t(src[None]), t(tgt[None]), p=p)
        got = fmm.fmm_apply(plan, t(w[None]))[0].numpy()
    assert not bool(plan.overflow[0])
    d = _direct(w, src, tgt)
    assert _rel(got, d, np.max(np.abs(d))) < max(10 * fmm.fmm_error_bound(p), 1e-13)


def test_error_decreases_with_p():
    rng = np.random.default_rng(3)
    n = 400
    src = np.sort(rng.uniform(0, 1, n))
    tgt = np.sort(rng.uniform(0, 1, n)) + 1e-7
    w = rng.normal(size=(1, n))
    d = _direct(w, src, tgt)
    errs = [_rel(fmm.fmm_matvec(t(w[None]), t(src[None]), t(tgt[None]), p=p)[0].numpy(), d,
                 np.max(np.abs(d))) for p in (4, 8, 12, 16)]
    assert errs[0] > errs[1] > errs[2]
    assert errs[-1] < 1e-10
    # (B, N) weights: one row each
    one = fmm.fmm_matvec(t(w), t(src[None]), t(tgt[None]), p=16)
    assert one.shape == (1, n)


def test_outlier_targets_and_sources():
    """Targets far outside the grid (the top secular root) and poles far
    above the bulk (a squared spectrum's top eigenvalue) go to dense rows and
    columns; the peeled sets are the reference's."""
    rng = np.random.default_rng(4)
    n = 300
    src = np.sort(np.concatenate([rng.uniform(0, 10, n - 2), [16_000.0, 16_500.0]]))
    tgt = np.sort(np.concatenate([rng.uniform(0, 10, n - 5) + 1e-7,
                                  [15_000.0, 16_600.0, -40.0, 17.0, 123.0]]))
    w = rng.normal(size=(3, n))
    plan, got, rplan, want = _both(src, tgt, w, p=16)
    assert not bool(plan.overflow[0]) and not bool(rplan.overflow)
    d = _direct(w, src, tgt)
    assert _rel(got, d, np.max(np.abs(d))) < 1e-12
    assert _rel(got, want, np.max(np.abs(want))) < 1e-12
    for idx, inv, ridx, rinv in ((plan.out_idx, plan.out_inv, rplan.out_idx, rplan.out_inv),
                                 (plan.src_out_idx, plan.src_out_inv, rplan.src_out_idx,
                                  rplan.src_out_inv)):
        real = {int(i) for i, row in zip(idx[0], inv[0]) if bool(row.abs().max() > 0)}
        rreal = {int(i) for i, row in zip(np.asarray(ridx), np.asarray(rinv))
                 if np.abs(row).max() > 0}
        assert real == rreal and len(real) > 0


def test_overflow_flag_on_pathological_clustering():
    n = 1024
    src = np.sort(np.concatenate([np.full(n // 2, 0.5) + np.linspace(0, 1e-9, n // 2),
                                  np.linspace(0.0, 1.0, n - n // 2)]))
    tgt = src + 1e-12
    ok_src = np.sort(np.random.default_rng(5).uniform(0, 1, n))
    # a batch of two: the clustered member overflows, the spread one does not
    plan = fmm.build_plan(t(np.stack([src, ok_src])), t(np.stack([tgt, ok_src + 1e-9])), p=8)
    assert plan.overflow.tolist() == [True, False]      # the reference flags it too (test_fmm.py)


def test_masked_invalid_sources_and_targets():
    rng = np.random.default_rng(6)
    n = 128
    src = np.sort(rng.uniform(0, 1, n))
    tgt = np.sort(rng.uniform(0, 1, n)) + 1e-7
    sv = rng.uniform(size=n) > 0.2
    tv = rng.uniform(size=n) > 0.2
    w = rng.normal(size=(2, n)) * sv[None, :]
    plan, got, _, want = _both(src, tgt, w, p=16, src_valid=sv, tgt_valid=tv)
    d = _direct(w, src, tgt) * tv[None, :]
    np.testing.assert_allclose(got * tv[None, :], d, atol=1e-9 * np.max(np.abs(d)))
    assert np.allclose(got[:, ~tv], 0.0)
    assert _rel(got, want, np.max(np.abs(want))) < 1e-12


def test_anchored_targets_near_poles():
    """Near-pole targets (anchor, tau) keep full relative accuracy, through
    the near field's anchored denominators."""
    rng = np.random.default_rng(8)
    n = 200
    src = np.sort(rng.uniform(0, 1, n))
    anchor = np.arange(n)
    tau = np.full(n, 1e-13)
    tau[::7] = -3e-14
    w = rng.normal(size=(2, n))
    plan, got, _, want = _both(src, src + tau, w, p=20, tgt_anchor=anchor, tgt_tau=tau)
    cauchy = np.asarray(RC.cauchy_matmul_stable(jnp.asarray(w), jnp.asarray(src),
                                                jnp.asarray(anchor, jnp.int32), jnp.asarray(tau)))
    np.testing.assert_allclose(-got, cauchy, rtol=1e-9)   # Cauchy orientation: -fmm
    assert _rel(got, want, np.max(np.abs(want))) < 1e-12


def test_batched_plan_matches_single_plans():
    """One plan over a batch of members with different spreads equals a plan
    per member, bitwise (the binning, top-k and products are per member)."""
    rng = np.random.default_rng(9)
    n, m = 160, 150
    srcs = np.stack([np.sort(rng.uniform(0, s, n)) for s in (1.0, 5.0, 0.01)])
    tgts = np.stack([np.sort(rng.uniform(0, s, m)) + 1e-7 for s in (1.0, 5.0, 0.01)])
    srcs[1, -1] = 400.0                        # one member with an outlier pole
    w = rng.normal(size=(3, 2, n))
    batched = fmm.fmm_apply(fmm.build_plan(t(srcs), t(tgts), p=12), t(w))
    for i in range(3):
        one = fmm.fmm_apply(fmm.build_plan(t(srcs[i:i + 1]), t(tgts[i:i + 1]), p=12),
                            t(w[i:i + 1]))
        torch.testing.assert_close(batched[i:i + 1], one, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["ties", "nan_rows"])
def test_bulk_quantiles_match_reference(case):
    """The grid's bulk range: ``torch.nanquantile`` against ``jnp.nanquantile``
    (both interpolate linearly) on tied values and on rows with masked (NaN)
    entries, through the plan's span."""
    rng = np.random.default_rng(10)
    n = 120
    src = np.sort(np.round(rng.uniform(0, 1, n), 1))          # heavy ties
    valid = np.ones(n, bool)
    if case == "nan_rows":
        src = np.sort(rng.uniform(0, 1, n))
        valid[rng.choice(n, 40, replace=False)] = False
    src[-1] = 50.0                                            # forces the bulk grid
    x = np.where(valid, src, np.nan)
    q = torch.nanquantile(t(x[None]), t([0.02, 0.98]), dim=1)[:, 0].numpy()
    rq = [float(jnp.nanquantile(jnp.asarray(x), v)) for v in (0.02, 0.98)]
    np.testing.assert_allclose(q, rq, rtol=1e-15, atol=0)
    if case == "ties":
        return
    plan = fmm.build_plan(t(src[None]), t(src[None] + 1e-9), p=8,
                          src_valid=torch.as_tensor(valid[None]))
    rplan = RFMM.build_plan(jnp.asarray(src), jnp.asarray(src + 1e-9), p=8,
                            src_valid=jnp.asarray(valid))
    np.testing.assert_allclose(float(plan.span[0]), float(rplan.span), rtol=1e-15)
    np.testing.assert_array_equal(plan.src_box_mask[0].numpy(), np.asarray(rplan.src_box_mask))


def test_overflowing_members_take_the_dense_product():
    """The eigen-plan's safety net (the reference's ``lax.cond`` on
    ``overflow``), member by member: a member whose FMM plan overflows is
    recorded in ``fmm.OVERFLOWED`` and takes the dense stable product; the
    other member keeps the FMM's."""
    from repro_torch.core.eigh_update import apply_update, make_plan

    rng = np.random.default_rng(14)
    n = 256
    spread = np.sort(rng.uniform(0, 10, n))
    clustered = np.sort(np.concatenate([5.0 + 1e-6 * np.arange(130),
                                        rng.uniform(0, 10, n - 130)]))
    z = rng.normal(size=(2, n))
    fmm.OVERFLOWED.clear()
    plan = make_plan(t(np.stack([spread, clustered])), t(z), t([1.0, 0.7]), rho_positive=True,
                     build_fmm=True, fmm_p=20)
    assert plan.has_fmm and plan.fmm_overflow == (1,) and list(fmm.OVERFLOWED) == [(1,)]
    w = t(rng.normal(size=(2, 5, n)))
    got = apply_update(plan, w, method="fmm")
    dense = apply_update(plan, w, method="direct")
    torch.testing.assert_close(got[1], dense[1], rtol=0, atol=1e-13)
    assert float((got[0] - dense[0]).abs().max()) < 1e-10
