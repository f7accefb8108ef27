"""The port's core takes the reference's single-member shapes (ROADMAP C2).

The reference's numerics layer is single-member (``make_plan(d, z, rho)``
with ``d`` (n,), ``apply_update(plan, w)`` with ``w`` (m, n), ...) and the
engine ``vmap``s it; the port's is batched, with a front door
(``repro_torch.core._single``) that adds and drops the batch axis.  Before
the repair the port raised ``IndexError`` / ``ValueError`` on these shapes.

``test_single_member_matches_reference``: each public function of the core,
fed the same seeded numpy inputs in the reference's shapes (float64, n =
120), gives the reference's shapes and values: 1e-12 of the largest
reference entry; the FMM at the reference's own tolerance against the dense
sum, ``max(10 fmm_error_bound(20), 1e-13)``; integer fields exactly.

``test_front_door``: a single-member call equals the batched call at B = 1
to the bit (the door only adds and drops the axis), and a batch of 3 agrees
with a loop of single calls to 1e-13 of the largest entry.

The four names the port lacked, ``cauchy_matvec``, ``cauchy_matmul`` (below
and above ``chunk``), ``make_plan_batch`` and ``apply_update_batch``, are
held to the reference (the batched pair to its ``vmap``).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import core as PCORE
from repro_torch.core import cauchy as PC
from repro_torch.core import cheb as PCH
from repro_torch.core import fmm as PF
from repro_torch.core import secular as PS

PE = importlib.import_module("repro_torch.core.eigh_update")  # the package re-exports the function

RCORE = ref("core")
RC = ref("core.cauchy")
RCH = ref("core.cheb")
RE = ref("core.eigh_update")
RF = ref("core.fmm")
RS = ref("core.secular")

N, M, R = 120, 100, 5
REL = 1e-12
FMM_REL = max(10 * RF.fmm_error_bound(20), 1e-13)
LOOP_REL = 1e-13


def _inputs(seed: int) -> dict:
    """One member's numpy inputs: an ascending spectrum with two repeated
    poles and a tiny z entry (so deflation rotates and drops), the pair,
    a Cauchy geometry and weights."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.uniform(1.0, 9.0, N))
    d[41] = d[40]
    d[77] = d[76]
    z = rng.normal(size=N)
    z[10] = 1e-19
    src = np.sort(rng.normal(size=N))
    anchor = rng.integers(0, N, size=M)
    tau = rng.normal(size=M) * 1e-3
    return {"d": d, "z": z, "rho": np.array(0.7), "w": rng.normal(size=(R, N)),
            "wn": rng.normal(size=N), "u": np.linalg.qr(rng.normal(size=(N, N)))[0],
            "dd": np.sort(rng.uniform(1.0, 9.0, N)), "n_keep": np.array(N),
            "src": src, "tgt": np.sort(rng.uniform(-3.0, 3.0, M)) + 1e-3,
            "anchor": anchor, "tau": tau, "av": src[anchor] + tau,
            "src_valid": rng.random(N) > 0.1, "tgt_valid": rng.random(M) > 0.1,
            "zhat": rng.normal(size=N), "x": rng.uniform(-1.0, 1.0, (5, 7))}


def _torch(x: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in x.items()}


def _jax(x: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in x.items()}


def _roots(S, x):
    return S.secular_solve(x["dd"], x["z"], x["rho"], x["n_keep"])


def _plan(E, x, fmm=False):
    return E.make_plan(x["d"], x["z"], x["rho"], rho_positive=True, build_fmm=fmm)


def _fplan(F, x):
    return F.build_plan(x["src"], x["tgt"], p=20)


_PLAN_FIELDS = ("sort_idx", "compact", "dc", "zc", "rho", "zhat", "mu", "anchor", "tau",
                "valid", "colnorm", "mu_full", "out_sort", "givens_a", "givens_b", "givens_c",
                "givens_s", "any_rot")
_FMM_FIELDS = ("src", "src_box_idx", "src_box_mask", "tgt_box_idx", "tgt_box_mask", "anterp",
               "tgt_eval", "m2m_l", "m2m_r", "t_hat", "near_src_idx", "span", "overflow")


def _fields(obj, names):
    return tuple(getattr(obj, f) for f in names)


# name -> (fn(module namespace, inputs) -> tuple of outputs, tolerance, batched?)
# the namespace carries the package's modules: S secular, C cauchy, CH cheb,
# F fmm, E eigh_update
CASES = {
    "cheb.lagrange_eval": (lambda P, x: (P.CH.lagrange_eval(P.CH.cheb_nodes(12), x["x"]),),
                           REL, False),
    "cheb.lagrange_matrix": (lambda P, x: (P.CH.lagrange_matrix(P.CH.cheb_nodes(12), x["x"]),),
                             REL, False),
    "secular.deflate": (lambda P, x: tuple(P.S.deflate(x["d"], x["z"], x["rho"])), REL, True),
    "secular.apply_givens_columns": (lambda P, x: (P.S.apply_givens_columns(
        x["w"], *_fields(P.S.deflate(x["d"], x["z"], x["rho"]),
                         ("givens_a", "givens_b", "givens_c", "givens_s", "any_rot"))),),
        REL, True),
    "secular.secular_solve": (lambda P, x: tuple(_roots(P.S, x)), REL, True),
    "secular.loewner_zhat": (lambda P, x: (P.S.loewner_zhat(x["dd"], x["z"], x["rho"],
                                                            _roots(P.S, x)),), REL, True),
    "secular.mu_minus_d": (lambda P, x: (P.S.mu_minus_d(_roots(P.S, x), x["dd"]),), REL, True),
    "cauchy.cauchy_matrix": (lambda P, x: (P.C.cauchy_matrix(x["src"], x["tgt"]),), REL, True),
    "cauchy.cauchy_matmul_stable": (lambda P, x: (P.C.cauchy_matmul_stable(
        x["w"], x["src"], x["anchor"], x["tau"], src_valid=x["src_valid"],
        tgt_valid=x["tgt_valid"]),), REL, True),
    "cauchy.cauchy_colnorms_stable": (lambda P, x: (P.C.cauchy_colnorms_stable(
        x["zhat"], x["src"], x["anchor"], x["tau"], src_valid=x["src_valid"],
        tgt_valid=x["tgt_valid"]),), REL, True),
    "cauchy.cauchy_matvec": (lambda P, x: (P.C.cauchy_matvec(x["wn"], x["src"], x["tgt"]),),
                             REL, True),
    "cauchy.cauchy_matmul": (lambda P, x: (P.C.cauchy_matmul(x["w"], x["src"], x["tgt"]),),
                             REL, True),
    "cauchy.cauchy_matmul[chunk below M]": (lambda P, x: (P.C.cauchy_matmul(
        x["w"], x["src"], x["tgt"], chunk=32),), REL, True),
    "fmm.build_plan": (lambda P, x: _fields(_fplan(P.F, x), _FMM_FIELDS), REL, True),
    "fmm.fmm_apply": (lambda P, x: (P.F.fmm_apply(_fplan(P.F, x), x["w"]),), FMM_REL, True),
    "fmm.fmm_apply[1-D w]": (lambda P, x: (P.F.fmm_apply(_fplan(P.F, x), x["wn"]),),
                             FMM_REL, True),
    "fmm.fmm_matvec": (lambda P, x: (P.F.fmm_matvec(x["w"], x["src"], x["tgt"]),), FMM_REL,
                       True),
    "eigh_update.make_plan": (lambda P, x: _fields(_plan(P.E, x), _PLAN_FIELDS), REL, True),
    "eigh_update.eigenvalues": (lambda P, x: (P.E.eigenvalues(_plan(P.E, x)),), REL, True),
    "eigh_update.apply_update[direct]": (lambda P, x: (P.E.apply_update(_plan(P.E, x), x["w"]),),
                                         REL, True),
    "eigh_update.apply_update[fmm]": (lambda P, x: (P.E.apply_update(
        _plan(P.E, x, fmm=True), x["w"], method="fmm"),), FMM_REL, True),
    "eigh_update.materialize_q": (lambda P, x: (P.E.materialize_q(_plan(P.E, x)),), REL, True),
    "eigh_update.eigh_update[direct]": (lambda P, x: tuple(P.E.eigh_update(
        x["u"], x["d"], x["z"], x["rho"], rho_positive=True)), REL, True),
    "eigh_update.eigh_update[fmm]": (lambda P, x: tuple(P.E.eigh_update(
        x["u"], x["d"], x["z"], x["rho"], rho_positive=True, method="fmm")), FMM_REL, True),
}

PORT = type("Port", (), {"S": PS, "C": PC, "CH": PCH, "F": PF, "E": PE})
REFERENCE = type("Reference", (), {"S": RS, "C": RC, "CH": RCH, "F": RF, "E": RE})


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want, rel, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-300)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel:.1e} x {scale:.3e}"


@pytest.fixture(scope="module")
def member():
    return _inputs(0)


@pytest.mark.parametrize("name", list(CASES))
def test_single_member_matches_reference(name, member):
    fn, rel, _ = CASES[name]
    got = fn(PORT, _torch(member))
    want = fn(REFERENCE, _jax(member))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, w, rel, f"{name} output {i}")


@pytest.mark.parametrize("name", [k for k, v in CASES.items() if v[2]])
def test_front_door(name):
    fn = CASES[name][0]
    members = [_torch(_inputs(seed)) for seed in (1, 2, 3)]
    single = [fn(PORT, x) for x in members]
    # one member with a batch axis of 1: the same bits
    one = fn(PORT, {k: v[None] for k, v in members[0].items()})
    for i, (a, b) in enumerate(zip(single[0], one)):
        if b.shape != a.shape:      # else an operator every member shares (FmmPlan.SHARED)
            assert b.shape == (1,) + a.shape, f"{name} output {i}"
            b = b[0]
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    # a batch of three against a loop of single calls
    stacked = fn(PORT, {k: torch.stack([x[k] for x in members]) for k in members[0]})
    for i, b in enumerate(stacked):
        for j in range(3):
            got = b if b.shape == single[j][i].shape else b[j]
            _assert_close(got, single[j][i], LOOP_REL, f"{name} output {i} member {j}")


def test_core_exports_the_reference_names():
    assert set(RCORE.__all__) <= set(PCORE.__all__)
    for name in ("cauchy_matvec", "cauchy_matmul", "make_plan_batch", "apply_update_batch"):
        assert getattr(PCORE, name) is not None


@pytest.mark.parametrize("method", ["direct", "fmm"])
def test_batch_names_match_reference_vmap(method):
    xs = [_inputs(seed) for seed in (4, 5, 6)]
    d, z, rho, w = (np.stack([x[k] for x in xs]) for k in ("d", "z", "rho", "w"))
    kw = dict(rho_positive=True, build_fmm=method == "fmm")
    rplan = RE.make_plan_batch(jnp.asarray(d), jnp.asarray(z), jnp.asarray(rho), **kw)
    pplan = PE.make_plan_batch(torch.as_tensor(d), torch.as_tensor(z), torch.as_tensor(rho), **kw)
    rel = FMM_REL if method == "fmm" else REL
    _assert_close(PE.eigenvalues(pplan), np.stack(
        [np.asarray(RE.eigenvalues(RE.make_plan(jnp.asarray(x["d"]), jnp.asarray(x["z"]),
                                                jnp.asarray(x["rho"]), **kw))) for x in xs]),
        REL, "eigenvalues")
    _assert_close(PE.apply_update_batch(pplan, torch.as_tensor(w), method=method),
                  RE.apply_update_batch(rplan, jnp.asarray(w), method=method), rel,
                  "apply_update_batch")
    with pytest.raises(ValueError, match="batched"):
        PE.make_plan_batch(torch.as_tensor(d[0]), torch.as_tensor(z[0]), torch.as_tensor(rho[0]),
                           **kw)
    with pytest.raises(ValueError, match="batched"):
        PE.apply_update_batch(PE.make_plan(torch.as_tensor(d[0]), torch.as_tensor(z[0]),
                                           torch.as_tensor(rho[0]), **kw), torch.as_tensor(w[0]))
