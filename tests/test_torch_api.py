"""Port parity and hygiene for ``repro_torch.api``.

Parity: ``api.update`` / ``api.update_many`` against the reference
``repro.api`` for full and truncated, single and batched states under every
ported method, with both sides built from the same numpy factors (f64,
atol 1e-10; ``v[:, :m]`` only for full states).  Hygiene: the package imports
neither jax nor the reference, builds no state on the CPU by accident, and
refuses by name what it does not port."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref, svd_problem, truncated_problem
from repro_torch import api, convert, updates

RAPI = ref("api")
REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-10
METHODS = ["direct", "pallas", "fused", "auto"]


def _states(probs, batched):
    """The same factors as a reference state and a port state (on the CPU)."""
    u, s, v, a, b = (np.stack(x) if batched else x[0] for x in zip(*probs))
    rs = RAPI.SvdState.from_factors(jnp.asarray(u), jnp.asarray(s), jnp.asarray(v))
    ts = convert.state_from_arrays(u, s, v, device="cpu")
    return rs, ts, a, b


def _compare(got, want, m, full):
    w = {k: np.asarray(getattr(want, k)) for k in ("u", "s", "v")}
    g = convert.state_to_arrays(got)
    np.testing.assert_allclose(g["u"], w["u"], atol=ATOL, rtol=0, err_msg="u")
    np.testing.assert_allclose(g["s"], w["s"], atol=ATOL, rtol=0, err_msg="s")
    cols = m if full else w["v"].shape[-1]
    np.testing.assert_allclose(g["v"][..., :cols], w["v"][..., :cols], atol=ATOL, rtol=0,
                               err_msg="v")
    if full:
        np.testing.assert_allclose(g["d_left"], np.asarray(want.d_left), atol=ATOL, rtol=0)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("method", METHODS)
def test_full_update_matches_reference(method, batched):
    rng = np.random.default_rng(41)
    probs = [svd_problem(rng, 8, 12) for _ in range(3 if batched else 1)]
    rs, ts, a, b = _states(probs, batched)
    want = RAPI.update(rs, jnp.asarray(a), jnp.asarray(b), RAPI.UpdatePolicy(method=method))
    got = api.update(ts, a, b, api.UpdatePolicy(method=method))
    _compare(got, want, 8, full=True)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("method", METHODS)
def test_truncated_update_matches_reference(method, batched):
    rng = np.random.default_rng(42)
    probs = [truncated_problem(rng, 12, 20, 4) for _ in range(3 if batched else 1)]
    rs, ts, a, b = _states(probs, batched)
    want = RAPI.update(rs, jnp.asarray(a), jnp.asarray(b), RAPI.UpdatePolicy(method=method))
    got = api.update(ts, a, b, api.UpdatePolicy(method=method))
    _compare(got, want, 12, full=False)


def test_update_many_matches_reference():
    rng = np.random.default_rng(43)
    probs = [svd_problem(rng, 6, 9), svd_problem(rng, 6, 9), svd_problem(rng, 5, 7)]
    r_states = [RAPI.SvdState.from_factors(*map(jnp.asarray, p[:3])) for p in probs]
    t_states = [convert.state_from_arrays(*p[:3], device="cpu") for p in probs]
    A = [p[3] for p in probs]
    B = [p[4] for p in probs]
    pol = dict(method="fused")
    want = RAPI.update_many(r_states, [jnp.asarray(x) for x in A], [jnp.asarray(x) for x in B],
                            RAPI.UpdatePolicy(**pol))
    got = api.update_many(t_states, A, B, api.UpdatePolicy(**pol))
    for g, w, p in zip(got, want, probs):
        _compare(g, w, p[0].shape[0], full=True)


@pytest.mark.parametrize("m,n,rank,dtype", [
    (32, 48, None, None), (128, 192, None, None), (4, 500, None, None),
    (512, 768, 16, None), (1024, 4096, 32, None), (32, 48, None, "bfloat16"),
])
def test_auto_resolves_like_reference(m, n, rank, dtype):
    problem_n = n if rank is None else rank + 1
    jdt = None if dtype is None else getattr(jnp, dtype)
    want = RAPI.UpdatePolicy(storage_dtype=jdt).resolve_method(problem_n, m=m, n=n, rank=rank)
    got = api.UpdatePolicy(storage_dtype=dtype).resolve_method(problem_n, m=m, n=n, rank=rank)
    assert got == want


def test_bf16_storage_policy_within_budget():
    from repro_torch.kernels.fused_update import BF16_ERROR_BUDGET

    rng = np.random.default_rng(44)
    u, s, v, a, b = svd_problem(rng, 16, 24)
    st = convert.state_from_arrays(u, s, v, device="cpu")
    out = api.update(st, a, b, api.UpdatePolicy(storage_dtype="bfloat16"))
    assert out.dtype == torch.bfloat16
    want = np.linalg.svd((u * s) @ v[:, :16].T + np.outer(a, b), compute_uv=False)
    got = convert.state_to_arrays(out)["s"]
    assert np.max(np.abs(got - want)) / want[0] < BF16_ERROR_BUDGET["sigma_rel"]


def test_convert_round_trip():
    rng = np.random.default_rng(45)
    u, s, v, _, _ = svd_problem(rng, 4, 6)
    dl = s * s
    st = convert.state_from_arrays(u, s, v, d_left=dl, device="cpu")
    arrs = convert.state_to_arrays(st)
    assert set(arrs) == {"u", "s", "v", "d_left"}
    for k, x in (("u", u), ("s", s), ("v", v), ("d_left", dl)):
        np.testing.assert_array_equal(arrs[k], x)
    f32 = convert.state_from_arrays(u, s, v, device="cpu", dtype="float32")
    assert f32.dtype == torch.float32 and f32.is_full


def test_engine_counts_geometries_and_restores_precision():
    rng = np.random.default_rng(46)
    u, s, v, a, b = svd_problem(rng, 5, 7)
    st = convert.state_from_arrays(u, s, v, device="cpu")
    pol = api.UpdatePolicy(method="direct", deflate_rtol=1e-13)
    eng = api.engine_for(pol, st)
    eng.cache_clear()
    prev = torch.get_float32_matmul_precision()
    api.update(st, a, b, pol)
    api.update(st, a, b, pol)
    assert eng.cache_info() == (1, 1, 1)
    assert torch.get_float32_matmul_precision() == prev


# -- the FMM route --------------------------------------------------------------


def test_policy_fmm_p_and_engine_key_match_reference():
    """The reference's doctest (``repro/api/policy.py``) on the port, and
    ``engine_key`` against the reference's tuple field by field."""
    pol = api.UpdatePolicy(method="fmm", fmm_p=12)
    assert pol.replace(truncate_to=8).truncate_to == 8
    assert hash(pol) == hash(api.UpdatePolicy(method="fmm", fmm_p=12))
    assert pol == api.UpdatePolicy(method="fmm", fmm_p=12) != api.UpdatePolicy(method="fmm")
    with pytest.raises(ValueError, match="unknown method 'svd'"):
        api.UpdatePolicy(method="svd")
    cases = [(dict(method="fmm", fmm_p=12), (256,), {}),
             (dict(), (9,), {}),
             (dict(deflate_rtol=1e-13, sign_fix=False), (512,), dict(m=512, n=512)),
             (dict(fmm_p=16, storage_dtype="float32", sketch_oversample=3), (128,),
              dict(m=2048, n=2048, rank=127)),
             (dict(method="pallas", precision="high", sketch_power_iters=2), (64,), {})]
    for kw, args, geo in cases:
        rkw = dict(kw, storage_dtype=getattr(jnp, kw["storage_dtype"])) if "storage_dtype" in kw else kw
        got = api.UpdatePolicy(**kw).engine_key(*args, **geo)
        want = RAPI.UpdatePolicy(**rkw).engine_key(*args, **geo)
        assert len(got) == len(want) == 8
        for i, (g, w) in enumerate(zip(got, want)):
            if i == 5 and w is not None:                 # storage dtype: torch vs numpy
                assert str(g).replace("torch.", "") == str(w), (kw, i)
            else:
                assert g == w, (kw, i, g, w)
    eng = api.engine_for(api.UpdatePolicy(method="fmm", fmm_p=12),
                         api.SvdState.from_dense(np.eye(4, 6), device="cpu"))
    assert (eng.method, eng.fmm_p) == ("fmm", 12)
    assert eng is not api.engine_for(api.UpdatePolicy(method="fmm"),
                                     api.SvdState.from_dense(np.eye(4, 6), device="cpu"))


FMM_CASES = [((512, 512, None), "fmm"), ((512, 512, None), "auto"), ((200, 300, None), "fmm"),
             ((200, 300, None), "auto"), ((256, 384, 127), "fmm"), ((256, 384, 127), "auto"),
             ((4, 500, None), "auto")]


@pytest.mark.parametrize("geo,method", FMM_CASES,
                         ids=[f"{m}x{n}{'' if r is None else f'r{r}'}-{meth}"
                              for (m, n, r), meth in FMM_CASES])
def test_fmm_route_matches_reference(geo, method):
    """``method="fmm"`` (and ``auto``, which picks it above the fused gate,
    as at (512, 512) and (4, 500)) against the reference, f64, by the
    reconstruction (``v[:, :m]``) and the singular values, over sigma_max."""
    m, n, rank = geo
    rng = np.random.default_rng(m + n)
    if rank is None:
        u, s, v, a, b = svd_problem(rng, m, n)
    else:
        u, s, v, a, b = truncated_problem(rng, m, n, rank)
    rs = RAPI.SvdState.from_factors(jnp.asarray(u), jnp.asarray(s), jnp.asarray(v))
    ts = convert.state_from_arrays(u, s, v, device="cpu")
    pol = dict(method=method)
    want = RAPI.update(rs, jnp.asarray(a), jnp.asarray(b), RAPI.UpdatePolicy(**pol))
    got = convert.state_to_arrays(api.update(ts, a, b, api.UpdatePolicy(**pol)))
    k = got["s"].shape[0]
    wu, ws, wv = (np.asarray(getattr(want, f)) for f in ("u", "s", "v"))
    scale = ws[0]
    rg = (got["u"] * got["s"]) @ got["v"][:, :k].T
    rw = (wu * ws) @ wv[:, :k].T
    assert np.abs(rg - rw).max() / scale <= ATOL
    assert np.abs(got["s"] - ws).max() / scale <= ATOL
    resolved = api.UpdatePolicy(**pol).resolve_method(n if rank is None else rank + 1, m=m, n=n,
                                                      rank=rank)
    assert resolved == RAPI.UpdatePolicy(**pol).resolve_method(
        n if rank is None else rank + 1, m=m, n=n, rank=rank)
    if method == "fmm" or (m, n) in ((512, 512), (4, 500)):
        assert resolved == "fmm"


def test_fmm_batched_update_equals_single_updates():
    """``update_many`` stacks same-geometry states into one batched FMM plan
    per eigen-update; each member equals its own single update."""
    rng = np.random.default_rng(49)
    probs = [svd_problem(rng, 120, 150) for _ in range(3)]
    states = [convert.state_from_arrays(*p[:3], device="cpu") for p in probs]
    pol = api.UpdatePolicy(method="fmm", fmm_p=16)
    batched = api.update_many(states, [p[3] for p in probs], [p[4] for p in probs], pol)
    for st, p, got in zip(states, probs, batched):
        one = api.update(st, p[3], p[4], pol)
        for f in ("u", "s", "v"):
            torch.testing.assert_close(getattr(got, f)[..., :120] if f == "v" else getattr(got, f),
                                       getattr(one, f)[..., :120] if f == "v" else getattr(one, f),
                                       rtol=0, atol=1e-13)
    # auto at (2048, 2048) rank 127 fails the fused gate (its 4k(m+n) term)
    assert api.UpdatePolicy().resolve_method(128, m=2048, n=2048, rank=127) == "fmm"


# -- hygiene ----------------------------------------------------------------------


def test_package_imports_neither_jax_nor_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(mod.name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
                     or m.startswith("repro."))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                         cwd=REPO, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_creation_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.eye(3, 4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        api.SvdState.from_dense(x)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        api.SvdState.from_factors(np.eye(3), np.ones(3), np.eye(4))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        convert.state_from_arrays(np.eye(3), np.ones(3), np.eye(4), device="cuda")
    assert api.SvdState.from_dense(x, device="cpu").device.type == "cpu"


def test_unported_routes_raise_by_name():
    rng = np.random.default_rng(47)
    u, s, v, a, b = svd_problem(rng, 4, 6)
    st = convert.state_from_arrays(u, s, v, device="cpu")
    with pytest.raises(NotImplementedError, match="benchmark baseline"):
        api.update(st, a, b, api.UpdatePolicy(method="fast"))
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        api.update(st, a, b, api.UpdatePolicy(mesh=object()))
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        api.SvdState.from_factors(u, s, v, device="cpu", mesh=object())
    # warmup is ported (its tests: test_torch_warmup.py); the cross-card
    # merge and the mesh-sharded service still refuse by name
    from repro_torch import dist
    from repro_torch.serve import SvdService

    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        api.warmup(api.UpdatePolicy(mesh=object()), m=4, n=6, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        dist.distributed_merge(st, "data")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        SvdService(policy=api.UpdatePolicy(mesh=object()))
