"""The port's plain fused body against the reference's, on the CPU, and both
against a float64 truth: the numbers behind the f32 and bf16 tolerances of
``chip_smoke.py``.

    PYTHONPATH=src:tests python tools/port_vs_reference.py [--problems 128] [--seed 0]
        [--part survey|drives|fmm|merge|all]

``--part drives`` runs ``chip_smoke.py``'s structured-update drives
(``drive_inputs``: the same numpy inputs) on the CPU through the port and
through the reference, each with ``method="fused"`` (what ``auto`` resolves
to on both sides at these geometries; remove steps pin ``direct``), and
prints, per drive and stage, port vs reference and each against the f64
truth (see ``drives``); for drive 2 and 2x also the port's sensitivity to
one rounding of its inputs; for drive 1 its distance to the truth taken
apart (``_drive1_split``: the sketch alone, the rank-1 steps fed the exact
SVD of the delta, the step and deflation where the error enters, and one
rounding of the inputs).

``--part fmm`` runs ``chip_smoke.py``'s FMM drives (``fmm_inputs``) (i),
(ii), (iii) and (v) on the CPU through the port and through the reference,
each with the policy the drive uses (the default, whose ``auto`` picks
``fmm`` at these geometries, or ``method="fmm"`` for the quickstart), one
member at a time: each side's distance to the dense truth
(max |U S V[:, :m]^T - (A + a b^T)| / sigma_max, the largest over the
members; the numbers behind chip_smoke's ``FMM_TRUTH_LIMIT``), port
against reference and FMM against ``direct`` (the scale-free measures), and
the members whose FMM plan overflowed (the port's record).

``--part merge`` runs ``chip_smoke.py``'s (s3) merge at a smaller height:
64 row shards of m64 n4096 r32 of a matrix of rank 32, of two kinds:
``rotated`` ((s3)'s: each shard a common orthonormal V0 turned by its own
rotation, singular values 100 .. 1, so that the stacked singular values
cluster) and ``row blocks`` (the row blocks of one matrix with singular
values 100 .. 1, well separated, each shard its block's SVD).  It merges
them with ``merge_tree`` through the port and through the reference, on the
``direct`` and ``fused`` routes, in float64 and float32.  For each it prints
the distance to the stacked matrix's top-32 SVD: ``sigma`` max_i |s_i -
s_M_i| / s_M_i, ``span_u`` and ``span_v`` the RMS sine of the angles to the
top-32 left and right subspaces, ``recon`` ||U S V^T - M||_F / ||M||_F, and
``ortho_u`` max |U^T U - I|.

The survey's two cases, printed as one JSON object:

* ``bf16``: full updates at (32, 48) stored in bf16 and computed in float32
  by both sides, over ``--problems`` problems of each kind of data, against
  ``BF16_ERROR_BUDGET``;
* ``f32``: full updates in float32 at (256, 320), four problems of each kind.

The kinds of data: ``uniform`` is the reference's own test problem
(``tests/test_fused.py``: uniform(1, 9) entries and a standard-normal pair;
one dominant singular value), ``normal`` has standard-normal entries and a
pair scaled so that |a| |b| is the median singular value (no dominant one),
and ``flat`` (f32 only) has random orthogonal factors, singular values
evenly spaced from 2 down to 1, and the same pair scaling.

Measures, per problem, with T = A + a b^T in float64 and s_ref its singular
values (median and largest over the problems are printed):

* ``sigma_rel``: max_i |s_i - s_ref_i| / s_ref_0 (the bf16 budget's measure);
* ``sigma_each``: max_i |s_i - s_ref_i| / s_ref_i;
* ``recon_fro``: ||U S V^T - T||_F / ||T||_F (the budget's documented
  ``recon_rel``);
* ``recon_max``: max |U S V^T - T| / max |T| (the measure the reference's
  bf16 test applies).

``port_vs_reference`` compares the two sides' outputs with the same measures
(the reference's output in place of the truth).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch.kernels import fused_update as F


def problem(rng, m, n, dist):
    """Factors of an (m, n) matrix and a rank-1 pair (numpy, float64)."""
    if dist == "uniform":
        a_mat = rng.uniform(1, 9, (m, n))
        u, s, vt = np.linalg.svd(a_mat)
        return u, s, vt.T.copy(), rng.normal(size=m), rng.normal(size=n)
    if dist == "flat":
        u = np.linalg.qr(rng.normal(size=(m, m)))[0]
        v = np.linalg.qr(rng.normal(size=(n, n)))[0]
        s = np.linspace(2.0, 1.0, m)
    else:
        u, s, vt = np.linalg.svd(rng.normal(size=(m, n)))
        v = vt.T.copy()
    a, b = rng.normal(size=m), rng.normal(size=n)
    b *= np.median(s) / (np.linalg.norm(a) * np.linalg.norm(b))
    return u, s, v, a, b


def _recon(u, s, v):
    m = s.shape[-1]
    return np.einsum("bik,bk,bjk->bij", u, s, v[..., :m])


def measures(out, target=None, s_ref=None, want=None):
    """Per-problem measures of ``out`` (u, s, v) against T (or ``want``)."""
    u, s, v = (np.asarray(x, np.float64) for x in out[:3])
    rec = _recon(u, s, v)
    if want is not None:
        target = _recon(*(np.asarray(x, np.float64) for x in want[:3]))
        s_ref = np.asarray(want[1], np.float64)
    err = np.abs(s - s_ref)
    return {"sigma_rel": err.max(1) / s_ref[:, 0],
            "sigma_each": (err / s_ref).max(1),
            "recon_fro": np.linalg.norm(rec - target, axis=(1, 2)) / np.linalg.norm(target, axis=(1, 2)),
            "recon_max": np.abs(rec - target).max((1, 2)) / np.abs(target).max((1, 2))}


def _summary(meas, budget=None):
    out = {k: {"median": float(np.median(v)), "max": float(v.max())} for k, v in meas.items()}
    if budget:
        for k, lim in budget.items():
            out[k]["over_budget"] = int((meas[k] > lim).sum())
    return out


def compare(stack, jdt, tdt, budget=None):
    """Both sides on the problems ``stack`` (numpy, rounded to ``jdt``)."""
    m = stack[1].shape[-1]
    target = _recon(*stack[:3]) + stack[3][:, :, None] * stack[4][:, None, :]
    s_ref = np.linalg.svd(target, compute_uv=False)
    rf = ref("kernels.fused_update")
    want = jax.vmap(rf.fused_update_xla)(*(jnp.asarray(x, jdt) for x in stack))
    want = [np.asarray(w.astype(jnp.float32)) for w in want[:3]]
    got = F._fused_body(*(torch.tensor(x).to(tdt) for x in stack))
    got = [x.float().numpy() for x in got[:3]]
    assert want[0].shape[-1] == m
    return {"reference": _summary(measures(want, target, s_ref), budget),
            "port": _summary(measures(got, target, s_ref), budget),
            "port_vs_reference": _summary(measures(got, want=want))}


def _rounded(stack, jdt):
    return [np.asarray(jnp.asarray(x, jdt).astype(jnp.float64)) for x in stack]


def survey(problems: int = 128, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    res = {}
    budget = {"sigma_rel": F.BF16_ERROR_BUDGET["sigma_rel"],
              "recon_fro": F.BF16_ERROR_BUDGET["recon_rel"],
              "recon_max": F.BF16_ERROR_BUDGET["recon_rel"]}
    for dist in ("uniform", "normal"):
        stack = [np.stack(x) for x in zip(*(problem(rng, 32, 48, dist) for _ in range(problems)))]
        key = f"bf16 (32, 48) {dist}"
        res[key] = compare(_rounded(stack, jnp.bfloat16), jnp.bfloat16, torch.bfloat16, budget)
        res[key]["problems"] = problems
    for dist in ("uniform", "normal", "flat"):
        stack = [np.stack(x) for x in zip(*(problem(rng, 256, 320, dist) for _ in range(4)))]
        res[f"f32 (256, 320) {dist}"] = compare(_rounded(stack, jnp.float32), jnp.float32,
                                                torch.float32)
    return res


def _scale_free(got, want):
    """recon (||U S V^T - U' S' V'^T||_F / ||U' S' V'^T||_F) and sigma
    (max_i |s_i - s'_i| / s'_i), the largest over the batch (chip_smoke.py's
    measures); (u, s, v) stacked numpy, v cut to the rank's columns."""
    rg, rw = (np.einsum("bik,bk,bjk->bij", x[0], x[1], x[2][..., :x[1].shape[-1]])
              for x in (got, want))
    recon = np.linalg.norm(rg - rw, axis=(1, 2)) / np.linalg.norm(rw, axis=(1, 2))
    return {"recon": float(recon.max()),
            "sigma": float((np.abs(got[1] - want[1]) / np.abs(want[1])).max())}


def _vs_truth(out, truth):
    """max over the batch of |U S V^T - T| / sigma_max(T) (the top-r
    reconstruction of T for a rank-r state), as chip_smoke.py reads it."""
    u, s, v = out
    r = s.shape[-1]
    tu, ts, tvt = np.linalg.svd(truth, full_matrices=False)
    target = np.einsum("bik,bk,bkj->bij", tu[..., :r], ts[..., :r], tvt[..., :r, :])
    rec = np.einsum("bik,bk,bjk->bij", u, s, v[..., :r])
    return float((np.abs(rec - target).max(axis=(1, 2)) / ts[:, 0]).max())


def _arrays(states, stacked):
    if stacked:
        return [np.asarray(getattr(states, f), np.float64) for f in ("u", "s", "v")]
    return [np.stack([np.asarray(getattr(x, f), np.float64) for x in states]) for f in ("u", "s", "v")]


def _run_stages(states, stages, pol):
    from repro_torch import api

    outs = []
    for ops in stages:
        states = api.apply_many(states, ops, pol)
        outs.append(states)
    return outs


def _one_rounding(run, factors, dtype, trials: int = 3):
    """The route's own sensitivity: ``run`` on the factors with each entry
    perturbed by one rounding of ``dtype`` (relative N(0, eps/2)) against
    ``run`` on the factors as they are, by ``_scale_free``, the largest over
    ``trials`` perturbations; one entry per stage ``run`` returns."""
    eps = float(torch.finfo(dtype).eps)
    base = run(factors)
    worst = [{"recon": 0.0, "sigma": 0.0} for _ in base]
    for t in range(1, trials + 1):
        g = np.random.default_rng(t)
        fs = [tuple(x * (1 + 0.5 * eps * g.normal(size=np.shape(x))) for x in f) for f in factors]
        for w, got, want in zip(worst, run(fs), base):
            e = _scale_free(got, want)
            for k in w:
                w[k] = max(w[k], e[k])
    return worst


def _truth_err(out, truth, m):
    """max over members of |U S V[:, :m]^T - T| and |s - s_T|, over sigma_max
    (chip_smoke.py's drive-1 measure)."""
    u, s, v = (np.asarray(x, np.float64) for x in out)
    s_t = np.linalg.svd(truth, compute_uv=False)
    rec = np.einsum("bik,bk,bjk->bij", u, s, v[..., :m])
    return max(float((np.abs(rec - truth).max(axis=(1, 2)) / s_t[:, 0]).max()),
               float((np.abs(s - s_t).max(axis=1) / s_t[:, 0]).max()))


def _drive1_split(d1, op, truth, rapi) -> dict:
    """Drive 1's distance to the dense truth taken apart: the sketch of S
    against S; the 8 rank-1 steps fed S's exact top-8 SVD (port fused and
    direct, reference fused), step by step; the step and member where the
    error enters, with the left side's second eigen-update there (the z
    component its deflation drops, the tolerance, the vector's turn) and the
    step rerun with a tighter deflation tolerance; and the whole drive under
    one rounding of its inputs."""
    from repro_torch import api
    from repro_torch.core import svd_update as su
    from repro_torch.core.eigh_update import apply_update, eigenvalues, make_plan
    from repro_torch.updates import sketch

    u, s, v = d1["u"], d1["s"], d1["v"]
    m, n = u.shape[1], v.shape[1]
    a0 = np.einsum("bik,bk,bjk->bij", u, s, v[..., :m])
    delta = truth - a0
    out = {}
    us, ss, vs = (x.numpy() for x in sketch.sparse_sketch_svd(
        torch.as_tensor(d1["rows"]), torch.as_tensor(d1["cols"]), torch.as_tensor(d1["vals"]),
        m=m, n=n, k=d1["rank"]))
    s_t = np.linalg.svd(truth, compute_uv=False)[:, 0]
    out["sketch_vs_S_over_sigma_max"] = float(
        (np.abs(np.einsum("bik,bk,bjk->bij", us, ss, vs) - delta).max(axis=(1, 2)) / s_t).max())
    out["rank_S_max"] = int(max(np.linalg.matrix_rank(x) for x in delta))
    du, ds, dvt = np.linalg.svd(delta)
    k = d1["rank"]
    a_k = (du[..., :k] * ds[:, None, :k]).transpose(0, 2, 1)
    b_k = dvt[:, :k, :]
    for method in ("fused", "direct"):
        st = api.update_rank_k(api.SvdState.from_factors(u, s, v, device="cpu"), a_k, b_k,
                               api.UpdatePolicy(method=method))
        out[f"exact_top8_steps_port_{method}_vs_truth"] = _truth_err((st.u, st.s, st.v), truth, m)
    rst = rapi.update_rank_k(rapi.SvdState.from_factors(*(jnp.asarray(x) for x in (u, s, v))),
                             jnp.asarray(a_k), jnp.asarray(b_k), rapi.UpdatePolicy(method="fused"))
    out["exact_top8_steps_reference_fused_vs_truth"] = _truth_err((rst.u, rst.s, rst.v), truth, m)
    # step by step (direct route), each step against its own dense truth
    st = api.SvdState.from_factors(u, s, v, device="cpu")
    cur, per_step, before = a0, [], None
    for i in range(k):
        prev, st = st, api.update(st, a_k[:, i], b_k[:, i], api.UpdatePolicy(method="direct"))
        cur = cur + a_k[:, i, :, None] * b_k[:, i, None, :]
        rec = np.einsum("bik,bk,bjk->bij", st.u.numpy(), st.s.numpy(), st.v.numpy()[..., :m])
        errs = np.abs(rec - cur).max(axis=(1, 2)) / np.linalg.svd(cur, compute_uv=False)[:, 0]
        per_step.append({"max": float(errs.max()), "members_above_1e-12": int((errs > 1e-12).sum())})
        if before is None and errs.max() > 1e-12:
            before = (i, int(errs.argmax()), prev)
    out["exact_top8_steps_direct_per_step"] = per_step
    if before is not None:
        i, j, prev = before
        t = lambda x: torch.as_tensor(np.asarray(x))[j:j + 1]  # noqa: E731
        uu, sv, vv, aa, bb = t(prev.u), t(prev.s), t(prev.v), t(a_k[:, i]), t(b_k[:, i])
        # the left side's two chained eigen-updates, as core/svd_update.py runs them
        b_t = su._mv(uu, sv * su._mtv(vv, bb)[:, :m])
        rho1, rho2, qp, qn = su._rank2_symmetric_split((bb * bb).sum(1))
        a1 = qp[0][:, None] * aa + qp[1][:, None] * b_t
        b1 = qn[0][:, None] * aa + qn[1][:, None] * b_t
        plan1 = make_plan(sv * sv, su._mtv(uu, a1), rho1, rho_positive=True)
        q1, d1v = apply_update(plan1, uu), eigenvalues(plan1)
        z2 = su._mtv(q1, b1)
        plan2 = make_plan(d1v, z2, rho2, rho_positive=False)
        q2 = apply_update(plan2, torch.eye(m, dtype=torch.float64)[None])[0].numpy()
        mat = torch.diag(d1v[0]) + rho2[0] * torch.outer(z2[0], z2[0])
        exact = torch.linalg.eigh(mat)[1].numpy()
        turn = np.sqrt(np.clip(1 - np.sum(q2 * exact, 0) ** 2, 0, None))
        scale = max(float(d1v.abs().max()), float(rho2.abs()[0] * (z2 * z2).sum()))
        dropped = (~plan2.valid[0]).nonzero().flatten()
        out["first_step_off"] = {
            "step": i, "member": j,
            "second_left_eigen_update": {
                "n_deflated": int(dropped.numel()),
                "smallest_abs_z": float(z2.abs().min()),
                "rho": float(rho2[0]),
                "tol_64_eps_scale": 64 * float(torch.finfo(torch.float64).eps) * scale,
                "largest_vector_turn_rad": float(turn.max())}}
        for rtol in (None, 1e-20):
            r = su._svd_update_impl(uu, sv, vv, aa, bb, method="direct", deflate_rtol=rtol)
            cur_j = a0[j] + np.einsum("ki,kj->ij", a_k[j, :i + 1], b_k[j, :i + 1])
            rec = (r.u[0].numpy() * r.s[0].numpy()) @ r.v[0].numpy()[:, :m].T
            out["first_step_off"][f"step_vs_truth_deflate_rtol_{rtol or '64eps'}"] = float(
                np.abs(rec - cur_j).max() / np.linalg.svd(cur_j, compute_uv=False)[0])

    def whole(fs):
        (uu, su_, vv, vals), = fs
        st = api.SvdState.from_factors(uu, su_, vv, device="cpu")
        o = api.apply(st, type(op)(d1["rows"], d1["cols"], vals, rank=k),
                      api.UpdatePolicy(method="fused"))
        return [[o.u.numpy(), o.s.numpy(), o.v.numpy()]]

    out["port_one_rounding"] = _one_rounding(whole, [(u, s, v, d1["vals"])], torch.float64)[0]
    return out


def drives() -> dict:
    """chip_smoke.py's drives on the CPU: port vs reference vs truth."""
    from chip_smoke import drive_inputs
    from repro_torch import api, updates

    rapi, ru = ref("api"), ref("updates")
    inputs = drive_inputs()
    pol, rpol = api.UpdatePolicy(method="fused"), rapi.UpdatePolicy(method="fused")
    res = {}

    d1 = inputs["1"]
    m1 = d1["u"].shape[1]
    op = updates.Sparse(d1["rows"], d1["cols"], d1["vals"], rank=d1["rank"])
    rop = ru.Sparse(d1["rows"], d1["cols"], d1["vals"], rank=d1["rank"])
    got = _arrays(api.apply(api.SvdState.from_factors(d1["u"], d1["s"], d1["v"], device="cpu"),
                            op, pol), True)
    want = _arrays(rapi.apply(rapi.SvdState.from_factors(*map(jnp.asarray, (d1["u"], d1["s"],
                                                                             d1["v"]))),
                              rop, rpol), True)
    truth = op.apply_dense(np.einsum("bik,bk,bjk->bij", d1["u"], d1["s"],
                                     d1["v"][..., :m1])).numpy()
    res["1 full B128 (32,48) f64 Sparse rank 8"] = {
        "port_vs_reference": _scale_free(got, want), "port_vs_truth": _vs_truth(got, truth),
        "reference_vs_truth": _vs_truth(want, truth),
        **_drive1_split(d1, op, truth, rapi)}

    d2 = inputs["2"]
    for drive, key in (("2", "sparse"), ("2x", "sparse_exact")):
        stages = [([updates.Compose((updates.Decay(d2["decay"]), updates.Sparse(*c, rank=d2["rank"])))
                    for c in d2[key]],
                   [ru.Compose((ru.Decay(d2["decay"]), ru.Sparse(*c, rank=d2["rank"])))
                    for c in d2[key]]),
                  ([updates.RankK(*uv) for uv in d2["rank_k"]], [ru.RankK(*uv) for uv in d2["rank_k"]])]
        names = ("Compose(Decay, Sparse rank 8)", "then RankK(32)")
        truth = np.stack([(u * s) @ v.T for u, s, v in d2["factors"]])
        truths = []
        for ops, _ in stages:
            truth = np.stack([o.apply_dense(t).numpy() for o, t in zip(ops, truth)])
            truths.append(truth)
        port64 = []
        for dt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
            sts = [api.SvdState.from_factors(*f, device="cpu", dtype=dt) for f in d2["factors"]]
            rsts = [rapi.SvdState.from_factors(*(jnp.asarray(x, jdt) for x in f)) for f in d2["factors"]]
            sens = _one_rounding(lambda fs: [_arrays(x, False) for x in _run_stages(
                [api.SvdState.from_factors(*f, device="cpu", dtype=dt) for f in fs],
                [o for o, _ in stages], pol)], d2["factors"], dt)
            for j, ((ops, rops), name, truth) in enumerate(zip(stages, names, truths)):
                sts = api.apply_many(sts, ops, pol)
                rsts = rapi.apply_many(rsts, rops, rpol)
                got, want = _arrays(sts, False), _arrays(rsts, False)
                if dt == torch.float64:
                    port64.append(got)
                res[f"{drive} truncated B16 (1024,1024) r16 {key} {dt} {name}"] = {
                    "sigma_max_port": float(got[1][:, 0].max()),
                    "sigma_max_reference": float(want[1][:, 0].max()),
                    "sigma_max_truth": float(np.linalg.svd(truth, compute_uv=False)[:, 0].max()),
                    "port_vs_reference": _scale_free(got, want),
                    "port_vs_port_f64": _scale_free(got, port64[j]),
                    "reference_vs_port_f64": _scale_free(want, port64[j]),
                    "port_one_rounding": sens[j],
                    "port_vs_truth": _vs_truth(got, truth),
                    "reference_vs_truth": _vs_truth(want, truth)}

    d3 = inputs["3"]
    cut = d3["factors"][0][0].shape[0] - d3["keep"]
    sts = [api.SvdState.from_factors(*f, device="cpu") for f in d3["factors"]]
    rsts = [rapi.SvdState.from_factors(*map(jnp.asarray, f)) for f in d3["factors"]]
    got = _arrays(api.apply_many(sts, [updates.Window(d3["keep"], lam=d3["lam"])] * len(sts), pol),
                  False)
    want = _arrays(rapi.apply_many(rsts, [ru.Window(d3["keep"], lam=d3["lam"])] * len(sts), rpol),
                   False)
    truth = np.stack([d3["lam"] * ((u * s) @ v.T)[cut:] for u, s, v in d3["factors"]])
    res["3 Window B4 (1024,768) r8 cut 64 f64"] = {
        "port_vs_reference": _scale_free(got, want), "port_vs_truth": _vs_truth(got, truth),
        "reference_vs_truth": _vs_truth(want, truth)}
    return res


def fmm() -> dict:
    """chip_smoke.py's FMM drives (i), (ii), (iii), (v) on the CPU: port and
    reference against the dense truth, against each other and against their
    own ``direct`` route, member by member."""
    from chip_smoke import fmm_inputs
    from repro_torch import api
    from repro_torch.core import fmm as tfmm

    rapi = ref("api")
    inputs = fmm_inputs()
    drives_ = {
        "i (1024,1024) uniform auto": ([inputs["i"]], {}),
        "ii (1024,1024) uniform auto, 8 members": (inputs["ii"], {}),
        "iii quickstart (200,300) fmm": ([inputs["iii"]], {"method": "fmm"}),
        "v (1024,1024) spread squares auto, 8 members": (inputs["v"], {}),
    }
    res = {}
    for name, (members, kw) in drives_.items():
        worst = {"port_vs_truth": 0.0, "reference_vs_truth": 0.0,
                 "port_vs_reference": {"recon": 0.0, "sigma": 0.0},
                 "port_fmm_vs_direct": {"recon": 0.0, "sigma": 0.0},
                 "reference_fmm_vs_direct": {"recon": 0.0, "sigma": 0.0}}
        overflowed = []
        for i, mem in enumerate(members):
            if len(mem) == 3:
                a_mat, a, b = mem
                tst = api.SvdState.from_dense(a_mat, device="cpu")
                rst = rapi.SvdState.from_dense(jnp.asarray(a_mat))
            else:
                u, sv, v, a, b = mem
                a_mat = (u * sv) @ v.T
                tst = api.SvdState.from_factors(u, sv, v, device="cpu")
                rst = rapi.SvdState.from_factors(*map(jnp.asarray, (u, sv, v)))
            m = a_mat.shape[0]
            truth = (a_mat + np.outer(a, b))[None]
            tfmm.OVERFLOWED.clear()
            got = _arrays([api.update(tst, a, b, api.UpdatePolicy(**kw))], False)
            overflowed += [(i, plan) for plan in tfmm.OVERFLOWED]
            want = _arrays([rapi.update(rst, jnp.asarray(a), jnp.asarray(b),
                                        rapi.UpdatePolicy(**kw))], False)
            cut = lambda x: [x[0], x[1], x[2][..., :m]]  # noqa: E731
            pairs = {"port_vs_reference": (got, want)}
            if i == 0:
                pairs["port_fmm_vs_direct"] = (got, _arrays(
                    [api.update(tst, a, b, api.UpdatePolicy(method="direct"))], False))
                pairs["reference_fmm_vs_direct"] = (want, _arrays(
                    [rapi.update(rst, jnp.asarray(a), jnp.asarray(b),
                                 rapi.UpdatePolicy(method="direct"))], False))
            for key, (x, y) in pairs.items():
                e = _scale_free(cut(x), cut(y))
                worst[key] = {k: max(worst[key][k], e[k]) for k in e}
            worst["port_vs_truth"] = max(worst["port_vs_truth"], _truth_err(got, truth, m))
            worst["reference_vs_truth"] = max(worst["reference_vs_truth"],
                                              _truth_err(want, truth, m))
        res[name] = {**worst, "port_overflowed (member, plan members)": overflowed}

    # drive (v)'s own sensitivity (the port on the CPU): one rounding of the
    # factors, and the deflation tolerance halved and doubled
    factors = [x[:3] for x in inputs["v"]]
    pairs_v = [x[3:] for x in inputs["v"]]

    def run_v(fs, **kw):
        sts = [api.SvdState.from_factors(*f, device="cpu") for f in fs]
        return [_arrays(api.update_many(sts, [p[0] for p in pairs_v], [p[1] for p in pairs_v],
                                        api.UpdatePolicy(**kw)), False)]

    v_res = res["v (1024,1024) spread squares auto, 8 members"]
    v_res["port_one_rounding"] = _one_rounding(run_v, factors, torch.float64, trials=2)[0]
    base = run_v(factors)[0]
    eps = float(np.finfo(np.float64).eps)
    for f in (0.5, 2.0):
        got = run_v(factors, deflate_rtol=f * 64 * eps)[0]
        v_res[f"port_deflate_rtol_x{f}_per_member_recon"] = [
            _scale_free([x[i:i + 1] for x in got], [x[i:i + 1] for x in base])["recon"]
            for i in range(len(factors))]
    return res


def merge(shards: int = 64, m: int = 64, n: int = 4096, r: int = 32, seed: int = 0) -> dict:
    """(s3)'s merge at height ``m``: port and reference ``merge_tree`` against
    the stacked matrix's top-32 SVD, by route and dtype."""
    from repro_torch import api
    from repro_torch.core.svd_update import TruncatedSvd
    from repro_torch.dist import merge_tree

    rapi, rmerge = ref("api"), ref("dist.merge")
    rtsvd = ref("core.svd_update").TruncatedSvd
    rng = np.random.default_rng(seed)

    def orth(*shape):
        return np.linalg.qr(rng.normal(size=shape))[0]

    s = np.geomspace(100.0, 1.0, r)
    v0 = orth(n, r)
    rotated = [(orth(m, r), s, v0 @ orth(r, r)) for _ in range(shards)]
    blocks = np.split((orth(shards * m, r) * s) @ orth(n, r).T, shards)
    row_blocks = []
    for blk in blocks:
        u, sv, vt = np.linalg.svd(blk, full_matrices=False)
        row_blocks.append((u[:, :r], sv[:r], vt[:r].T))

    def span(truth, got):
        q = np.linalg.qr(got)[0]
        return float(np.linalg.norm(q - truth @ (truth.T @ q)) / r ** 0.5)

    res = {}
    for kind, factors in (("rotated", rotated), ("row blocks", row_blocks)):
        stacked = np.concatenate([(u * sv) @ v.T for u, sv, v in factors])
        uu, ss, vvt = np.linalg.svd(stacked, full_matrices=False)
        u_t, sig, v_t = uu[:, :r], ss[:r], vvt[:r].T

        def measures(out):
            u, sv, v = (np.asarray(x, dtype=np.float64) for x in (out.u, out.s, out.v))
            rec = np.linalg.norm((u * sv) @ v.T - stacked) / np.linalg.norm(stacked)  # noqa: B023
            return {"sigma": float(np.max(np.abs(sv - sig) / sig)),  # noqa: B023
                    "span_u": span(u_t, u), "span_v": span(v_t, v),  # noqa: B023
                    "recon": float(rec), "ortho_u": float(np.max(np.abs(u.T @ u - np.eye(r))))}

        out = {"gaps_min_rel": float(np.min((sig[:-1] - sig[1:]) / sig[:-1])),
               "sigma_33_over_sigma_1": float(ss[r] / ss[0])}
        for method in ("direct", "fused"):
            for tdt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
                got = merge_tree([TruncatedSvd(*(torch.as_tensor(x, dtype=tdt) for x in f))
                                  for f in factors], policy=api.UpdatePolicy(method=method))
                want = rmerge.merge_tree([rtsvd(*(jnp.asarray(x, dtype=jdt) for x in f))
                                          for f in factors],
                                         policy=rapi.UpdatePolicy(method=method))
                out[f"{method} {str(tdt)[6:]}"] = {"port": measures(got),
                                                    "reference": measures(want)}
        res[kind] = out
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problems", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--part", choices=("survey", "drives", "fmm", "merge", "all"), default="all")
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # chip_smoke.py
    out = {}
    if args.part in ("survey", "all"):
        out["survey"] = survey(args.problems, args.seed)
    if args.part in ("drives", "all"):
        out["drives"] = drives()
    if args.part in ("fmm", "all"):
        out["fmm"] = fmm()
    if args.part in ("merge", "all"):
        out["merge"] = merge()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
