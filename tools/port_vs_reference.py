"""The port's plain fused body against the reference's, on the CPU, and both
against a float64 truth: the numbers behind the f32 and bf16 tolerances of
``chip_smoke.py``.

    PYTHONPATH=src:tests python tools/port_vs_reference.py [--problems 128] [--seed 0]

Two cases, printed as one JSON object:

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problems", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    print(json.dumps(survey(args.problems, args.seed), indent=1))


if __name__ == "__main__":
    main()
