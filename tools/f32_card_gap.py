"""Where kernel A and its plain body part in float32, on the card.

    python3 tools/f32_card_gap.py

Full updates at (256, 320), float32, on three kinds of data, B=8 each:
``uniform`` (the reference's test problem, uniform(1, 9) entries and one
dominant singular value), ``normal`` (standard-normal entries and a pair
with |a| |b| the median singular value) and ``geometric`` (the data of
``chip_smoke.py``: random orthogonal factors, singular values 100 .. 1
geometric, the same pair scaling; B=32, as there).  Results of the same
inputs:

* ``kernel``: kernel A on the card;
* ``plain``: the plain body on the card;
* ``plain_cpu``: the plain body on the CPU;
* ``plain_perturbed_<seed>``: the plain body on the card, on inputs each
  multiplied by (1 + 2^-23 g) with g standard normal (one f32 rounding's
  worth), for four seeds.

It prints, as JSON, each pair's differences (Frobenius and max-abs of
U S V^T, relative to the target's Frobenius norm and to sigma_max; the
largest relative singular-value difference) and each result's error against
the float64 truth T = A + a b^T, the largest over the batch.  For the
update where kernel and plain body differ most it lists the triplets whose
sign (the product of the signs of u_k . u_p and v_k . v_p) the two decide
differently, with sigma_j and the pairing quality |u_j^T T v_j| / s_j of
each side: 1 for a triplet the route got right, near 0 where its f32
vectors are wrong and the sign fix (the sign of u_j^T T v_j) is decided by
rounding.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import fused_update as FU  # noqa: E402

M, N = 256, 320
BATCH = {"uniform": 8, "normal": 8, "geometric": 32}


def problems(rng, dist):
    bsz = BATCH[dist]
    if dist == "geometric":
        u = np.linalg.qr(rng.normal(size=(bsz, M, M)))[0]
        v = np.linalg.qr(rng.normal(size=(bsz, N, N)))[0]
        s = np.tile(np.geomspace(100.0, 1.0, M), (bsz, 1))
    else:
        mats = rng.uniform(1, 9, (bsz, M, N)) if dist == "uniform" else rng.normal(size=(bsz, M, N))
        u, s, vt = np.linalg.svd(mats)
        v = vt.transpose(0, 2, 1)
    a, b = rng.normal(size=(bsz, M)), rng.normal(size=(bsz, N))
    if dist != "uniform":
        b *= (np.median(s, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)))[:, None]
    return [u, s, v, a, b]


def sign_flips(x, y, target):
    """Triplets whose sign x and y decide differently, in the update where
    their reconstructions differ most."""
    rx, ry = recon(*x[:3]).cpu(), recon(*y[:3]).cpu()
    i = int(((rx - ry).flatten(1).norm(dim=1)).argmax())
    ux, sx, vx = (t[i].double().cpu() for t in x[:3])
    uy, sy, vy = (t[i].double().cpu() for t in y[:3])
    prod = torch.sign((ux * uy).sum(0)) * torch.sign((vx[:, :M] * vy[:, :M]).sum(0))
    tt = target[i]
    out = []
    for j in (prod < 0).nonzero().flatten().tolist():
        out.append({"j": j, "sigma": float(sy[j]),
                    "quality_x": float((ux[:, j] @ tt @ vx[:, j]).abs() / sx[j]),
                    "quality_y": float((uy[:, j] @ tt @ vy[:, j]).abs() / sy[j])})
    return {"update": i, "triplets": out}


def recon(u, s, v):
    return (u.double() * s[:, None, :].double()) @ v[..., :M].double().mT


def diff(x, y, target_fro, smax):
    rx, ry = recon(*x[:3]).cpu(), recon(*y[:3]).cpu()
    d = rx - ry
    sx, sy = x[1].double().cpu(), y[1].double().cpu()
    return {"recon_fro": float((d.flatten(1).norm(dim=1) / target_fro).max()),
            "recon_max_over_smax": float((d.abs().amax((1, 2)) / smax).max()),
            "recon_max_abs": float(d.abs().max()),
            "sigma_each": float(((sx - sy).abs() / sy.abs()).max())}


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(0)
    out = {}
    for dist in ("uniform", "normal", "geometric"):
        p = problems(rng, dist)
        target = np.einsum("bik,bk,bjk->bij", p[0], p[1], p[2][..., :M]) + p[3][:, :, None] * p[4][:, None, :]
        s_true = torch.as_tensor(np.linalg.svd(target, compute_uv=False))
        truth = (torch.as_tensor(target), s_true)
        tfro = torch.as_tensor(np.linalg.norm(target, axis=(1, 2)))
        smax = s_true[:, 0]
        dev = [torch.as_tensor(x, dtype=torch.float32, device="cuda").contiguous() for x in p]
        cpu = [x.cpu() for x in dev]
        res = {"kernel": FU.fused_update_cuda(*dev), "plain": FU._fused_body(*dev),
               "plain_cpu": FU._fused_body(*cpu)}
        pairs = [("kernel", "plain"), ("plain", "plain_cpu"), ("kernel", "plain_cpu")]
        for seed in range(1, 5):
            g = torch.Generator("cuda").manual_seed(seed)
            pert = [x * (1 + 2.0 ** -23 * torch.randn(x.shape, generator=g, device="cuda")) for x in dev]
            res[f"plain_perturbed_{seed}"] = FU._fused_body(*pert)
            pairs.append((f"plain_perturbed_{seed}", "plain"))
        torch.cuda.synchronize()
        case = {}
        for x, y in pairs:
            case[f"{x} vs {y}"] = diff(res[x], res[y], tfro, smax)
        case["sign flips, kernel vs plain"] = sign_flips(res["kernel"], res["plain"], truth[0])
        case["sign flips, plain_perturbed_1 vs plain"] = sign_flips(res["plain_perturbed_1"],
                                                                   res["plain"], truth[0])
        for name, r in res.items():
            rx = recon(*r[:3]).cpu()
            d = rx - truth[0]
            case[f"{name} vs f64 truth"] = {
                "recon_fro": float((d.flatten(1).norm(dim=1) / tfro).max()),
                "recon_max_over_smax": float((d.abs().amax((1, 2)) / smax).max()),
                "sigma_each": float(((r[1].double().cpu() - s_true).abs() / s_true).max())}
        out[dist] = case
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
