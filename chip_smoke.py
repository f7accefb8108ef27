#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero, printing no
result) when it fails:

1. build: compiles every CUDA source of ``src/repro_torch/csrc`` with nvcc for
   sm_90a (in parallel) into ``build/repro_torch/`` and prints the seconds;
2. kernels against their plain PyTorch versions on the card, at the shapes
   the main path and the benchmarks give them, each with its tolerance (see
   ``TOL``), and each check shown to reject planted faults; bf16 storage
   against the reference's ``BF16_ERROR_BUDGET``;
3. the main path: ``api.update_many`` / ``api.update`` with the default policy
   (auto -> fused kernels A and B) and with ``method="pallas"`` (kernel C),
   checked by reconstruction (f64) and against the same route on the CPU;
   the launch counters are zeroed just before and read just after, and every
   kernel must have launched;
4. times: median of CUDA-event timings after warm-up, for each kernel, its
   plain version and one batched ``torch.linalg.svd`` of the updated matrices
   (a yardstick the port never calls), beside a bound from bytes and
   operations.

The last lines are the ``kernels`` JSON line, the card (nvidia-smi), and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks from NVIDIA's data sheet: HBM3 bandwidth; f32 outside the
# tensor cores (TF32 would not hold the f32 results), and f64 on the DMMA
# tensor cores, which compute at full f64 precision.  The kernels use neither
# tensor-core path yet, so the bound is the least time the card could take.
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 67e12}
N_BISECT, N_NEWTON = 16, 6
DEVICE = "cuda"

# Kernel against its plain version on the same inputs, on data with no
# dominant singular value (see ``spectrum``), by two scale-free measures
# taken per update and maximised over the batch:
#   recon  ||U S V^T - U' S' V'^T||_F / ||U' S' V'^T||_F
#   sigma  max_i |s_i - s'_i| / s'_i
# Each limit sits above the readings of the sound kernel on the H100
# (PERF.md) and below what a planted fault gives: each check is also run on
# the kernel's output with the right factor left unrotated, and with the
# sign of U's column of the largest and of the smallest singular value
# flipped, and must reject them.  The one exception is kernel A in float32 at
# (256, 320): there the route itself (the reference's as much as the port's)
# does not determine its smallest triplets -- one float32 rounding of the
# inputs rotates them or flips their signs, moving ``recon`` by up to 1e-2
# (printed beside the check as the route's own sensitivity) -- so its limit
# is that sensitivity's size and the smallest triplet's sign is not required.
TOL = {("A", "float64"): {"recon": 1e-10, "sigma": 1e-10},
       ("B", "float64"): {"recon": 1e-10, "sigma": 1e-10},
       ("A", "float32"): {"recon": 5e-2, "sigma": 2e-3, "smallest_sign": False},
       ("B", "float32"): {"recon": 1e-3, "sigma": 1e-4},
       ("A", "bfloat16"): {"recon": 3e-3, "sigma": 1e-2}}
# the main path on the card against the same route on the CPU (plain
# versions), same inputs and measures; f64 is also held to the reference's
# own limit against A + a b^T: max |U S V^T - (A + a b^T)| / sigma_max
MAIN_TOL = {"float64": {"recon": 1e-10, "sigma": 1e-10},
            "float32": {"recon": 5e-3, "sigma": 1e-4}}
F64_RECON_LIMIT = 1e-10
# the Cauchy product against its plain version, relative to max |out|: N
# products summed in another order
CAUCHY_TOL = {"float64": 1e-12, "float32": 1e-5}


def log(*args):
    print(*args, flush=True)


def require(ok, what: str) -> None:
    """Fail the run (an explicit raise: asserts vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import api, convert
    from repro_torch.kernels import _build, cauchy_matmul as CM, fused_update as FU

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(DEVICE)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # -- phase 1: build ---------------------------------------------------------
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    log(f"build: {time.perf_counter() - t0:.1f} s into {out_dir.relative_to(ROOT)}")
    for f in sorted(out_dir.glob("*.log")):
        regs = [ln.strip() for ln in f.read_text().splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {f.stem}: " + " | ".join(regs[-2:]))

    rng = np.random.default_rng(0)

    def tt(x, dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype).contiguous()

    def orthonormal(bsz, rows, cols):
        q, _ = np.linalg.qr(rng.normal(size=(bsz, rows, cols)))
        return q

    def pair(m, n, scale):
        """A rank-1 pair with |a| |b| = scale, per update."""
        a = rng.normal(size=(len(scale), m))
        b = rng.normal(size=(len(scale), n))
        b *= (np.asarray(scale) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)))[:, None]
        return a, b

    def spectrum(bsz, k):
        """Singular values 100 .. 1, geometric: no dominant one, and gaps
        wide enough (1.8 % at m=256) that float32 rounding moves the route's
        vectors little, so two summation orders can be compared closely."""
        return np.tile(np.geomspace(100.0, 1.0, k), (bsz, 1))

    def full_inputs(bsz, m, n, dtype, dist="geometric"):
        """B full states and a pair each.  ``geometric``: random orthogonal
        factors, ``spectrum``, and |a| |b| the median singular value;
        ``uniform``: the reference's own test problem, the SVD of a
        uniform(1, 9) matrix (one dominant singular value) and a
        standard-normal pair."""
        if dist == "uniform":
            u, s, vt = np.linalg.svd(rng.uniform(1, 9, (bsz, m, n)))
            v = vt.transpose(0, 2, 1)
            a, b = rng.normal(size=(bsz, m)), rng.normal(size=(bsz, n))
        else:
            u, s, v = orthonormal(bsz, m, m), spectrum(bsz, m), orthonormal(bsz, n, n)
            a, b = pair(m, n, np.median(s, axis=1))
        return [tt(x, dtype) for x in (u, s, v, a, b)]

    def trunc_inputs(bsz, m, n, r, dtype):
        """B rank-r states (orthonormal factors, ``spectrum``) and a pair each
        with |a| |b| the median kept singular value."""
        s = spectrum(bsz, r)
        a, b = pair(m, n, np.median(s, axis=1))
        return [tt(x, dtype) for x in (orthonormal(bsz, m, r), s, orthonormal(bsz, n, r), a, b)]

    def cauchy_inputs(bsz, r, n, m, dtype):
        src = np.sort(rng.normal(size=(bsz, n)), axis=1)
        av = np.take_along_axis(src, rng.integers(0, n, size=(bsz, m)), axis=1)
        tau = rng.normal(size=(bsz, m)) * 1e-3
        tau[:, 0] = 0.0
        return [tt(rng.normal(size=(bsz, r, n)), dtype), tt(src, dtype), tt(av, dtype),
                tt(tau, dtype), tt(rng.random((bsz, m)) > 0.2, dtype)]

    def recon(u, s, v):
        k = s.shape[-1]
        return (u[..., :, :k].double() * s[..., None, :].double()) @ v[..., :, :k].double().mT

    def measures(got, want):
        """recon and sigma (see TOL) of ``got`` against ``want``, each the
        largest over the batch (singular values below 1e-3 sigma_max, the
        numerical zeros of rank-deficient states, are measured against
        1e-3 sigma_max), and ``abs``: the largest absolute difference of
        U S V^T and of s."""
        rw, rg = recon(*want[:3]), recon(*got[:3])
        recon_e = (rg - rw).flatten(-2).norm(dim=-1) / rw.flatten(-2).norm(dim=-1)
        sw, sg = want[1].double(), got[1].double()
        floor = 1e-3 * sw.abs().amax(-1, keepdim=True)
        sigma_e = ((sg - sw).abs() / torch.maximum(sw.abs(), floor)).amax(-1)
        return {"recon": float(recon_e.max()), "sigma": float(sigma_e.max()),
                "abs": max(float((rg - rw).abs().max()), float((sg - sw).abs().max()))}

    def name_of(dtype):
        return str(dtype).replace("torch.", "")

    def check(label, err, tol):
        log(f"  {label}: max err {err:.3e} (tol {tol:.0e})")
        require(np.isfinite(err) and err <= tol, f"{label}: error {err} above {tol}")
        return err

    def check_pair(label, got, want, tol):
        """Both measures within ``tol``; returns the largest absolute error."""
        e = measures(got, want)
        log(f"  {label}: recon {e['recon']:.3e} (tol {tol['recon']:.0e}), "
            f"sigma {e['sigma']:.3e} (tol {tol['sigma']:.0e}), max abs {e['abs']:.3e}")
        for k in ("recon", "sigma"):
            require(np.isfinite(e[k]) and e[k] <= tol[k], f"{label}: {k} error {e[k]} above {tol[k]}")
        return e["abs"]

    def planted_faults(label, got, want, v_in, tol):
        """The check must reject the kernel's output with V left unrotated and
        with the sign of U's column of the largest and of the smallest
        singular value flipped (in the first update of the batch)."""
        faults = [("V unrotated", (got[0], got[1], v_in), True)]
        for which, j in (("largest", int(got[1][0].float().abs().argmax())),
                         ("smallest", int(got[1][0].float().abs().argmin()))):
            flip = got[0].clone()
            flip[0, :, j] = -flip[0, :, j]
            faults.append((f"sign of the {which} triplet flipped", (flip, got[1], got[2]),
                           which == "largest" or tol.get("smallest_sign", True)))
        for what, fault, required in faults:
            e = measures(fault, want)
            log(f"    planted fault, {what}: recon {e['recon']:.3e} (tol {tol['recon']:.0e})"
                + ("" if required else ", not required"))
            if required:
                require(e["recon"] > tol["recon"], f"{label}: the check passes a planted fault ({what})")

    def sensitivity(body, args):
        """The route's own float32 sensitivity: the plain body on inputs
        perturbed by one float32 rounding against the plain body, the
        largest over four perturbations."""
        want = body(*args)
        worst = {"recon": 0.0, "sigma": 0.0}
        for seed in range(1, 5):
            g = torch.Generator(dev).manual_seed(seed)
            pert = [x * (1 + 2.0 ** -23 * torch.randn(x.shape, generator=g, device=dev, dtype=x.dtype))
                    for x in args]
            e = measures(body(*pert), want)
            worst = {k: max(worst[k], e[k]) for k in worst}
        log(f"    the route's own sensitivity (plain, inputs perturbed by one rounding, worst of 4): "
            f"recon {worst['recon']:.3e}, sigma {worst['sigma']:.3e}")

    # -- phase 2: kernels against their plain versions --------------------------
    log("kernels vs plain:")
    errs = {}
    cases = {}
    for dtype in (torch.float64, torch.float32):
        args = cauchy_inputs(16, 192, 192, 192, dtype)
        got = CM.cauchy_matmul_cuda(*args)
        want = CM.cauchy_matmul_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(f"C cauchy_matmul B16 R=N=M=192 {name_of(dtype)}, relative to max |out|",
              err / float(want.abs().max()), CAUCHY_TOL[name_of(dtype)])
        errs[("C", name_of(dtype))] = err
        cases[("C", name_of(dtype))] = ("B16 R=N=M=192", args)

    for bsz, m, n, dtype in ((128, 32, 48, torch.float64), (32, 256, 320, torch.float32),
                             (128, 32, 48, torch.bfloat16)):
        args = full_inputs(bsz, m, n, dtype)
        got = FU.fused_update_cuda(*args)
        want = FU._fused_body(*args)
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(x.float()).all()) for x in got),
                f"A {name_of(dtype)}: non-finite output")
        label = f"A fused_update B{bsz} ({m},{n}) {name_of(dtype)}"
        tol = TOL[("A", name_of(dtype))]
        errs[("A", name_of(dtype), m)] = check_pair(label, got, want, tol)
        if dtype == torch.float32:
            sensitivity(FU._fused_body, args)
        planted_faults(label, got, want, args[2], tol)
        cases[("A", name_of(dtype), m)] = (f"B{bsz} ({m},{n})", args)

    # bf16 storage against the reference's budget, on the reference's own test
    # problems, against an f64 SVD of A + a b^T: singular values by the
    # budget's measure (max_i |s_i - s_ref_i| / s_ref_0); the reconstruction
    # budget (||U S V^T - T||_F / ||T||_F) is reported, because the
    # reference's own fused body misses it on part of these problems
    # (tools/port_vs_reference.py)
    args = full_inputs(128, 32, 48, torch.bfloat16, dist="uniform")
    got, want = FU.fused_update_cuda(*args), FU._fused_body(*args)
    a64 = [x.double() for x in args]
    dense = recon(*a64[:3]) + a64[3][:, :, None] * a64[4][:, None, :]
    s_ref = torch.linalg.svdvals(dense)
    sigma_rel = float(((got[1].double() - s_ref).abs().amax(1) / s_ref[:, 0]).max())
    check("A bf16 B128 (32,48) uniform: sigma_rel vs f64 SVD", sigma_rel,
          FU.BF16_ERROR_BUDGET["sigma_rel"])

    def recon_fro(out):
        return ((recon(*out[:3]) - dense).flatten(-2).norm(dim=-1)
                / dense.flatten(-2).norm(dim=-1))

    budget = FU.BF16_ERROR_BUDGET["recon_rel"]
    for side, out in (("kernel", got), ("plain", want)):
        rf = recon_fro(out)
        log(f"  A bf16 uniform {side}: recon_fro vs f64 median {float(rf.median()):.3e} max "
            f"{float(rf.max()):.3e}, over the {budget:.0e} budget on {int((rf > budget).sum())} of 128")

    for bsz, m, n, r in ((16, 512, 768, 16), (8, 1024, 4096, 32)):
        for dtype in (torch.float32, torch.float64):
            args = trunc_inputs(bsz, m, n, r, dtype)
            got = FU.fused_update_truncated_cuda(*args)
            want = FU._fused_truncated_body(*args)
            torch.cuda.synchronize()
            label = f"B fused_update_truncated B{bsz} m{m} n{n} r{r} {name_of(dtype)}"
            tol = TOL[("B", name_of(dtype))]
            errs[("B", name_of(dtype), m)] = check_pair(label, got, want, tol)
            if dtype == torch.float32:
                sensitivity(FU._fused_truncated_body, args)
            planted_faults(label, got, want, args[2], tol)
            cases[("B", name_of(dtype), m)] = (f"B{bsz} m{m} n{n} r{r}", args)

    # -- phase 3: the main path ---------------------------------------------------
    log("main path (api.update_many / api.update):")
    m, n, bsz = 128, 192, 4
    fp = full_inputs(bsz, m, n, torch.float64)
    full_probs = [(recon(*(x[i] for x in fp[:3])).cpu().numpy(), fp[3][i].cpu().numpy(),
                   fp[4][i].cpu().numpy()) for i in range(bsz)]
    r, true_rank = 16, 12
    tm, tn = 512, 768
    trunc_probs = []
    for _ in range(16):  # the service bench's flush size
        a_mat = rng.normal(size=(tm, true_rank)) @ rng.normal(size=(true_rank, tn))
        trunc_probs.append((a_mat, rng.normal(size=tm), rng.normal(size=tn)))

    def run_main_path():
        results = []
        for method in ("auto", "pallas"):
            pol = api.UpdatePolicy(method=method)
            for dtype in (torch.float64, torch.float32):
                states = [api.SvdState.from_dense(p[0], device=dev, dtype=dtype) for p in full_probs]
                outs = api.update_many(states, [p[1] for p in full_probs],
                                       [p[2] for p in full_probs], pol)
                results.append((f"full {method} {name_of(dtype)} B{bsz} ({m},{n})", outs,
                                full_probs, name_of(dtype), states, pol))
            states = [api.SvdState.from_dense(p[0], r, device=dev) for p in trunc_probs]
            outs = api.update_many(states, [p[1] for p in trunc_probs],
                                   [p[2] for p in trunc_probs], pol)
            results.append((f"truncated {method} float64 B{len(trunc_probs)} m{tm} n{tn} r{r} "
                            f"(rank {true_rank})", outs, trunc_probs, "float64", states, pol))
        state = api.SvdState.from_dense(full_probs[0][0], device=dev)
        single = api.update(state, full_probs[0][1], full_probs[0][2])
        results.append((f"single full auto float64 ({m},{n})", [single], full_probs[:1], "float64",
                        [state], api.UpdatePolicy()))
        return results

    _build.reset_launches()
    results = run_main_path()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"  launches on the main path: {launches}")
    for label, outs, probs, dt, states, pol in results:
        worst = 0.0
        for out, (a_mat, a, b) in zip(outs, probs):
            arrs = convert.state_to_arrays(out)
            require(all(np.isfinite(x).all() for x in arrs.values()), f"{label}: non-finite output")
            want = a_mat + np.outer(a, b)
            k = arrs["s"].shape[0]
            got = (arrs["u"] * arrs["s"]) @ arrs["v"][:, :k].T
            require(got.shape == want.shape, f"{label}: shape {got.shape} != {want.shape}")
            worst = max(worst, np.abs(got - want).max() / np.linalg.norm(want, 2))
        if dt == "float64":
            check(f"{label}: |U S V^T - (A + ab^T)| / sigma_max", worst, F64_RECON_LIMIT)
        else:
            log(f"  {label}: |U S V^T - (A + ab^T)| / sigma_max {worst:.3e} (the f32 route's own "
                f"error; held to the CPU below)")
        # the same states and pairs through the same route on the CPU
        cpu_states = [convert.state_from_arrays(**convert.state_to_arrays(st), device="cpu")
                      for st in states]
        want = api.update_many(cpu_states, [p[1] for p in probs], [p[2] for p in probs], pol)
        stack = lambda sts: [torch.stack([getattr(x, f).cpu() for x in sts])  # noqa: E731
                             for f in ("u", "s", "v")]
        check_pair(f"{label}: card vs CPU", stack(outs), stack(want), MAIN_TOL[dt])
    for kname in ("fused_update", "fused_update_truncated", "cauchy_matmul"):
        require(launches[kname] > 0, f"the main path never launched {kname}")

    # -- phase 4: times -------------------------------------------------------------
    log("times (median of CUDA events after warm-up):")

    def time_ms(fn, budget_ms=1500.0):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = (time.perf_counter() - t) * 1e3
        reps = int(min(30, max(3, budget_ms / max(once, 1e-3))))
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def phase_ops(k):
        # secular: k roots x k poles per sweep, 5 operations per pair in a
        # bisection sweep (2 subtractions, a division, a multiply-add) and 7 in
        # a Newton sweep; about 35 k^2 for merge, brackets, Loewner, norms,
        # rank and qt; 2 k^3 for hh @ qt
        return k * k * (N_BISECT * 5 + N_NEWTON * 7) + 35 * k * k + 2 * k ** 3

    def full_ops(m, n):
        kr = m + 2 if n - m > 2 else n
        k0 = n - m
        chain = lambda k: 2 * phase_ops(k) + 2 * k * k + 2 * k ** 3  # noqa: E731
        proj = 2 * (2 * n * n + 3 * m * m + n * m) + 2 * n * n
        comp = 2 * k0 ** 3 + 8 * k0 * k0 + 4 * n * k0 if kr != n else 0
        rot_v = 2 * n * kr * kr + 2 * n * (n - kr) * k0 if kr != n else 2 * n ** 3
        return proj + chain(m) + chain(kr) + comp + 6 * m * m + 2 * m ** 3 + rot_v

    def trunc_ops(m, n, r):
        k = r + 1
        return 4 * (m + n) * r + full_ops(k, k) + 2 * (m + n) * k * r

    def bound(nbytes, ops, dtype_name):
        peak = PEAK_OPS["float64" if dtype_name == "float64" else "float32"]
        t_b, t_o = nbytes / MEM_BYTES_PER_S, ops / peak
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    rows = []
    for key, (shape, args) in cases.items():
        kernel, dt = key[0], key[1]
        isz = args[0].element_size()
        if kernel == "C":
            bsz, rr, nn = args[0].shape
            mm = args[2].shape[1]
            nbytes = isz * (bsz * rr * nn + bsz * nn + 3 * bsz * mm + bsz * rr * mm)
            ops = bsz * (2 * rr * nn * mm + 3 * nn * mm)
            fn = lambda a=args: CM.cauchy_matmul_cuda(*a)  # noqa: E731
            plain = lambda a=args: CM.cauchy_matmul_plain(*a)  # noqa: E731
            lib = None
        elif kernel == "A":
            bsz, mm, _ = args[0].shape
            nn = args[2].shape[1]
            nbytes = isz * bsz * (2 * mm * mm + 2 * nn * nn + 4 * mm + 2 * nn)
            ops = bsz * full_ops(mm, nn)
            fn = lambda a=args: FU.fused_update_cuda(*a)  # noqa: E731
            plain = lambda a=args: FU._fused_body(*a)  # noqa: E731
            sdt = torch.float32 if args[0].dtype == torch.bfloat16 else args[0].dtype
            dense = (recon(*args[:3]) + args[3].double()[:, :, None] * args[4].double()[:, None, :]).to(sdt)
            lib = lambda d=dense: torch.linalg.svd(d, full_matrices=True)  # noqa: E731
        else:
            bsz, mm, rr = args[0].shape
            nn = args[2].shape[1]
            nbytes = isz * bsz * (2 * (mm + nn) * rr + 2 * rr + mm + nn)
            ops = bsz * trunc_ops(mm, nn, rr)
            fn = lambda a=args: FU.fused_update_truncated_cuda(*a)  # noqa: E731
            plain = lambda a=args: FU._fused_truncated_body(*a)  # noqa: E731
            dense = (recon(*args[:3]) + args[3].double()[:, :, None] * args[4].double()[:, None, :]).to(args[0].dtype)
            lib = lambda d=dense: torch.linalg.svd(d, full_matrices=False)  # noqa: E731
        b_ms, b_by = bound(nbytes, ops, dt)
        row = {"kernel": kernel, "dtype": dt, "shape": shape, "ms": time_ms(fn),
               "plain_ms": time_ms(plain), "library_ms": time_ms(lib) if lib else None,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops,
               "max_abs_err": errs[key]}
        rows.append(row)
        lib_txt = f"{row['library_ms']:.3f}" if lib else "none"
        log(f"  {kernel} {dt} {shape}: kernel {row['ms']:.3f} ms | plain {row['plain_ms']:.3f} ms "
            f"| torch.linalg.svd {lib_txt} ms | bound {b_ms:.4f} ms ({b_by})")
    log("timings " + json.dumps({"timings": rows, "card": card}))

    headline = {"C": ("float64",), "A": ("float64", 32), "B": ("float32", 512)}
    meta = {
        "C": ("cauchy_matmul", "src/repro_torch/csrc/cauchy_matmul.cu",
              "src/repro/kernels/cauchy_matmul.py:139", "cauchy_matmul"),
        "A": ("fused_update", "src/repro_torch/csrc/fused_update.cuh",
              "src/repro/kernels/fused_update.py:566", "fused_update"),
        "B": ("fused_update_truncated", "src/repro_torch/csrc/fused_update.cuh",
              "src/repro/kernels/fused_update.py:601", "fused_update_truncated"),
    }
    kernels = []
    for k, (name, source, replaces, counter) in meta.items():
        row = next(rw for key, rw in zip(cases, rows) if key == (k,) + headline[k])
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[counter], "max_abs_err": row["max_abs_err"],
                        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "shape": f"{row['dtype']} {row['shape']}"})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
