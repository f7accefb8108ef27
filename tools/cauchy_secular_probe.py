#!/usr/bin/env python3
"""Time kernels C (Cauchy product) and D (secular solve) beside their first
designs, on one card.

On a machine with an H100 and nvcc, from the root of a checkout:

    python3 tools/cauchy_secular_probe.py [--parent-src DIR] [--reps N] [--sweep] [--sass DIR]

It builds ``src/repro_torch/csrc/cauchy_matmul.cu`` and ``secular_newton.cu``
as they are (the package's own build, ``kernels/_build.py``) and as they were
at commit 9aeb9ce (their first designs) with the same nvcc
flags into ``build/cs_probe/parent/``.  The parent's sources come from
``--parent-src`` (a directory holding the two files), else from ``git archive
9aeb9ce`` when the checkout has its history, else from
``build/cs_probe/parent_src`` (run the script once on a machine with the
history, or ``git archive 9aeb9ce src/repro_torch/csrc/cauchy_matmul.cu
src/repro_torch/csrc/secular_newton.cu | tar -x --strip-components=3 -C
build/cs_probe/parent_src``).

Both builds run through the package's own wrappers (``cauchy_matmul_cuda``,
``secular_solve_cuda``): for the parent the wrapper's library is swapped for
the parent's, so the host path is the same.  At each shape, on inputs of
``chip_smoke.py``'s kind, it prints for each build, in turns (parent, new,
new, parent), the median CUDA-event ms of a call after warm-up, the device ms
from ``torch.profiler`` and the host ms to enqueue a call, and each build's
largest error against the plain version.

C: f64 and f32 at B16 R = N = M = 192 (the headline) and at the three shapes
``method="pallas"`` gives it on the main path: (4, 128, 128, 128) and (4,
192, 192, 192) of a full update at (128, 192) B4, (16, 17, 17, 17) of a
truncated update at r 16 B16.  D: f64 and f32 at B8 N = M = 1024 on real and
random brackets, at 58 + 4 steps (the default) and 16 + 6 (the fused
route's).

With ``--sweep`` it also times kernel C on every plan (16, 32 or 48 targets a
panel; 1, 2, 4 or 8 blocks a panel) at each C shape, beside the plan the
kernel takes (``cauchy_plan``), by device time.  With ``--sass DIR`` it also
writes ``cuobjdump -sass`` of both builds of kernel D into DIR and prints,
per kernel function, the count of each floating-point instruction.
"""

from __future__ import annotations

import argparse
import ctypes
import io
import re
import shutil
import statistics
import subprocess
import sys
import tarfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "cs_probe"
PARENT = "9aeb9ce"
FILES = ("cauchy_matmul", "secular_newton")


def _parent_sources(arg: str | None) -> Path:
    dst = OUT / "parent_src"
    if arg:
        return Path(arg)
    if (ROOT / ".git").exists() and shutil.which("git"):
        blob = subprocess.run(["git", "-C", str(ROOT), "archive", PARENT]
                              + [f"src/repro_torch/csrc/{f}.cu" for f in FILES],
                              check=True, capture_output=True).stdout
        shutil.rmtree(dst, ignore_errors=True)
        dst.mkdir(parents=True)
        with tarfile.open(fileobj=io.BytesIO(blob)) as tf:
            for m in tf.getmembers():
                if m.isfile():
                    (dst / Path(m.name).name).write_bytes(tf.extractfile(m).read())
    if not all((dst / f"{f}.cu").exists() for f in FILES):
        raise SystemExit(f"no parent sources in {dst}: pass --parent-src, or see the head note")
    return dst


def _build_parent(src: Path, flags) -> dict[str, Path]:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = OUT / "parent"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in FILES:
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen([nvcc, *flags, "-o", str(lib), str(src / f"{name}.cu")],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the parent's {name}.cu:\n{log}")
        libs[name] = lib
    return libs


def _sass_counts(lib: Path, dst: Path, tag: str) -> None:
    """Write the SASS of ``lib`` to ``dst`` and print, per kernel function,
    how many of each floating-point instruction it holds."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    dst.mkdir(parents=True, exist_ok=True)
    (dst / f"{tag}_{lib.stem}.sass").write_text(sass)
    fn, counts = None, {}
    for line in sass.splitlines():
        head = re.match(r"\s+Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = Counter()
            continue
        op = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and op:
            base = op.group(1).split(".")[0]
            if base[0] in "DFHM" or base in ("BRA", "SHFL", "LDS", "BAR", "BSSY", "BSYNC", "CALL"):
                counts[fn][op.group(1) if base == "MUFU" else base] += 1
    for fn, c in counts.items():
        keep = {k: v for k, v in sorted(c.items()) if k[0] in "DFM" or k in ("BRA", "SHFL", "LDS", "CALL")}
        print(f"  {tag} {fn}: {keep}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-src")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", help="directory for the SASS of kernel D's builds")
    ap.add_argument("--sweep", action="store_true", help="time kernel C on every plan")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cauchy_secular_probe: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import secular as SEC
    from repro_torch.kernels import _build
    from repro_torch.kernels import cauchy_matmul as CM
    from repro_torch.kernels import secular_newton as SN

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs = {"parent": {}}
    for name, path in _build_parent(_parent_sources(args.parent_src), _build.NVCC_FLAGS).items():
        lib = ctypes.CDLL(str(path))
        for fn_name, (argtypes, restype) in _build._SIGNATURES[name].items():
            if hasattr(lib, fn_name):
                getattr(lib, fn_name).argtypes = argtypes
                getattr(lib, fn_name).restype = restype
        libs["parent"][name] = lib
    libs["new"] = {name: _build.library(name) for name in FILES}
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name in FILES:
        log = (_build.build_all() / f"{name}.log").read_text().splitlines()
        print(f"  {name}: " + " | ".join(ln.strip() for ln in log
                                         if "Compiling entry" in ln or "registers" in ln
                                         or "spill" in ln))
    if args.sass:
        for tag in libs:
            path = (OUT / "parent" if tag == "parent" else _build.build_all()) / "libsecular_newton.so"
            _sass_counts(path, Path(args.sass), tag)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    def tt(x, dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype).contiguous()

    def cauchy_inputs(rng, bsz, r, n, m, dtype):
        src = np.sort(rng.normal(size=(bsz, n)), axis=1)
        av = np.take_along_axis(src, rng.integers(0, n, size=(bsz, m)), axis=1)
        tau = rng.normal(size=(bsz, m)) * 1e-3
        tau[:, 0] = 0.0
        return [tt(rng.normal(size=(bsz, r, n)), dtype), tt(src, dtype), tt(av, dtype),
                tt(tau, dtype), tt(rng.random((bsz, m)) > 0.2, dtype)]

    def secular_inputs(brackets, dtype):
        g = np.random.default_rng(21 if brackets == "real" else 22)
        bsz, nn = 8, 1024
        if brackets == "random":
            return [tt(x, dtype) for x in (
                np.sort(g.uniform(0, 5, (bsz, nn)), axis=1), g.uniform(0.01, 1, (bsz, nn)),
                np.full(bsz, 0.7), np.sort(g.uniform(0, 5, (bsz, nn)), axis=1),
                np.zeros((bsz, nn)), g.uniform(0.01, 0.5, (bsz, nn)))]
        d = np.sort(g.uniform(1, 9, (bsz, nn)) ** 2, axis=1)
        z = g.normal(size=(bsz, nn))
        z[:, ::9] *= 1e-5
        rho = g.uniform(0.5, 2.0, bsz)
        br = SEC.secular_brackets(tt(d, dtype), tt(z, dtype), tt(rho, dtype),
                                  torch.full((bsz,), nn, device=dev))
        return [tt(d, dtype), br.zc2, tt(rho, dtype), br.anchor_vals, br.lo, br.hi]

    def events_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def device_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return sum(ev.device_time_total for ev in prof.key_averages()) / n / 1e3

    def host_ms(fn, n=50):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        out = (time.perf_counter() - t) / n * 1e3
        torch.cuda.synchronize()
        return out

    def with_lib(tag, name, fn):
        """``fn`` run with the wrapper's library ``name`` taken from build ``tag``."""
        saved = _build._libs.get(name)
        _build._libs[name] = libs[tag][name]
        try:
            return fn()
        finally:
            if saved is None:
                _build._libs.pop(name, None)
            else:
                _build._libs[name] = saved

    if args.sweep:
        rng = np.random.default_rng(0)
        print("kernel C on every plan (device ms of a call, profiler; * the plan the kernel takes):")
        for shape in ((16, 192, 192, 192), (4, 128, 128, 128), (4, 192, 192, 192), (16, 17, 17, 17)):
            for dtype in (torch.float64, torch.float32):
                a = cauchy_inputs(rng, *shape, dtype)
                base = CM.cauchy_matmul_cuda(*a)
                chosen = CM.cauchy_plan(*shape, dtype)
                cols = []
                for targets in (16, 32, 48):
                    for cluster in (1, 2, 4, 8):
                        fn = lambda a=a, t_=targets, c_=cluster: CM.cauchy_matmul_cuda_planned(
                            *a, targets=t_, cluster=c_)
                        same = torch.equal(fn(), base)
                        mark = "*" if chosen == {"targets": targets, "cluster": cluster} else ""
                        cols.append(f"{targets}/{cluster}{mark} {device_ms(fn, n=10):.4f}"
                                    + ("" if same else " BITS DIFFER"))
                print(f"  C {str(dtype)[6:]} B{shape[0]} k={shape[1]}: " + ", ".join(cols),
                      flush=True)

    cases = []
    rng = np.random.default_rng(0)
    for shape in ((16, 192, 192, 192), (4, 128, 128, 128), (4, 192, 192, 192), (16, 17, 17, 17)):
        for dtype in (torch.float64, torch.float32):
            a = cauchy_inputs(rng, *shape, dtype)
            label = f"C {str(dtype)[6:]} B{shape[0]} R=N=M={shape[1]}"
            cases.append((label, "cauchy_matmul", lambda a=a: CM.cauchy_matmul_cuda(*a),
                          lambda a=a: CM.cauchy_matmul_plain(*a), None))
    for dtype in (torch.float64, torch.float32):
        for brackets in ("real", "random"):
            a = secular_inputs(brackets, dtype)
            width = float((a[5] - a[4]).abs().max())
            for nb, nn in ((58, 4), (16, 6)):
                label = f"D {str(dtype)[6:]} B8 N=M=1024 {brackets} {nb}+{nn}"
                cases.append((label, "secular_newton",
                              lambda a=a, nb=nb, nn=nn: SN.secular_solve_cuda(*a, n_bisect=nb, n_newton=nn),
                              lambda a=a, nb=nb, nn=nn: SN.secular_solve_plain(*a, n_bisect=nb, n_newton=nn),
                              width))

    tags = list(libs)
    order = ["parent", "new", "new", "parent"]
    print("ms: events (median of a call) / device (profiler) / host (enqueue); err: max |kernel - "
          "plain| (C: over max |out|; D: over the widest bracket)")
    for label, name, fn, plain, width in cases:
        want = plain()
        got = {}
        res = {tag: [] for tag in tags}
        for tag in order:
            out = with_lib(tag, name, fn)
            torch.cuda.synchronize()
            scale = width if width is not None else float(want.abs().max())
            got[tag] = float((out - want).abs().max()) / scale
            res[tag].append((with_lib(tag, name, lambda: events_ms(fn)),
                             with_lib(tag, name, lambda: device_ms(fn)),
                             with_lib(tag, name, lambda: host_ms(fn))))
        cols = []
        for tag in tags:
            ev = statistics.mean(r[0] for r in res[tag])
            dv = statistics.mean(r[1] for r in res[tag])
            ho = statistics.mean(r[2] for r in res[tag])
            cols.append(f"{tag} {ev:.4f} / {dv:.4f} / {ho:.4f} ms err {got[tag]:.2e}")
        print(f"{label:<36} " + " | ".join(cols), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
