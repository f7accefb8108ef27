#!/usr/bin/env python3
"""Time kernel A with each lane-group size for the secular sweeps of large k.

On a machine with an H100 and nvcc, from the root of a checkout:

    python3 tools/fused_lanes.py [--reps N]

``csrc/fused_core.cuh`` gives every secular root of k >= KBIG poles a group of
GBIG lanes (below KBIG a model of the sweep picks the size).  This script
builds ``tools/fused_phases.cu`` against the kernels as they are and against
copies of their sources with GBIG set to 1, 2, 4, 16 and 32 (all builds in
parallel, into ``build/fused_lanes/``), then times kernel A (CUDA events, the
best of three runs of ``--reps`` back-to-back launches) at shapes of k from
100 to 320, at one to eight blocks an update, in f32 and f64, on inputs of
``chip_smoke.py``'s kind, and prints the milliseconds of each build.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import fused_phases as FP  # noqa: E402

OUT = ROOT / "build" / "fused_lanes"
CASES = ((32, 256, 320, "f32"), (1, 256, 320, "f32"), (4, 256, 320, "f64"),
         (16, 100, 150, "f64"), (2, 130, 200, "f64"), (128, 100, 150, "f64"))


def _variants() -> dict[str, Path]:
    src = (FP.CSRC / "fused_core.cuh").read_text()
    cur = re.search(r"constexpr int KBIG = (\d+), GBIG = (\d+);", src)
    if cur is None:
        raise SystemExit("fused_core.cuh: no KBIG / GBIG line")
    dirs = {f"g={cur.group(2)}_as_is": FP.CSRC}
    for g in (1, 2, 4, 16, 32):
        if g == int(cur.group(2)):
            continue
        d = OUT / f"src_g{g}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(FP.CSRC, d)
        (d / "fused_core.cuh").write_text(
            src.replace(cur.group(0), f"constexpr int KBIG = {cur.group(1)}, GBIG = {g};"))
        dirs[f"g={g}"] = d
    return dirs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_lanes: no CUDA card", file=sys.stderr)
        return 2
    FP.OUT = OUT
    dirs = _variants()
    libs = FP._build(dirs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    P, I, D, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
    inputs = []
    for bsz, m, n, sfx in CASES:
        dt = torch.float64 if sfx == "f64" else torch.float32
        s = np.tile(np.geomspace(100.0, 1.0, m), (bsz, 1))
        a, b = rng.normal(size=(bsz, m)), rng.normal(size=(bsz, n))
        b *= (np.median(s, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)))[:, None]
        u = np.linalg.qr(rng.normal(size=(bsz, m, m)))[0]
        v = np.linalg.qr(rng.normal(size=(bsz, n, n)))[0]
        inputs.append([torch.as_tensor(x, device=dev).to(dt).contiguous() for x in (u, s, v, a, b)])
    ms = {}
    for tag, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for sfx in ("f32", "f64"):
            getattr(lib, f"fused_update_{sfx}").argtypes = [P] * 11 + [I] * 3 + [D] + [I] * 3 + [P]
        lib.probe_scratch.argtypes = [I] * 6 + [P]
        lib.probe_scratch.restype = LL
        lib.fused_phases_read.argtypes = [P, P]
        for (bsz, m, n, sfx), ins in zip(CASES, inputs):
            dt = ins[0].dtype
            csz = ctypes.c_longlong(0)
            elems = lib.probe_scratch(0, sfx == "f64", bsz, m, n, 0, ctypes.byref(csz))
            scratch = torch.empty(max(int(elems), 1), dtype=dt, device=dev)
            outs = [torch.empty_like(ins[i]) for i in (0, 1, 2, 1, 4)]
            fn = getattr(lib, f"fused_update_{sfx}")
            ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (*ins, *outs, scratch)]
            rtol = ctypes.c_double(64.0 * torch.finfo(dt).eps)
            call = lambda: fn(*ptrs, bsz, m, n, rtol, 16, 6, 1, None)  # noqa: E731
            if call():
                raise SystemExit(f"{tag}: launch error")
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(3):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(args.reps):
                    call()
                e1.record()
                torch.cuda.synchronize()
                best = min(best, e0.elapsed_time(e1) / args.reps)
            lib.fused_phases_read((ctypes.c_ulonglong * 32)(), (ctypes.c_uint * 32)())
            ms[(tag, bsz, m, n, sfx)] = (best, csz.value)
    print("kernel A, ms a launch (best of 3 x", args.reps, "launches), by lane-group size for k >= KBIG")
    for bsz, m, n, sfx in CASES:
        row = {tag: ms[(tag, bsz, m, n, sfx)] for tag in libs}
        fastest = min(x[0] for x in row.values())
        print(f"  A {sfx} B{bsz} ({m},{n}), {next(iter(row.values()))[1]} blocks an update: "
              + "  ".join(f"{tag} {x[0]:.3f}{' *' if x[0] == fastest else ''}" for tag, x in row.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
