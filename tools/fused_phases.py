#!/usr/bin/env python3
"""Build and run the phase probe of kernels A and B (``tools/fused_phases.cu``).

On a machine with an H100 and nvcc, from the root of a checkout:

    python3 tools/fused_phases.py [--parent-src DIR] [--reps N]

It builds ``tools/fused_phases.cu`` against ``src/repro_torch/csrc`` (the
kernels as they are) and against the sources of commit e9a9ea2 (the
one-block-per-update kernels), with the probe's markers inserted into the
latter at the same phase boundaries (``PARENT_MARKS``).  The parent's sources
come from ``--parent-src`` (a directory holding ``fused_core.cuh`` and
``fused_update.cuh``), else from ``git archive e9a9ea2`` when the checkout has
its history, else from ``build/fused_phases/parent_src``.  Both builds run in
parallel into ``build/fused_phases/``.

Then, at the four headline shapes (A f64 B128 (32, 48); A f32 B32 (256, 320);
B f32 B16 m512 n768 r16; B f32 and f64 B8 m1024 n4096 r32) and at A f64 B4
(256, 320) (kernel A's vectors in device scratch), on inputs of
``chip_smoke.py``'s kind (orthonormal factors, singular values 100 .. 1
geometric, |a| |b| the median one) it runs each kernel once to warm up, then
``--reps`` launches, and prints block 0's cycles per phase (the mean over the
launches) in microseconds at the card's clock, beside the CUDA-event time of a
launch (and block 1's, where an update runs on more than one block).
"""

from __future__ import annotations

import argparse
import ctypes
import io
import shutil
import subprocess
import sys
import tarfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "fused_phases"
PARENT = "e9a9ea2"
PHASES = ("projections", "secular set-up", "secular iterate", "zhat/norms/rank",
          "phi rows, z2", "compression", "bv + sign fix", "rotations", "other", "G products",
          "team wait (phi)")

# (file, anchor, marker): the marker goes on a line of its own after the
# anchor (a line unique in the file), or before it when the marker ends in
# "<".  The same boundaries as the FUSED_MARK calls of the current sources.
PARENT_MARKS = [
    ("fused_update.cuh", "  Ctx<T> c = fused::make_ctx<T>(smem, scratch + i * per, kmax, rtol, nb, nn);",
     "FUSED_MARK_START();"),
    ("fused_update.cuh", "  T* vv = c.mat(fused::M_VV);", "FUSED_MARK_START();"),
    ("fused_update.cuh", "  rb = ok_b ? rb : T(0);", "FUSED_MARK(0);"),
    ("fused_update.cuh", "  fused::full_core<T, T, T>(k, k, eye, saug, eye, ak, bk, uu, ss, vv, (T*)nullptr,",
     "FUSED_MARK(8);<"),
    ("fused_update.cuh", "  for (int j = tid; j < r; j += nt) fused::st(so, j, ss[j]);", "FUSED_MARK(7);"),
    ("fused_core.cuh", "  zn2 = block_reduce(zn2, c.red, SumOp());  // also publishes keep / z2k",
     "FUSED_MARK(1);"),
    ("fused_core.cuh", "  // Loewner zhat (Gu-Eisenstat), log-magnitude space, anchored differences",
     "FUSED_MARK(2);<"),
    ("fused_core.cuh", "  // qt[j, i]: eigenvector columns; deflated columns pass through", "FUSED_MARK(3);<"),
    ("fused_core.cuh", "  for (int i = tid; i < k; i += nt) mu_sorted[rank[i]] = mu[i];", "FUSED_MARK(4);"),
    ("fused_core.cuh", "  matmul<T>(k, 1, k, phi1, 1, k, z2w, 1, 0, z2, 1, 0);  // z2 = phi1^T z2w",
     "FUSED_MARK(4);"),
    ("fused_core.cuh", "  phase(k, dneg, zneg, -rho_neg, mub, phib, c);", "FUSED_MARK(8);<"),
    ("fused_core.cuh", "  matmul<T>(k, k, k, phi1, k, 1, phib + (long)(k - 1) * k + (k - 1), -k, -1, G, k, 1);",
     "FUSED_MARK(9);"),
    ("fused_core.cuh", "  matmul<T>(n, 1, n, v, 1, n, b2, 1, 0, vb2, 1, 0);", "FUSED_MARK(0);"),
    ("fused_core.cuh", "  // STEPS 6-7 (right)", "FUSED_MARK(8);<"),
    ("fused_core.cuh", "    // chain on the m + 2 active coordinates: two compressed zero poles lead",
     "FUSED_MARK(5);<"),
    ("fused_core.cuh", "    chain(kr, d0, z1, z2w, rho3, rho4, dasc, gv, c);", "FUSED_MARK(8);"),
    ("fused_core.cuh", "    chain(n, d0, z1, z2w, rho3, rho4, dasc, gasc, c);", "FUSED_MARK(8);"),
    ("fused_core.cuh", "  // outputs", "FUSED_MARK(6);<"),
    ("fused_core.cuh", "}  // namespace fused", "FUSED_MARK_END<"),
]


def _parent_sources(arg: str | None) -> Path:
    dst = OUT / "parent_src"
    if arg:
        return Path(arg)
    if (ROOT / ".git").exists() and shutil.which("git"):
        blob = subprocess.run(["git", "-C", str(ROOT), "archive", PARENT, "src/repro_torch/csrc"],
                              check=True, capture_output=True).stdout
        shutil.rmtree(dst, ignore_errors=True)
        dst.mkdir(parents=True)
        with tarfile.open(fileobj=io.BytesIO(blob)) as tf:
            for m in tf.getmembers():
                if m.isfile():
                    (dst / Path(m.name).name).write_bytes(tf.extractfile(m).read())
    if not (dst / "fused_core.cuh").exists():
        raise SystemExit(f"no parent sources: pass --parent-src or run `git archive {PARENT} "
                         f"src/repro_torch/csrc | tar -x --strip-components=3 -C {dst}` first")
    return dst


def _mark_parent(src: Path) -> Path:
    """A copy of the parent's two headers with the probe's markers in place."""
    dst = OUT / "parent_marked"
    dst.mkdir(parents=True, exist_ok=True)
    for name in ("fused_core.cuh", "fused_update.cuh"):
        lines = (src / name).read_text().split("\n")
        for fname, anchor, mark in PARENT_MARKS:
            if fname != name:
                continue
            hits = [i for i, ln in enumerate(lines) if ln == anchor]
            if len(hits) != 1:
                raise SystemExit(f"{name}: anchor found {len(hits)} times: {anchor!r}")
            i = hits[0]
            if mark == "FUSED_MARK_END<":
                # the end of full_core: its closing brace is the last "}" before the anchor
                j = max(k for k in range(i) if lines[k] == "}")
                lines.insert(j, "  FUSED_MARK(7);")
            elif mark.endswith("<"):
                lines.insert(i, "  " + mark[:-1])
            else:
                lines.insert(i + 1, "  " + mark)
        (dst / name).write_text("\n".join(lines))
    return dst


def _build(include_dirs: dict[str, Path]) -> dict[str, Path]:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for tag, inc in include_dirs.items():
        out = OUT / tag / "libfused_phases.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-DFUSED_PHASES", "-I", str(inc), "-o", str(out),
               str(ROOT / "tools" / "fused_phases.cu")]
        procs[tag] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for tag, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {tag}:\n{log}")
        libs[tag] = out
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-src")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", choices=("parent", "new"), help="build and run one of the two")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_phases: no CUDA card", file=sys.stderr)
        return 2
    builds = {}
    if args.only != "new":
        builds["parent"] = _mark_parent(_parent_sources(args.parent_src))
    if args.only != "parent":
        builds["new"] = CSRC
    libs = _build(builds)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    P, I, D, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong

    def orth(bsz, rows, cols):
        return np.linalg.qr(rng.normal(size=(bsz, rows, cols)))[0]

    def pair(bsz, m, n, s):
        a, b = rng.normal(size=(bsz, m)), rng.normal(size=(bsz, n))
        b *= (np.median(s, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)))[:, None]
        return a, b

    cases = []
    for kind, bsz, m, n, r, dt in (("A", 128, 32, 48, None, torch.float64),
                                   ("A", 32, 256, 320, None, torch.float32),
                                   ("A", 4, 256, 320, None, torch.float64),
                                   ("B", 16, 512, 768, 16, torch.float32),
                                   ("B", 8, 1024, 4096, 32, torch.float32),
                                   ("B", 8, 1024, 4096, 32, torch.float64)):
        k = m if r is None else r
        s = np.tile(np.geomspace(100.0, 1.0, k), (bsz, 1))
        a, b = pair(bsz, m, n, s)
        u = orth(bsz, m, k)
        v = orth(bsz, n, n if r is None else r)
        cases.append((kind, bsz, m, n, r, dt,
                      [torch.as_tensor(x, device=dev).to(dt).contiguous() for x in (u, s, v, a, b)]))

    results = {}
    for tag, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.fused_phases_read.argtypes = [P, P]
        lib.fused_phases_clock_khz.restype = I
        khz = lib.fused_phases_clock_khz()
        for sfx in ("f32", "f64"):
            getattr(lib, f"fused_update_{sfx}").argtypes = [P] * 11 + [I] * 3 + [D] + [I] * 3 + [P]
            getattr(lib, f"fused_update_truncated_{sfx}").argtypes = \
                [P] * 9 + [I] * 4 + [D] + [I] * 2 + [P]
        lib.probe_scratch.argtypes = [I] * 6 + [P]
        lib.probe_scratch.restype = LL
        for kind, bsz, m, n, r, dt, ins in cases:
            sfx = "f64" if dt == torch.float64 else "f32"
            rtol = 64.0 * torch.finfo(dt).eps
            csz = ctypes.c_longlong(0)
            ptr = lambda *ts: [ctypes.c_void_p(t.data_ptr()) for t in ts]  # noqa: E731
            if kind == "A":
                elems = lib.probe_scratch(0, dt == torch.float64, bsz, m, n, 0, ctypes.byref(csz))
                scratch = torch.empty(max(int(elems), 1), dtype=dt, device=dev)
                outs = [torch.empty_like(ins[0]), torch.empty_like(ins[1]), torch.empty_like(ins[2]),
                        torch.empty_like(ins[1]), torch.empty_like(ins[4])]
                fn = getattr(lib, f"fused_update_{sfx}")
                call = lambda: fn(*ptr(*ins, *outs, scratch), bsz, m, n,  # noqa: E731
                                  ctypes.c_double(rtol), 16, 6, 1, None)
            else:
                elems = lib.probe_scratch(1, dt == torch.float64, bsz, m, n, r, ctypes.byref(csz))
                scratch = torch.empty(max(int(elems), 1), dtype=dt, device=dev)
                outs = [torch.empty_like(ins[0]), torch.empty_like(ins[1]), torch.empty_like(ins[2])]
                fn = getattr(lib, f"fused_update_truncated_{sfx}")
                call = lambda: fn(*ptr(*ins, *outs, scratch), bsz, m, n, r,  # noqa: E731
                                  ctypes.c_double(rtol), 16, 6, None)
            err = call()
            acc = (ctypes.c_ulonglong * 32)()
            cnt = (ctypes.c_uint * 32)()
            lib.fused_phases_read(acc, cnt)
            if err:
                raise SystemExit(f"{tag} {kind} launch error {err}")
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(args.reps):
                call()
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / args.reps
            lib.fused_phases_read(acc, cnt)
            us = [acc[i] / args.reps / khz * 1e3 for i in range(len(PHASES))]
            us1 = [acc[16 + i] / args.reps / khz * 1e3 for i in range(len(PHASES))]
            label = (f"{kind} {sfx} B{bsz} ({m},{n})" if r is None else
                     f"{kind} {sfx} B{bsz} m{m} n{n} r{r}")
            results[(label, tag)] = (ms, us, csz.value, us1)
    print(f"block 0's microseconds per phase at {khz / 1e3:.0f} MHz (mean of {args.reps} launches), "
          "and the CUDA-event ms of a launch")
    labels = list(dict.fromkeys(k[0] for k in results))
    for label in labels:
        print(f"\n{label}")
        print(f"  {'phase':<18}" + "".join(f"{tag:>14}" for tag in libs))
        for i, ph in enumerate(PHASES):
            print(f"  {ph:<18}" + "".join(f"{results[(label, tag)][1][i]:>11.1f} us" for tag in libs))
        print(f"  {'sum of phases':<18}"
              + "".join(f"{sum(results[(label, tag)][1]):>11.1f} us" for tag in libs))
        print(f"  {'launch (events)':<18}"
              + "".join(f"{results[(label, tag)][0] * 1e3:>11.1f} us" for tag in libs))
        print(f"  {'blocks an update':<18}" + "".join(f"{results[(label, tag)][2]:>14}" for tag in libs))
        for tag in libs:
            ms, _, csz, us1 = results[(label, tag)]
            if csz > 1:
                print(f"  {tag}, update 0's block 1: "
                      + ", ".join(f"{ph} {x:.1f}" for ph, x in zip(PHASES, us1) if x) + " us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
