"""Roofline report: the dry-run's JSONs -> markdown tables, in PyTorch.

Counterpart of ``repro.launch.report``, over the JSONs ``launch.dryrun``
writes (``build/repro_torch/dryrun/`` by default).  The terms are counts
against the H100's data-sheet peaks (``launch.roofline``), not measurements;
the peak column reads "-" where the dry-run has no peak (the meta device has
no memory tracker).

  PYTHONPATH=src python -m repro_torch.launch.report [--dir DIR] [--mesh 16x16]
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.launch.dryrun import OUT_DIR

__all__ = ["fmt_row", "load", "markdown_table"]


def load(d: str | Path):
    return [json.loads(f.read_text()) for f in sorted(Path(d).glob("*.json"))]


def fmt_row(r):
    rt = r["roofline"]
    tc, tm, tl = rt["t_compute_s"], rt["t_memory_s"], rt["t_collective_s"]
    dom = max(("compute", tc), ("memory", tm), ("collective", tl), key=lambda kv: kv[1])
    peak = r["memory"].get("peak_bytes")
    return {
        "arch": r["arch"],
        "shape": r["shape"],
        "mesh": r["mesh"],
        "method": r.get("method", "baseline"),
        "t_compute_ms": tc * 1e3,
        "t_memory_ms": tm * 1e3,
        "t_collective_ms": tl * 1e3,
        "bottleneck": dom[0],
        "useful_ratio": r.get("useful_flops_ratio"),
        "peak_gb": None if peak is None else peak / 1e9,
        "flops": rt["flops_per_device"],
        "bytes": rt["bytes_per_device"],
        "coll_bytes": rt["collective_bytes_per_device"],
    }


def markdown_table(rows, *, mesh=None, method="baseline"):
    out = [
        "| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) | bottleneck | useful FLOPs | "
        "peak GB/dev |",
        "|---|---|---:|---:|---:|---|---:|---:|",
    ]
    for r in rows:
        fr = fmt_row(r)
        if mesh and fr["mesh"] != mesh:
            continue
        if method and fr["method"] != method:
            continue
        ur = f"{fr['useful_ratio']:.2f}" if fr["useful_ratio"] else "-"
        peak = "-" if fr["peak_gb"] is None else f"{fr['peak_gb']:.1f}"
        out.append(
            f"| {fr['arch']} | {fr['shape']} | {fr['t_compute_ms']:.2f} | "
            f"{fr['t_memory_ms']:.1f} | {fr['t_collective_ms']:.1f} | "
            f"{fr['bottleneck']} | {ur} | {peak} |"
        )
    return "\n".join(out)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="markdown tables of the dry-run's JSONs")
    ap.add_argument("--dir", default=str(OUT_DIR))
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--method", default="baseline")
    args = ap.parse_args(argv)
    print(markdown_table(load(args.dir), mesh=args.mesh, method=args.method))


if __name__ == "__main__":
    main()
