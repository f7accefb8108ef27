"""Hill-climb driver: hypothesis -> change -> re-count -> record, in PyTorch.

Counterpart of ``repro.launch.perf_iter``.  Three LM cells, each with the
variants the reference tried (``VARIANTS``), counted by the port's dry-run
on the meta device (``launch.dryrun.run_cell``; a method tag a variant):

  A. qwen2-72b            x train_4k    (the largest dense model)
  B. deepseek-v2-lite-16b x prefill_32k (MoE + MLA)
  C. qwen1.5-32b          x decode_32k  (MHA: the cache does not split over model)

``--svd`` counts the other hot path, batched truncated rank-1 SVD updates,
through the engine a policy resolves (``api.update.engine_from_key(
UpdatePolicy(method="direct"), r + 1)``): one truncated batched flush for
each ``SVD_CELLS`` entry and a rank-k flush of k pairs a stream for each
``FLEET_CELLS`` entry (the round a backlogged fleet shard seals), run on the
card by default (``device="cpu"`` on the CPU), counted as the dry-run counts
(products and op bytes) and timed, with ``roofline.svd_update_flops`` as the
useful work.  JSONs go to ``build/repro_torch/dryrun/`` unless ``--out``
says otherwise.

  PYTHONPATH=src python -m repro_torch.launch.perf_iter [--cell ARCH:SHAPE]
  PYTHONPATH=src python -m repro_torch.launch.perf_iter --svd [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch.dryrun import OUT_DIR, count_ops, run_cell
from repro_torch.launch.roofline import HW, roofline_terms, svd_update_flops

__all__ = ["FLEET_CELLS", "SVD_CELLS", "VARIANTS", "run_svd_cell", "run_svd_cells"]

VARIANTS = {
    # ---- cell A: qwen2-72b train_4k
    ("qwen2-72b", "train_4k"): [
        # H1: remat recompute adds a forward; saving matmul outputs removes it
        ("remat-dots", lambda c: c.replace(remat_policy="dots"), {}),
        # H2: the (s x s) scores dominate the bytes at seq 4k; blockwise
        # attention keeps them out of HBM
        ("flash1k", lambda c: c.replace(attn_block_k=1024), {}),
        # H3: both
        ("flash1k+dots", lambda c: c.replace(attn_block_k=1024, remat_policy="dots"), {}),
        # H8: no remat at all (the recompute forward goes)
        ("no-remat", lambda c: c.replace(remat=False), {}),
        # H9: gather bf16 weights at use (ZeRO-3) instead of reducing partial
        # products over the FSDP-sharded contraction axis
        ("zero3-gather", lambda c: c.replace(fsdp_gather_params=True), {}),
        ("zero3+no-remat", lambda c: c.replace(fsdp_gather_params=True, remat=False), {}),
    ],
    # ---- cell B: deepseek-v2-lite prefill_32k
    ("deepseek-v2-lite-16b", "prefill_32k"): [
        # H4: explicit EP constraints on the MoE dispatch
        ("moe-ep", lambda c: c.replace(moe_shard_constraints=True), {}),
        # H5: query-chunked MLA shrinks the (h, sq, sk) scores at 32k
        ("mla-qchunk", lambda c: c.replace(mla_q_chunk=2048), {}),
        ("moe-ep+qchunk", lambda c: c.replace(moe_shard_constraints=True,
                                              mla_q_chunk=2048), {}),
        # H9b: the ZeRO-3 gather, as in cell A
        ("zero3-gather", lambda c: c.replace(fsdp_gather_params=True), {}),
        ("zero3+qchunk", lambda c: c.replace(fsdp_gather_params=True,
                                             mla_q_chunk=2048), {}),
    ],
    # ---- cell C: qwen1.5-32b decode_32k
    ("qwen1.5-32b", "decode_32k"): [
        # H6: kv heads (40) do not divide model=16, so the cache replicates;
        # shard the sequence axis instead
        ("kv-seq-shard", lambda c: c, {"cache_seq_fallback": True}),
        # H7: an int8 KV cache halves the cache's bytes again
        ("kv-seq-shard+int8", lambda c: c.replace(kv_cache_dtype="int8"),
         {"cache_seq_fallback": True}),
    ],
}

# SVD serving cells: (m, n, rank, batch): tracker flushes (the optimizer's
# geometry), per-user adapters (the serving geometry), a wide-matrix stream
SVD_CELLS = [
    (256, 512, 8, 64),
    (512, 768, 16, 16),
    (1024, 4096, 32, 8),
]

# fleet per-shard cells: (m, n, rank, batch, depth): the round a backlogged
# fleet shard seals, k sequential pairs a stream in one call
FLEET_CELLS = [
    (64, 96, 8, 8, 8),
    (64, 96, 8, 8, 32),
    (512, 768, 16, 2, 8),
]


def _states(m, n, r, batch, k, dtype, device, seed=0):
    """Random rank-r factors of ``batch`` (m, n) problems and their pairs
    (``k`` a stream when given), from one seed."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.normal(size=(batch, m, r)))[0]
    v = np.linalg.qr(rng.normal(size=(batch, n, r)))[0]
    s = np.sort(rng.uniform(1.0, 10.0, size=(batch, r)), axis=-1)[:, ::-1]
    lead = (batch,) if k is None else (batch, k)
    a, b = rng.normal(size=lead + (m,)), rng.normal(size=lead + (n,))
    return [torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)
            for x in (u, s, v, a, b)]


def run_svd_cell(m: int, n: int, r: int, batch: int, *, out_dir: Path = OUT_DIR,
                 k: int | None = None, dtype="float32", device="cuda") -> dict:
    """Count and time one batched truncated-update flush through the engine
    the ``direct`` policy resolves (``k``: the rank-k flush of k pairs a
    stream a fleet shard's deep rounds run), on ``device``."""
    from repro_torch import api
    from repro_torch.api.state import resolve_device
    from repro_torch.api.update import engine_from_key
    from repro_torch.core.svd_update import TruncatedSvd

    dev = resolve_device(device)
    eng = engine_from_key(api.UpdatePolicy(method="direct"), r + 1)
    u, s, v, a, b = _states(m, n, r, batch, k, getattr(torch, dtype), dev)
    t = TruncatedSvd(u, s, v)
    if k is None:
        flush = lambda: eng.update_truncated_batch(t, a, b)  # noqa: E731
    else:
        flush = lambda: eng.update_truncated_rank_k_batch(t, a, b)  # noqa: E731

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    flops, byts = count_ops(flush)         # also the warm-up: first-call costs stay out
    sync()
    t0 = time.perf_counter()
    flush()
    sync()
    seconds = time.perf_counter() - t0
    rt = roofline_terms({"flops": flops, "bytes accessed": byts}, {"count": 0}, HW(chips=1))
    model = svd_update_flops(m, n, r, batch) * (k or 1)
    shape = f"B{batch}_m{m}_n{n}_r{r}" + (f"_k{k}" if k else "")
    record = {
        "arch": "svd-flush" if k is None else "svd-fleet-shard",
        "shape": shape,
        "mesh": "single",
        "method": "engine-trunc-batch" if k is None else "engine-rank-k",
        "device": str(dev),
        "dtype": dtype,
        "seconds": seconds,
        "counted": {"flops": "products only (torch.utils.flop_counter)",
                    "bytes": "unfused upper bound: every op's input and output bytes, "
                             "views excluded"},
        "roofline": rt,
        "memory": {"peak_bytes": None},
        "useful_flops_ratio": model / rt["flops_per_device"] if rt["flops_per_device"] else None,
        "model_flops": model,
    }
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"svd_{shape}.json").write_text(json.dumps(record, indent=1))
    return record


def run_svd_cells(out_dir: Path = OUT_DIR, *, device="cuda", cells=None) -> list[dict]:
    """Every ``SVD_CELLS`` and ``FLEET_CELLS`` entry (or ``cells``, tuples of
    (m, n, r, batch, k or None)); prints one line a cell."""
    if cells is None:
        cells = [(m, n, r, b, None) for m, n, r, b in SVD_CELLS] + list(FLEET_CELLS)
    out = []
    for m, n, r, b, k in cells:
        rec = run_svd_cell(m, n, r, b, k=k, out_dir=out_dir, device=device)
        rt = rec["roofline"]
        ur = rec["useful_flops_ratio"]
        print(f"OK {rec['arch']}/{rec['shape']}: flops {rt['flops_per_device']:.4g} "
              f"bytes {rt['bytes_per_device']:.4g} useful "
              f"{ur if ur is None else round(ur, 3)} {rec['seconds'] * 1e3:.2f} ms on "
              f"{rec['device']}", flush=True)
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="count the hill-climb variants, or the SVD cells")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--cell", default=None, help="arch:shape filter")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--svd", action="store_true",
                    help="count and time the SVD flush cells instead of the LM variants")
    ap.add_argument("--device", default="cuda", help="where --svd runs (cuda or cpu)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.svd:
        run_svd_cells(out_dir, device=args.device)
        return

    for (arch, shape), variants in VARIANTS.items():
        if args.cell and args.cell != f"{arch}:{shape}":
            continue
        for tag, mutate, kw in variants:
            try:
                cfg = mutate(configs.get(arch))
                # the baseline of cell C ran without the sequence fallback;
                # the variants opt in explicitly
                kwargs = {"cache_seq_fallback": False}
                kwargs.update(kw)
                r = run_cell(arch, shape, multi_pod=args.multi_pod, out_dir=out_dir,
                             method_tag=tag, cfg_override=cfg, **kwargs)
                rt = r["roofline"]
                print(f"OK {arch}/{shape}/{tag}: "
                      f"t_comp={rt['t_compute_s'] * 1e3:.1f}ms "
                      f"t_mem={rt['t_memory_s'] * 1e3:.1f}ms "
                      f"t_coll={rt['t_collective_s'] * 1e3:.1f}ms "
                      f"arg={r['memory']['argument_bytes'] / 1e9:.1f}GB", flush=True)
            except Exception as e:  # noqa: BLE001 - a variant's failure is reported, the rest run
                print(f"FAIL {arch}/{shape}/{tag}: {e}", flush=True)
                traceback.print_exc(limit=3)


if __name__ == "__main__":
    main()
