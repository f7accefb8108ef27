"""Dry-run on the meta device: build every (arch x shape) cell at full size,
run its step once with no data, and reckon per-device roofline terms on the
production mesh.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell
for 512 placeholder devices and reads XLA's cost analysis.  Here nothing is
compiled and nothing is allocated: the parameters come from ``api.init(None,
device="meta")``, the inputs from ``api.input_specs`` as meta tensors, and
the cell's step runs once on them (the train step with AdamW, ``prefill`` or
``decode_step``) under two counters:

* FLOPs from ``torch.utils.flop_counter.FlopCounterMode``, which counts
  products only (matmuls, attention, convolutions), not elementwise work;
* bytes from a dispatch mode that adds up every op's input and output bytes,
  views excluded: an unfused upper bound on HBM traffic (a fused kernel
  reads and writes less).

Both are global counts; per-device figures are the global ones over the
mesh's entries.  Collective bytes are reckoned from the sharding rules
(``roofline.collective_bytes``), argument bytes per device from the specs
and the production axis sizes.  Peak bytes are None: no memory tracker
works on the meta device.  The pass counts every layer (there is no scan to
undercount), so the depth-affine extrapolation of the reference,

    total(L) = f(1) + (L - 1) * (f(2) - f(1)),

is only a faster option (``extrapolate=True``).  JSONs keep the reference's
schema and go to ``build/repro_torch/dryrun/`` unless ``--out`` says
otherwise.  The command runs on the CPU and needs no card:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import NamedTuple

import torch
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch._tree import flatten_up_to, tree_leaves
from repro_torch.configs.base import SHAPES
from repro_torch.dist import sharding as sh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import HW, collective_bytes, model_flops, roofline_terms
from repro_torch.models.registry import build_model, zeros_like_specs
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.train.loop import loss_and_grads

__all__ = ["CellCount", "count_ops", "lower_cell", "run_cell"]

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "dryrun"

#: what the JSON's counts are
COUNTED = {
    "flops": "products only (torch.utils.flop_counter: matmuls, attention, convolutions)",
    "bytes": "unfused upper bound: every op's input and output bytes, views excluded",
    "per_device": "the global count over the mesh's entries",
    "collectives": "reckoned from the sharding rules (launch.roofline.collective_bytes)",
    "argument_bytes": "from the specs and the production axis sizes",
}

_aten = torch.ops.aten
# ops that move no bytes: aliases, and allocations that write nothing
_FREE = {_aten.detach.default, _aten.alias.default, _aten._unsafe_view.default,
         _aten.lift_fresh.default, _aten.empty.memory_format, _aten.empty_strided.default}


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _pytree_leaves(tree)
               if isinstance(x, torch.Tensor))


class _ByteCount(TorchDispatchMode):
    """Adds up the bytes every op reads and writes (views excluded)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func not in _FREE:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def count_ops(fn) -> tuple[int, int]:
    """``(flops, bytes)`` of running ``fn()``: products only, and every op's
    inputs and outputs (see the module docstring)."""
    with FlopCounterMode(display=False) as flops, _ByteCount() as byts:
        fn()
    return flops.get_total_flops(), byts.bytes


class CellCount(NamedTuple):
    """Global counts of one cell's step, and its per-device argument bytes
    and collectives."""

    flops: int
    bytes: int
    collectives: dict
    argument_bytes: float


def _sharded_bytes(tree, specs, sizes) -> float:
    """Bytes a device holds of ``tree`` under ``specs`` at the axis ``sizes``."""
    total = 0.0
    for leaf, spec in zip(tree_leaves(tree), flatten_up_to(tree, specs)):
        cut = math.prod(sh.spec_divisor(ax, sizes) for ax in spec)
        total += leaf.numel() * leaf.element_size() / cut
    return total


def _train_step(api, params, opt_state, batch, lr=3e-4):
    """The reference's ``_train_step_fn``: loss and gradients (through
    ``gather_for_compute`` when ``cfg.fsdp_gather_params``), then AdamW."""
    cfg = api.cfg
    if cfg.fsdp_gather_params:
        api = api._replace(train_loss=lambda p, b, loss=api.train_loss: loss(
            sh.gather_for_compute(p, cfg.compute_dtype), b))
    _, grads = loss_and_grads(api, params, batch)
    with torch.no_grad():
        return adamw_update(grads, opt_state, params, lr=lr)


def _cell(cfg, shape, mesh, *, multi_pod: bool, shape_name: str, cache_seq_fallback: bool):
    """``(run, collectives, argument_bytes)`` of one cell built on the meta
    device: ``run()`` takes its step once."""
    api = build_model(cfg)
    specs = api.input_specs(shape)
    params = api.init(None, device="meta")
    p_specs = sh.param_pspecs(params)
    sizes = mesh.shape
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    coll = collective_bytes(params, p_specs, tokens=tokens, train=shape.kind == "train",
                            gather=cfg.fsdp_gather_params, compute_dtype=cfg.compute_dtype,
                            multi_pod=multi_pod, moe=cfg.moe, sizes=sizes)
    arg = _sharded_bytes(params, p_specs, sizes)

    def compute_params():
        if cfg.fsdp_gather_params:
            return sh.gather_for_compute(params, cfg.compute_dtype)
        return params

    if shape.kind == "train":
        batch = zeros_like_specs(specs["batch"], device="meta")
        opt_state = adamw_init(params)
        arg += 2 * _sharded_bytes(opt_state.m, p_specs, sizes)
        arg += _sharded_bytes(batch, sh.batch_pspecs(batch, multi_pod=multi_pod), sizes)
        run = lambda: _train_step(api, params, opt_state, batch)  # noqa: E731
    elif shape.kind == "prefill":
        batch = zeros_like_specs(specs["batch"], device="meta")
        arg += _sharded_bytes(batch, sh.batch_pspecs(batch, multi_pod=multi_pod), sizes)

        def run():
            with torch.no_grad():
                api.prefill(compute_params(), batch)
    else:
        long_ctx = shape_name.startswith("long")
        cache = zeros_like_specs(specs["cache"], device="meta")
        token = zeros_like_specs(specs["token"], device="meta")
        arg += _sharded_bytes(cache, sh.cache_pspecs(
            cache, multi_pod=multi_pod, long_context=long_ctx,
            seq_shard_fallback=cache_seq_fallback), sizes)
        tok_spec = (None, None) if long_ctx else sh.batch_pspecs(token, multi_pod=multi_pod)
        arg += token.numel() * token.element_size() / math.prod(
            sh.spec_divisor(ax, sizes) for ax in tok_spec)

        def run():
            with torch.no_grad():
                api.decode_step(params, cache, token, shape.seq_len - 1)

    return run, coll, arg


def lower_cell(cfg, shape, mesh, *, multi_pod: bool, shape_name: str,
               cache_seq_fallback: bool = True) -> CellCount:
    """Build one (config, shape) cell on the meta device, run its step once
    and count it; ``mesh`` gives the axis sizes of the per-device figures."""
    run, coll, arg = _cell(cfg, shape, mesh, multi_pod=multi_pod, shape_name=shape_name,
                           cache_seq_fallback=cache_seq_fallback)
    flops, byts = count_ops(run)
    return CellCount(flops, byts, coll, arg)


def _measurement_cfg(cfg, n_units: int):
    """The config cut to ``n_units`` repeating units (one layer, or one
    hybrid group of ``attn_every`` layers)."""
    unit = cfg.attn_every if (cfg.ssm is not None and cfg.attn_every) else 1
    return cfg.replace(n_layers=n_units * unit)


def _affine(f1, f2, n_units):
    """Depth-affine extrapolation, clamped: an L-layer program costs at least
    its 2-layer count."""
    return max(f1 + (n_units - 1.0) * (f2 - f1), max(f2, 0.0))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: Path = OUT_DIR,
             method_tag: str = "baseline", extrapolate: bool = False,
             cfg_override=None, cache_seq_fallback: bool = True) -> dict:
    """Count one cell on the production mesh and write its JSON to
    ``out_dir``; returns the record."""
    cfg = cfg_override if cfg_override is not None else configs.get(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    t0 = time.perf_counter()
    kw = dict(multi_pod=multi_pod, shape_name=shape_name, cache_seq_fallback=cache_seq_fallback)

    extra = {}
    if extrapolate:
        unit = cfg.attn_every if (cfg.ssm is not None and cfg.attn_every) else 1
        n_units = cfg.n_layers / unit
        c1 = lower_cell(_measurement_cfg(cfg, 1), shape, mesh, **kw)
        c2 = lower_cell(_measurement_cfg(cfg, 2), shape, mesh, **kw)
        flops = _affine(c1.flops, c2.flops, n_units)
        byts = _affine(c1.bytes, c2.bytes, n_units)
        _, coll, arg = _cell(cfg, shape, mesh, **kw)     # the full depth's: no pass
        extra = {"depth_units": n_units, "f1": c1.flops / n_dev, "f2": c2.flops / n_dev}
        raw_flops = raw_bytes = None
    else:
        count = lower_cell(cfg, shape, mesh, **kw)
        flops, byts, coll, arg = count
        raw_flops, raw_bytes = count.flops / n_dev, count.bytes / n_dev
    seconds = time.perf_counter() - t0

    hw = HW(chips=n_dev)
    terms = roofline_terms({"flops": flops / n_dev, "bytes accessed": byts / n_dev}, coll, hw)
    mf = model_flops(cfg, shape)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": n_dev,
        "method": method_tag,
        "compile_s": round(seconds, 1),
        "counted": COUNTED,
        "memory": {"argument_bytes": arg, "output_bytes": None, "temp_bytes": None,
                   "peak_bytes": None},
        "cost": {"flops": flops / n_dev, "bytes accessed": byts / n_dev,
                 "flops_scanned_raw": raw_flops, "bytes_scanned_raw": raw_bytes,
                 "flops_global": flops, "bytes_global": byts},
        "collectives": coll,
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / terms["flops_per_device"]
        if terms["flops_per_device"] else None,
        "extrapolation": extra,
    }
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{shape_name}__{result['mesh']}"
    if method_tag != "baseline":
        tag += f"__{method_tag}"
    (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=2))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--extrapolate", action="store_true",
                    help="count depth 1 and 2 and extrapolate (faster; the default counts "
                         "every layer)")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    cells = configs.cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape_name in cells:
        for mp in meshes:
            tag = f"{arch}__{shape_name}__{'2x16x16' if mp else '16x16'}"
            if args.skip_existing and (out_dir / f"{tag}.json").exists():
                print(f"SKIP {tag}", flush=True)
                continue
            try:
                r = run_cell(arch, shape_name, multi_pod=mp, out_dir=out_dir,
                             extrapolate=args.extrapolate)
                rt = r["roofline"]
                ur = r["useful_flops_ratio"]
                print(f"OK   {tag}: counted in {r['compile_s']}s "
                      f"flops/dev={rt['flops_per_device']:.3e} "
                      f"t_comp={rt['t_compute_s'] * 1e3:.2f}ms "
                      f"t_mem={rt['t_memory_s'] * 1e3:.2f}ms "
                      f"t_coll={rt['t_collective_s'] * 1e3:.2f}ms "
                      f"useful={ur and round(ur, 3)}", flush=True)
            except Exception as e:  # noqa: BLE001 - a cell's failure is reported, the rest run
                failures.append((tag, repr(e)))
                print(f"FAIL {tag}: {e}", flush=True)
                traceback.print_exc(limit=4)
    if failures:
        print(f"\n{len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nall dry-run cells counted")


if __name__ == "__main__":
    main()
