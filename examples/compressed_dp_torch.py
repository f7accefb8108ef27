"""Compressed data-parallel training in a ``torch.distributed`` world, with
the PyTorch/CUDA port.

The port's counterpart of ``examples/compressed_dp.py``, at its sizes, seed
and checks.  A small linear regression (64 -> 128, a rank-4 target) trains
with data parallelism two ways: dense (each gradient averaged across the
ranks) and compressed, where a gradient crosses the wire only as two rank-8
factors (``optim.compression.compress_decompress``: a PowerSGD step against a
basis that the paper's streaming rank-1 update keeps fresh, with per-rank
error feedback).  The script compares the two final losses and prints the
wire bytes.

The reference's 8 emulated devices under ``shard_map`` become ``--world``
processes (default 8), started with ``torch.multiprocessing`` spawn and
joined in one process group (``compress_decompress(..., axis_name=group)``).
The reference's 8 batches of 64 rows are split over the ranks in order, so
at ``--world 8`` each rank holds one of them, and the dense run is
full-batch gradient descent at any world size.

On the card every rank runs on ``cuda:0`` over gloo, which stages the CUDA
tensors through the host: NCCL takes one rank a card and cannot put two
ranks on one.  NCCL is taken only when ``--world`` is at most the number of
cards (rank r on ``cuda:r``).  With ``--device cpu`` the world runs gloo on
the CPU.  The trackers' rank-1 updates go through ``api.update`` under the
``auto`` policy: at (64, 128, r 8) geometry picks the fused route, kernel B
on the card.  The trackers do not feed the weights (only a basis refresh
would read them, and this run makes none), so the figures are the same on
every route.

Run on the card:          python3 examples/compressed_dp_torch.py
Run on the CPU (plain):   python3 examples/compressed_dp_torch.py --device cpu [--world 2]
"""

from __future__ import annotations

import argparse
import pickle
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

M_IN, M_HID, RANK, STEPS, LR = 64, 128, 8, 300, 2.0
SHARDS, ROWS = 8, 64     # the reference's per-device batches


def data(device):
    """The reference's inputs, float32: ``(w_true, x_all (8, 64, 64), y_all
    (8, 64, 128))``."""
    rng = np.random.default_rng(0)
    # low-rank target: the regime gradient compression exploits (real LM
    # gradients are spectrally concentrated, see the spectral optimizer)
    w_true = rng.normal(size=(M_IN, 4)) @ rng.normal(size=(4, M_HID))
    x_all = torch.as_tensor(rng.normal(size=(SHARDS, ROWS, M_IN)), dtype=torch.float32,
                            device=device)
    w_t = torch.as_tensor(w_true, dtype=torch.float32, device=device)
    return w_true, x_all, torch.einsum("dbi,ih->dbh", x_all, w_t)


def _loss(w, x, y):
    return torch.mean((x @ w - y) ** 2)


def _grad(w, x, y):
    w = w.detach().requires_grad_(True)
    return torch.autograd.grad(_loss(w, x, y), w)[0]


def _worker(rank: int, world: int, backend: str, device: str, init: str, out_dir: str) -> None:
    """One rank: its slice of the batches, 300 dense and 300 compressed steps;
    writes ``rank<r>.pkl`` (rank 0 also the final weights and losses)."""
    from repro_torch import api
    from repro_torch.dist import pmean_factor
    from repro_torch.kernels import _build
    from repro_torch.optim.compression import compress_decompress, compression_init

    if device == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    tdist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    try:
        group = tdist.group.WORLD
        _, x_all, y_all = data(dev)
        x = x_all.reshape(world, -1, M_IN)[rank]      # this rank's rows, in order
        y = y_all.reshape(world, -1, M_HID)[rank]
        policy = api.UpdatePolicy()                   # auto: the fused route for the trackers

        w_d = torch.zeros((M_IN, M_HID), device=dev)
        w_c = torch.zeros((M_IN, M_HID), device=dev)
        comp = compression_init(torch.Generator(device=dev).manual_seed(0), M_IN, M_HID, RANK,
                                device=dev)
        _build.reset_launches()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            # dense DP baseline: the gradient averaged across the ranks
            w_d = w_d - LR * pmean_factor(_grad(w_d, x, y), group)
            # compressed DP: only the two rank-8 factors cross the wire
            g_hat, comp = compress_decompress(comp, _grad(w_c, x, y), axis_name=group,
                                              policy=policy)
            w_c = w_c - LR * g_hat
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out = {"rank": rank, "seconds": time.perf_counter() - t0,
               "launches": dict(_build.LAUNCHES)}
        if rank == 0:
            out.update(ld=float(_loss(w_d, x_all, y_all)), lc=float(_loss(w_c, x_all, y_all)),
                       y_power=float(torch.mean(y_all ** 2)), w_dense=w_d.cpu().numpy(),
                       w_comp=w_c.cpu().numpy())
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        tdist.destroy_process_group()


def main(argv=None) -> dict:
    """Run the world; returns the figures it prints, the final weights, and
    A-F's launches summed over the ranks."""
    from repro_torch.api.state import resolve_device
    from repro_torch.optim.compression import wire_bytes

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--world", type=int, default=SHARDS,
                    help="ranks (processes); must divide the reference's 8 batches")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.world < 1 or SHARDS % args.world:
        raise ValueError(f"--world must divide {SHARDS} (the reference's batches); got {args.world}")
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.library("fused_update_f32")            # build once, before the ranks load it
        backend = "nccl" if args.world <= torch.cuda.device_count() else "gloo"
    else:
        backend = "gloo"

    with tempfile.TemporaryDirectory() as tmp_dir:
        init = f"file://{Path(tmp_dir) / 'store'}"
        t0 = time.perf_counter()
        mp.spawn(_worker, args=(args.world, backend, dev.type, init, tmp_dir),
                 nprocs=args.world, join=True)
        seconds = time.perf_counter() - t0
        ranks = []
        for r in range(args.world):
            with open(Path(tmp_dir) / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    res = ranks[0]
    ld, lc = res["ld"], res["lc"]
    wb = wire_bytes(M_IN, M_HID, RANK)
    print(f"ranks                 : {args.world} ({backend}, {dev.type})")
    print(f"dense-DP final loss   : {ld:.5f}")
    print(f"compressed final loss : {lc:.5f}")
    print(f"wire bytes/layer/step : {wb['dense']:,} -> {wb['compressed']:,} "
          f"({wb['ratio']:.1f}x smaller)")
    assert lc < 0.05 * res["y_power"], "compressed DP failed to converge"
    assert lc < 2.0 * ld + 1e-6, "compressed DP much worse than dense DP"
    print("OK")
    launches = {k: sum(r_["launches"][k] for r_ in ranks) for k in res["launches"]}
    return {"world": args.world, "backend": backend, "dense_loss": ld, "compressed_loss": lc,
            "y_power": res["y_power"], "wire_bytes": wb, "w_dense": res["w_dense"],
            "w_comp": res["w_comp"], "seconds": seconds,
            "loop_seconds": max(r_["seconds"] for r_ in ranks), "launches": launches}


if __name__ == "__main__":
    main()
