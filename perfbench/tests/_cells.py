"""Cells of the manifest cut to a size a CPU test holds, and a context that
drives a run without the harness's look for a card."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from perfbench.harness import manifest  # noqa: E402

GRANITE = "granite34b.spectral-adam"
SVD = "svd-stream.test"


def svd_cell() -> manifest.Cell:
    """A cell of the service driver (``drivers/svd_stream.py``), built here:
    ``BENCHMARK.json`` has no service cell until a deployment with a public
    source is chosen for it (PERF.md, Open questions).  Its rules are the
    float64 service's: each stream's events in admission order, every token
    made visible once, the states within the limits set on the card."""
    e2e = [{"name": "svd_events_per_s", "unit": "events/s"},
           {"name": "svd_visible_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}]
    layer = [{"name": n, "unit": u} for n, u in (
        ("svd.admit_us", "us"), ("svd.round_host_ms", "ms"), ("svd.plan_cache_misses", "count"),
        ("svd.kernel_b_roofline", "%"), ("device_idle.svd", "%"))]
    return manifest.Cell(
        name=SVD, chips=1,
        config={"name": "svd-stream-test", "m": 1024, "n": 4096, "rank": 32, "dtype": "float64",
                "streams": 1024, "method": "fused", "max_batch": 1024, "max_in_flight": 2,
                "max_depth": 8},
        traffic={"driver": "svd_stream", "outstanding": 16, "pool": 4096, "spectrum": [100.0, 10.0],
                 "warm_rounds": 4, "checked_streams": 16, "drain_timeout_s": 60,
                 "trace_seconds": 1.0},
        limits={"limits": {"recon": {"limit": 3e-08}, "sigma": {"limit": 1e-07},
                           "never_visible": {"limit": 0}, "bad_tokens": {"limit": 0}}},
        end_to_end=e2e, per_layer=layer)


def small(cell_name: str):
    """The cell at test size: every shape cut, every rule kept."""
    cell = svd_cell() if cell_name == SVD else copy.deepcopy(manifest.resolve(cell_name))
    if cell.traffic["driver"] == "train_step":
        cell.config.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_head=16, d_ff=128,
                           vocab_size=512, vocab_pad_to=64, seq_len=32, global_batch=1)
        cell.traffic["optimizer"]["spectral_rank"] = 4
    else:
        cell.config.update(m=16, n=40, rank=4, streams=8, max_batch=8)
        cell.traffic.update(pool=64, checked_streams=8, warm_rounds=2, drain_timeout_s=5)
    return cell


class Ctx:
    """A run's context on the CPU, no trace."""

    def __init__(self, cell, seed: int = 2 ** 33 + 7, seconds: float = 0.5):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, False
        self.device = torch.device("cpu")
        self.trace_path = None
        self.t_window = None
        self.log = lambda msg: None

    def window_start(self, t):
        self.t_window = t


def run(cell, seed: int = 2 ** 33 + 7, seconds: float = 0.5) -> dict:
    """The driver's output and the result line (as ``run.py`` builds it)."""
    from perfbench.run import result_line

    ctx = Ctx(cell, seed, seconds)
    out = manifest.driver(cell.traffic["driver"]).run(ctx)
    line = result_line(cell, out, 0.0, False, None, "cpu")
    return out, line
