"""The command itself: without a card it fails and prints no result (it never
falls back to the CPU); a checkout holding only the benchmark's files fails
too; the result line and the trace's reduction keep their form."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from _cells import ROOT

from perfbench.harness.trace import breakdown, idle_share, reduce_trace
from perfbench.run import checks_of, passes, result_line

CELL = "granite34b.spectral-adam"


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELL,
                           "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=600, env=env)


@pytest.fixture
def no_card_env():
    import torch

    if torch.cuda.is_available():
        return dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return None


def test_without_a_card_it_fails_and_prints_nothing(no_card_env):
    res = _run(ROOT, no_card_env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "never on the CPU" in res.stderr


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", ".traces", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = _run(tmp_path)
    assert res.returncode != 0
    assert not [ln for ln in res.stdout.splitlines() if ln.startswith("{")]


def _trace(events):
    return {"traceEvents": [dict(ph="X", **e) for e in events]}


def test_trace_reduction_unions_and_labels():
    red = reduce_trace(_trace([
        {"name": "pb:traced", "cat": "user_annotation", "ts": 0, "dur": 100},
        {"name": "pb:pump", "cat": "user_annotation", "ts": 0, "dur": 40},
        {"name": "pb:client", "cat": "user_annotation", "ts": 40, "dur": 60},
        {"name": "pb:admit", "cat": "user_annotation", "ts": 70, "dur": 5},
        {"name": "k1", "cat": "kernel", "ts": 10, "dur": 20},
        {"name": "k1", "cat": "kernel", "ts": 20, "dur": 20},       # overlaps the first
        {"name": "copy", "cat": "gpu_memcpy", "ts": 50, "dur": 10},
        {"name": "k2", "cat": "kernel", "ts": 72, "dur": 8},
        {"name": "old", "cat": "kernel", "ts": -5, "dur": 10},      # began before the window
    ]))
    assert red["window_s"] == pytest.approx(100e-6)
    # busy: [0, 5) + [10, 40) + [50, 60) + [72, 80)
    assert red["busy_s"] == pytest.approx(53e-6)
    assert red["launches"] == {"k1": 2, "copy": 1, "k2": 1}
    assert red["device_ops"]["k1"] == pytest.approx(40e-6)
    # idle: [5, 10) and [40, 50) ... under pump / client, [60, 72) client,
    # [80, 100) client
    assert red["idle_gaps"] == pytest.approx({"pb:pump": 5e-6, "pb:client": 42e-6})
    assert idle_share({"trace": red}) == pytest.approx(47.0)
    top = breakdown(red)
    assert top["device_ops"][0][0] == "k1" and len(top["idle_gaps"]) == 2


def test_result_line_orders_keys_and_decides_correct():
    from _cells import svd_cell

    cell = svd_cell()
    out = {"e2e": {"svd_events_per_s": 1000.0, "svd_visible_p95_ms": 20.0},
           "numbers": {"recon": 1e-13, "sigma": 1e-14, "never_visible": 0.0, "bad_tokens": 0.0},
           "attempted": 10, "failed": 0, "memory_peak_bytes": 123, "rec": {}, "trace": None}
    line = result_line(cell, out, 12.5, False, 700.0, "card")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] and line["metrics"]["setup_s"] == {"value": 12.5, "unit": "s"}
    assert json.loads(json.dumps(line)) == line
    out["numbers"]["recon"] = float("nan")
    assert not passes(checks_of(out["numbers"], cell.limits))
    assert not result_line(cell, out, 12.5, False, 700.0, "card")["correct"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark runs on the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, trace):
    """The training cell for a few seconds: one result line of the contract's
    form, correct, and (traced) the per-layer metrics and the device's busy
    time."""
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELL, "--seed",
                          str(2 ** 32 + 5), "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"], line
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert line["device"]["busy_s"] > 0 and "train.fwd_bwd_ms" in line["metrics"]
        assert len(line["breakdown"]["device_ops"]) <= 10
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_collector_is_held_over_the_window_and_restored():
    import gc

    from perfbench.harness.host import collector_held

    assert gc.isenabled()
    with collector_held():
        assert not gc.isenabled() and gc.get_freeze_count() > 0
    assert gc.isenabled() and gc.get_freeze_count() == 0
