"""The program's spans as the benchmark reads them: the reduction of a
Chrome trace by ``repro:`` ranges, the stretch that makes the readings, and
the six readers."""

from __future__ import annotations

import pytest
import torch

from _cells import GRANITE, small
from perfbench.harness import manifest
from perfbench.harness.program_stretch import run_stretch
from perfbench.harness.program_trace import reduce_program_trace

READERS = ("train.span.fwd_bwd_ms", "train.span.trackers_ms", "train.span.optimizer_rest_ms",
           "train.trackers_launches", "train.trackers_syncs", "train.trackers_busy_ms")


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": "repro:" + name, "ts": ts, "dur": dur}


def _call(name, ts, corr=None):
    e = {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _op(ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"op{corr}", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def test_reduction_by_innermost_span():
    """One step: train_step [0, 100) > trackers [10, 45) > deflate [20, 40).
    Launches at 5 (step), 15 (trackers), 25 and 30 (deflate), 70 (step); a
    sync at 35 in deflate; the card busy [6, 12), [26, 28), [31, 50), [71, 80)
    (a copy among them): idle from 0, 12, 28, 50 and 80, each under the span
    open when it began."""
    trace = {"traceEvents": [
        _range("train_step", 0, 100), _range("trackers", 10, 35), _range("deflate", 20, 20),
        _call("cudaLaunchKernel", 5, 1), _call("cudaLaunchKernel", 15, 2),
        _call("cudaLaunchKernel", 25, 3), _call("cudaMemcpyAsync", 30, 4),
        _call("cudaStreamSynchronize", 35), _call("cudaLaunchKernel", 70, 5),
        _op(6, 6, 1), _op(26, 2, 2), _op(31, 19, 4, cat="gpu_memcpy"), _op(71, 9, 5),
        _op(27, 1, 3),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 25, "id": 3},
    ]}
    red = reduce_program_trace(trace)
    assert red["steps"] == 1
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["busy_s"] == pytest.approx((6 + 2 + 19 + 9) * 1e-6)
    sp = red["spans"]
    assert set(sp) == {"train_step", "trackers", "deflate"}
    assert (sp["deflate"]["launches"], sp["trackers"]["launches"],
            sp["train_step"]["launches"]) == (2, 3, 5)
    assert (sp["deflate"]["self"]["launches"], sp["trackers"]["self"]["launches"],
            sp["train_step"]["self"]["launches"]) == (2, 1, 2)
    assert sp["deflate"]["device_s"] == pytest.approx(20e-6)
    assert sp["trackers"]["device_s"] == pytest.approx(22e-6)
    assert (sp["deflate"]["syncs"], sp["trackers"]["syncs"], sp["train_step"]["syncs"]) == (1, 1, 1)
    assert sp["trackers"]["self"]["syncs"] == 0
    # gaps: [0,6) step, [12,26) trackers, [28,31) deflate, [50,71) step, [80,100) step
    assert sp["deflate"]["idle_s"] == pytest.approx(3e-6)
    assert sp["trackers"]["idle_s"] == pytest.approx(17e-6)
    assert sp["trackers"]["self"]["idle_s"] == pytest.approx(14e-6)
    assert sp["train_step"]["idle_s"] == pytest.approx(64e-6)
    assert sp["train_step"]["host_s"] == pytest.approx(100e-6)
    assert sp["train_step"]["self"]["host_s"] == pytest.approx(65e-6)
    assert sp["trackers"]["self"]["host_s"] == pytest.approx(15e-6)
    assert red["outside"] == {"launches": 0, "device_s": 0, "syncs": 0, "idle_s": 0}


def test_reduction_per_step_and_outside():
    """Two steps halve every figure; work launched outside any span is
    outside; a trace without program spans reduces to nothing."""
    trace = {"traceEvents": [
        _range("train_step", 0, 10), _range("train_step", 20, 10),
        _call("cudaLaunchKernel", 1, 1), _call("cudaLaunchKernel", 21, 2),
        _call("cudaLaunchKernel", 12, 3), _call("cudaDeviceSynchronize", 31),
        _op(2, 4, 1), _op(22, 4, 2), _op(13, 2, 3)]}
    red = reduce_program_trace(trace)
    assert red["steps"] == 2
    assert red["spans"]["train_step"]["count"] == 1
    assert red["spans"]["train_step"]["launches"] == 1
    assert red["spans"]["train_step"]["device_s"] == pytest.approx(4e-6)
    assert red["outside"]["launches"] == 0.5 and red["outside"]["syncs"] == 0.5
    assert reduce_program_trace({"traceEvents": [_op(0, 1, 1)]})["spans"] == {}


def _reader(name):
    return manifest.layer_reader(name)


def test_readers_read_the_stretch_and_refuse_a_truncated_one():
    spans = [{"train_step": 10.0, "fwd_bwd": 6.0, "optimizer": 4.0, "trackers": 3.0},
             {"train_step": 12.0, "fwd_bwd": 8.0, "optimizer": 4.0, "trackers": 2.0,
              "refresh": 1.0}]
    trackers = {"count": 1, "host_s": 0.5, "launches": 31000.0, "device_s": 0.04,
                "syncs": 3.0, "idle_s": 0.4, "self": {}}
    rec = {"program_spans": spans, "dropped": 0,
           "program_trace": {"spans": {"trackers": trackers}}}
    got = {n: _reader(n)(rec) for n in READERS}
    assert got == pytest.approx({"train.span.fwd_bwd_ms": 7.0, "train.span.trackers_ms": 2.5,
                                 "train.span.optimizer_rest_ms": 1.5,
                                 "train.trackers_launches": 31000.0, "train.trackers_syncs": 3.0,
                                 "train.trackers_busy_ms": 40.0})
    assert all(_reader(n)(dict(rec, dropped=2)) is None for n in READERS)
    # the driver's record alone, outside a traced run of perfbench/run.py
    assert all(_reader(n)({"pieces": [], "trace": None}) is None for n in READERS)


def test_stretch_at_test_size_on_the_cpu(tmp_path):
    """The stretch's control flow: the CPU has no device spans and no
    launches, but every span of the step lies in the reduced trace."""
    path = tmp_path / "program.trace.json"
    out = run_stretch(small(GRANITE), 2 ** 33 + 7, torch.device("cpu"), path)
    assert path.exists()
    assert out["program_spans"] == [] and out["dropped"] == 0
    red = out["program_trace"]
    assert red["steps"] == 2
    assert {"train_step", "fwd_bwd", "optimizer", "trackers", "tracker_group", "power_iter",
            "brand_residual", "core_update", "brand_rotate", "deflate", "secular_solve",
            "loewner", "givens", "cauchy_product", "moments"} <= set(red["spans"])
    assert red["spans"]["tracker_group"]["count"] == 2
    assert red["spans"]["trackers"]["launches"] == 0
