"""``repro_torch.serve.SvdService`` against the reference's
``repro.serve.SvdService``, and its checkpoints (``train.checkpoint``).

The reference's checkpoint cases, ported: snapshot round trips mid-run,
after a partial flush, with structured, sparse and downdate events pending;
the v1–v5 back-compat paths; the version guard; async rounds equal to
synchronous ones bitwise; backpressure; kill-and-resume in fresh processes,
bitwise; restore warming its warmed set so the first flush adds no cache
miss.  A mesh must be a ``dist.Mesh``; the mesh-sharded service's parity
tests are in ``tests/test_torch_mesh.py``.

Parity with the reference: both services fed the same numpy states and
events (f64) under ``direct``, ``pallas`` and ``fused`` (their plain versions
on the CPU; the reference's Pallas kernels in interpret mode) agree to 1e-10
in their factors; their warmed sets agree entry for entry; and a snapshot
written by either package restores in the other with its leaves bitwise
equal.  Sizes stay small (m <= 32, r <= 4).
"""

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import api, convert
from repro_torch.core.engine import default_engine
from repro_torch.core.svd_update import TruncatedSvd
from repro_torch.serve import SNAPSHOT_VERSION, ServiceSnapshot, SvdService
from repro_torch.train import checkpoint as ckpt
from repro_torch.updates import (AppendRows, Compose, Decay, RankK, RemoveCols, RemoveRows,
                                 Sparse, Window)

REPO = Path(__file__).resolve().parent.parent
RAPI = ref("api")
RSERVE = ref("serve")
RU = ref("updates")
RCKPT = ref("train.checkpoint")
RTSVD = ref("core.svd_update").TruncatedSvd

# the port's service against the reference's on the same f64 inputs
PARITY_ATOL = 1e-10


def _fresh_np(m, n, r, rng):
    return (np.linalg.qr(rng.normal(size=(m, r)))[0],
            np.sort(np.abs(rng.normal(size=r)))[::-1].copy(),
            np.linalg.qr(rng.normal(size=(n, r)))[0])


def _fresh(m, n, r, rng=None):
    rng = rng if rng is not None else np.random.default_rng(5)
    return TruncatedSvd(*(torch.as_tensor(x) for x in _fresh_np(m, n, r, rng)))


def _traffic(n_events, streams, m, n, rng):
    return [(f"s{i % streams}", rng.normal(size=m), rng.normal(size=n))
            for i in range(n_events)]


def _feed(svc, events):
    for sid, a, b in events:
        svc.enqueue(sid, a, b)


def _exact_states(svc_a, svc_b, stream_ids):
    for sid in stream_ids:
        for f in ("u", "s", "v"):
            x, y = getattr(svc_a.state(sid), f), getattr(svc_b.state(sid), f)
            assert x.dtype == y.dtype
            assert torch.equal(x, y), (sid, f)


def _restore(path, **kw):
    return SvdService.restore(path, device="cpu", **kw)


# -- the checkpoint layer ---------------------------------------------------------


def test_checkpoint_aux_roundtrip_and_flat_restore(tmp_path):
    tree = {"a": np.arange(6.0).reshape(2, 3), "b": np.float32([1.5, -2.5]),
            "c": torch.arange(4, dtype=torch.int32)}
    aux = {"kind": "demo", "ids": ["x", "y"], "n": 2}
    ckpt.save(tmp_path, 3, tree, aux=aux)
    assert ckpt.load_aux(tmp_path) == (3, aux)
    step, leaves = ckpt.restore(tmp_path, None)
    assert step == 3 and len(leaves) == 3
    for lv, want in zip(leaves, (tree["a"], tree["b"], tree["c"].numpy())):
        assert lv.dtype == want.dtype
        np.testing.assert_array_equal(lv, want)
    names = json.loads((tmp_path / "step_000000003" / "treedef.json").read_text())["names"]
    assert names == ["['a']", "['b']", "['c']"]
    ckpt.save(tmp_path, 4, tree)
    assert ckpt.load_aux(tmp_path, 4) == (4, None)
    # the reference reads the same files, and writes files the port reads
    assert RCKPT.load_aux(tmp_path, 3) == (3, aux)
    for lv, got in zip(leaves, RCKPT.restore(tmp_path, None, 3)[1]):
        assert lv.dtype == got.dtype and np.array_equal(lv, got)
    RCKPT.save(tmp_path / "r", 1, {"w": np.ones(3, np.float32)}, aux={"k": 1})
    assert ckpt.load_aux(tmp_path / "r") == (1, {"k": 1})
    assert ckpt.restore(tmp_path / "r", None)[1][0].dtype == np.float32


def test_checkpoint_gc_checksum_and_structured_restore(tmp_path):
    for step in range(5):
        ckpt.save(tmp_path, step, {"x": np.full(2, float(step))}, keep=2)
    assert sorted(ckpt.available_steps(tmp_path)) == [3, 4]
    assert ckpt.latest_step(tmp_path) == 4
    _, tree = ckpt.restore(tmp_path, {"x": torch.zeros(2, dtype=torch.float32)})
    assert tree["x"].dtype == torch.float32 and tree["x"].tolist() == [4.0, 4.0]
    (tmp_path / "step_000000004" / "arrays.npz").write_bytes(b"torn")
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(tmp_path, None, 4)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", None)


# -- snapshot round trips -------------------------------------------------------------


def test_snapshot_roundtrip_truncated_policy(tmp_path):
    m, n, r, streams = 8, 10, 3, 4
    rng = np.random.default_rng(0)
    init = [_fresh(m, n, r, rng) for _ in range(streams)]
    events = _traffic(19, streams, m, n, rng)
    ids = [f"s{i}" for i in range(streams)]

    ref_svc = SvdService(max_batch=streams)
    for sid, t in zip(ids, init):
        ref_svc.register(sid, t)
    _feed(ref_svc, events)
    ref_svc.drain()

    svc = SvdService(max_batch=streams)
    for sid, t in zip(ids, init):
        svc.register(sid, t)
    split = 10
    _feed(svc, events[:split])
    assert svc.pending() > 0
    svc.save(tmp_path, step=split)

    step, restored = _restore(tmp_path)
    assert step == split
    assert restored.pending() == svc.pending()
    assert restored.stats.applied == svc.stats.applied
    _feed(restored, events[split:])
    restored.drain()
    _exact_states(ref_svc, restored, ids)


def test_snapshot_roundtrip_batched_mixed_geometry(tmp_path):
    rng = np.random.default_rng(1)
    geos = [(8, 10, 3)] * 3 + [(12, 9, 4)] * 3
    ids = [f"g{i}" for i in range(len(geos))]
    init = [_fresh(m, n, r, rng) for (m, n, r) in geos]
    events = []
    for _ in range(5):
        for sid, (m, n, _) in zip(ids, geos):
            events.append((sid, rng.normal(size=m), rng.normal(size=n)))

    def build():
        svc = SvdService(max_batch=4)
        for sid, t in zip(ids, init):
            svc.register(sid, t)
        return svc

    ref_svc = build()
    _feed(ref_svc, events)
    ref_svc.drain()
    assert ref_svc.stats.max_batch >= 4

    svc = build()
    split = 17
    _feed(svc, events[:split])
    svc.save(tmp_path, step=split)
    _, restored = _restore(tmp_path)
    _feed(restored, events[split:])
    restored.drain()
    _exact_states(ref_svc, restored, ids)


def test_restore_after_partial_flush(tmp_path):
    m, n, r, streams = 8, 9, 3, 4
    rng = np.random.default_rng(2)
    ids = [f"s{i}" for i in range(streams)]
    svc = SvdService(max_batch=streams)
    for sid in ids:
        svc.register(sid, _fresh(m, n, r, rng))
    _feed(svc, _traffic(streams, streams, m, n, rng))
    assert svc.stats.flushes == 1
    _feed(svc, _traffic(2, streams, m, n, rng))
    assert svc.pending() == 2

    svc.save(tmp_path, step=1)
    _, restored = _restore(tmp_path)
    assert restored.pending("s0") == 1 and restored.pending("s1") == 1
    assert restored.pending("s2") == 0 and restored.pending("s3") == 0
    _exact_states(svc, restored, ids)
    assert svc.flush() == restored.flush() == 2
    _exact_states(svc, restored, ids)


def test_snapshot_version_guard(tmp_path):
    svc = SvdService(max_batch=2)
    svc.register("x", _fresh(6, 7, 2))
    snap = svc.snapshot()
    assert snap.version == SNAPSHOT_VERSION == 7
    future = dataclasses.replace(snap, version=SNAPSHOT_VERSION + 1)
    future.save(tmp_path, step=1)
    with pytest.raises(ValueError, match="newer"):
        ServiceSnapshot.load(tmp_path)
    ckpt.save(tmp_path, 2, {"w": np.ones(3)})
    with pytest.raises(ValueError, match="not a ServiceSnapshot"):
        ServiceSnapshot.load(tmp_path, 2)


def test_snapshot_is_a_barrier_and_preserves_stats():
    m, n, r, streams = 8, 10, 3, 4
    rng = np.random.default_rng(3)
    svc = SvdService(max_batch=streams, max_in_flight=4)
    for i in range(streams):
        svc.register(f"s{i}", _fresh(m, n, r, rng))
    _feed(svc, _traffic(streams * 3, streams, m, n, rng))
    snap = svc.snapshot()
    assert svc.in_flight() == 0
    stats = dict(snap.stats)
    assert stats["applied"] == streams * 3
    assert stats["flushes"] == svc.stats.flushes
    restored = SvdService.from_snapshot(snap, device="cpu")
    assert restored.stats.applied == streams * 3


def test_snapshot_v2_roundtrips_structured_events_bitwise(tmp_path):
    m, n, r = 8, 10, 3

    def build():
        rng = np.random.default_rng(21)
        svc = SvdService(max_batch=16)
        svc.register("x", _fresh(m, n, r, np.random.default_rng(20)))
        svc.enqueue("x", rng.normal(size=m), rng.normal(size=n))
        svc.enqueue_op("x", RankK(rng.normal(size=(m, 2)), rng.normal(size=(n, 2))))
        svc.enqueue_op("x", Compose((Decay(0.9), AppendRows(rng.normal(size=(2, n))))))
        svc.enqueue("x", rng.normal(size=m + 2), rng.normal(size=n))
        return svc

    ref_svc = build()
    svc = build()
    snap = svc.snapshot()
    assert snap.version == SNAPSHOT_VERSION
    assert "o" in "".join(snap.pending_order)
    svc.save(tmp_path, step=1)
    _, restored = _restore(tmp_path)
    assert restored.pending("x") == ref_svc.pending("x")
    ref_svc.drain()
    restored.drain()
    assert restored.state("x").shape == (m + 2, n)
    _exact_states(ref_svc, restored, ["x"])
    assert restored.stats.ops_applied == ref_svc.stats.ops_applied > 0


def test_snapshot_v1_aux_skeleton_compat():
    aux_v1 = {
        "format": "repro.serve.ServiceSnapshot",
        "version": 1,
        "stream_ids": ["a", "b"],
        "policy": {"method": "direct", "fmm_p": 20, "sign_fix": True, "deflate_rtol": None,
                   "precision": None, "batch_axis": "data", "truncate_to": None,
                   "had_mesh": False},
        "max_batch": 8,
        "pad_to_bucket": True,
        "max_in_flight": 2,
        "stats": {"enqueued": 3, "applied": 1},
    }
    skel = ServiceSnapshot.skeleton(aux_v1)
    assert len(skel.leaves()) == 2 * 5
    assert skel.pending_ops == ((), ())
    assert skel.pending_order == ()
    assert skel.warmed == ()
    svc = SvdService.from_snapshot(
        ServiceSnapshot(
            states=tuple(api.SvdState(*_fresh(6, 7, 2, np.random.default_rng(s)))
                         for s in (0, 1)),
            pending_a=(np.zeros((2, 6)), np.zeros((0, 6))),
            pending_b=(np.zeros((2, 7)), np.zeros((0, 7))),
            pending_ops=((), ()),
            stream_ids=("a", "b"),
            policy_spec=tuple(aux_v1["policy"].items()),
            stats=tuple(aux_v1["stats"].items()),
            pending_order=(),
        ), device="cpu")
    assert svc.pending("a") == 2 and svc.pending("b") == 0


def test_snapshot_v3_sparse_pending_bitwise(tmp_path):
    """A queued ``Sparse`` op rides the snapshot whole, its COO leaves bitwise
    (int32 indices stay int32), and expands to the same pairs after restore."""
    m, n, r, nnz = 8, 10, 3, 7
    coo_rng = np.random.default_rng(31)
    rows = coo_rng.integers(0, 2, nnz).astype(np.int32)
    cols = coo_rng.integers(0, n, nnz).astype(np.int32)
    vals = coo_rng.normal(size=nnz)

    def build():
        rng = np.random.default_rng(32)
        svc = SvdService(max_batch=16)
        svc.register("x", _fresh(m, n, r, np.random.default_rng(30)))
        svc.enqueue("x", rng.normal(size=m), rng.normal(size=n))
        svc.enqueue_op("x", Sparse(rows, cols, vals, rank=2))
        svc.enqueue("x", rng.normal(size=m), rng.normal(size=n))
        return svc

    ref_svc = build()
    svc = build()
    snap = svc.snapshot()
    assert "o" in "".join(snap.pending_order)
    svc.save(tmp_path, step=1)
    _, leaves = ckpt.restore(tmp_path, None)
    assert any(lv.dtype == np.int32 and np.array_equal(lv, rows) for lv in leaves)
    assert any(lv.shape == (nnz,) and np.array_equal(lv, vals) for lv in leaves)
    _, restored = _restore(tmp_path)
    assert restored.pending("x") == ref_svc.pending("x")
    ref_svc.drain()
    restored.drain()
    _exact_states(ref_svc, restored, ["x"])
    assert restored.stats.ops_applied == ref_svc.stats.ops_applied == 1
    assert restored.stats.applied == ref_svc.stats.applied


def test_snapshot_v2_policy_spec_back_compat():
    spec_v2 = {"method": "direct", "fmm_p": 20, "sign_fix": True, "deflate_rtol": None,
               "precision": None, "storage_dtype": None, "batch_axis": "data",
               "truncate_to": None, "had_mesh": False}
    svc = SvdService.from_snapshot(
        ServiceSnapshot(
            states=(api.SvdState(*_fresh(6, 7, 2, np.random.default_rng(0))),),
            pending_a=(np.zeros((0, 6)),),
            pending_b=(np.zeros((0, 7)),),
            pending_ops=((),),
            stream_ids=("a",),
            policy_spec=tuple(spec_v2.items()),
            stats=(("enqueued", 0), ("applied", 0)),
            pending_order=("",),
        ), device="cpu")
    assert svc.policy.sketch_oversample == 8
    assert svc.policy.sketch_power_iters == 1
    assert svc.policy.health_every is None


# -- fresh processes -------------------------------------------------------------------

_ENV = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "HOME": "/tmp"}

_RESTORE_WARM_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from repro_torch.core.svd_update import TruncatedSvd
    from repro_torch.serve import SvdService

    mode, ckpt_dir = sys.argv[1:3]
    rng = np.random.default_rng(13)
    M, N, R, S = 8, 10, 3, 4
    streams = [TruncatedSvd(
        torch.as_tensor(np.linalg.qr(rng.normal(size=(M, R)))[0]),
        torch.as_tensor(np.sort(np.abs(rng.normal(size=R)))[::-1].copy()),
        torch.as_tensor(np.linalg.qr(rng.normal(size=(N, R)))[0]),
    ) for _ in range(S)]

    def feed_round(svc):
        for i in range(S):
            svc.enqueue(f"s{i}", rng.normal(size=M), rng.normal(size=N))

    if mode == "save":
        svc = SvdService(max_batch=S)
        for i, t in enumerate(streams):
            svc.register(f"s{i}", t)
        feed_round(svc)
        svc.drain()
        snap = svc.snapshot()
        svc.save(ckpt_dir, step=1)
        print(json.dumps({"warmed": [list(w) for w in snap.warmed]}))
        sys.exit(0)

    step, svc = SvdService.restore(ckpt_dir, device="cpu")
    eng = svc._engine_for(R)
    info0 = eng.cache_info()
    assert info0.entries >= 1, info0
    feed_round(svc)
    svc.drain()
    info1 = eng.cache_info()
    print(json.dumps({
        "entries_before": info0.entries, "misses_before": info0.misses,
        "misses_after": info1.misses, "hits_gained": info1.hits - info0.hits,
    }))
""")


def _run_script(script, *args):
    proc = subprocess.run([sys.executable, "-c", script, *map(str, args)], capture_output=True,
                          text=True, timeout=300, env=_ENV)
    assert proc.returncode == 0, f"{args[0]} stderr:\n{proc.stderr[-4000:]}"
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_restore_then_first_flush_does_not_recompile(tmp_path):
    """Restore in a FRESH process warms the recorded geometries, so the first
    flush is a pure cache hit."""
    warmed = _run_script(_RESTORE_WARM_SCRIPT, "save", tmp_path)["warmed"]
    assert any(w[0] == "trunc_batch" for w in warmed)
    out = _run_script(_RESTORE_WARM_SCRIPT, "resume", tmp_path)
    assert out["misses_after"] == out["misses_before"]
    assert out["hits_gained"] >= 1


_KILL_RESUME_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from repro_torch.api import UpdatePolicy
    from repro_torch.core.svd_update import TruncatedSvd
    from repro_torch.serve import SvdService

    mode, ckpt_dir, out_npz = sys.argv[1:4]
    rng = np.random.default_rng(7)
    M, N, R, S, E, SPLIT = 8, 10, 3, 4, 22, 11
    streams = [TruncatedSvd(
        torch.as_tensor(np.linalg.qr(rng.normal(size=(M, R)))[0]),
        torch.as_tensor(np.sort(np.abs(rng.normal(size=R)))[::-1].copy()),
        torch.as_tensor(np.linalg.qr(rng.normal(size=(N, R)))[0]),
    ) for _ in range(S)]
    traffic = [(f"s{i % S}", rng.normal(size=M), rng.normal(size=N)) for i in range(E)]

    def feed(svc, evts):
        for sid, a, b in evts:
            svc.enqueue(sid, a, b)

    if mode == "resume":
        step, svc = SvdService.restore(ckpt_dir, device="cpu")
        assert step == SPLIT
        feed(svc, traffic[SPLIT:])
        svc.drain()
    else:
        svc = SvdService(max_batch=S, max_in_flight=2, policy=UpdatePolicy(method="direct"))
        for i, t in enumerate(streams):
            svc.register(f"s{i}", t)
        if mode == "save":
            feed(svc, traffic[:SPLIT])
            pend = svc.pending()
            svc.save(ckpt_dir, step=SPLIT)
            print(json.dumps({"pending_at_snapshot": pend}))
            sys.exit(0)
        feed(svc, traffic)
        svc.drain()
    np.savez(out_npz, **{f"s{i}_{f}": getattr(svc.state(f"s{i}"), f).numpy()
                         for i in range(S) for f in ("u", "s", "v")})
    print(json.dumps({"ok": True}))
""")


def _same_npz(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype == np.float64
        np.testing.assert_array_equal(a[k], b[k])


def test_kill_and_resume_bitwise(tmp_path):
    """Snapshotted mid-run and restored in a fresh process: bitwise the
    uninterrupted run (f64)."""
    full, resumed, ckpt_dir = tmp_path / "full.npz", tmp_path / "resumed.npz", tmp_path / "ckpt"
    _run_script(_KILL_RESUME_SCRIPT, "full", ckpt_dir, full)
    assert _run_script(_KILL_RESUME_SCRIPT, "save", ckpt_dir, full)["pending_at_snapshot"] > 0
    _run_script(_KILL_RESUME_SCRIPT, "resume", ckpt_dir, resumed)
    _same_npz(full, resumed)


_DOWNDATE_KILL_RESUME_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from repro_torch.core.svd_update import TruncatedSvd
    from repro_torch.serve import SvdService
    from repro_torch.updates import RemoveRows, Window

    mode, ckpt_dir, out_npz = sys.argv[1:4]
    rng = np.random.default_rng(9)
    M, N, R, S = 8, 10, 3, 3
    streams = [TruncatedSvd(
        torch.as_tensor(np.linalg.qr(rng.normal(size=(M, R)))[0]),
        torch.as_tensor(np.sort(np.abs(rng.normal(size=R)))[::-1].copy()),
        torch.as_tensor(np.linalg.qr(rng.normal(size=(N, R)))[0]),
    ) for _ in range(S)]
    pre = [rng.normal(size=(S, M)), rng.normal(size=(S, N))]
    post = [rng.normal(size=(S, 5)), rng.normal(size=(S, N))]

    def feed_pre(svc):
        for i in range(S):
            svc.enqueue(f"s{i}", pre[0][i], pre[1][i])
            svc.enqueue_op(f"s{i}", RemoveRows((1, 6)))
            svc.enqueue_op(f"s{i}", Window(5, lam=0.95))

    def feed_post(svc):
        for i in range(S):
            svc.enqueue(f"s{i}", post[0][i], post[1][i])

    if mode == "resume":
        step, svc = SvdService.restore(ckpt_dir, device="cpu")
        assert svc.pending() == 3 * S
        feed_post(svc)
        svc.drain()
    else:
        svc = SvdService(max_batch=64, max_in_flight=2)
        for i, t in enumerate(streams):
            svc.register(f"s{i}", t)
        feed_pre(svc)
        if mode == "save":
            svc.save(ckpt_dir, step=1)
            print(json.dumps({"pending": svc.pending()}))
            sys.exit(0)
        feed_post(svc)
        svc.drain()
    np.savez(out_npz, **{f"s{i}_{f}": getattr(svc.state(f"s{i}"), f).numpy()
                         for i in range(S) for f in ("u", "s", "v")})
    print(json.dumps({"ok": True, "shape": list(svc.state("s0").shape)}))
""")


def test_downdate_kill_and_resume_bitwise_across_processes(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    assert _run_script(_DOWNDATE_KILL_RESUME_SCRIPT, "full", ckpt_dir,
                       tmp_path / "full.npz")["shape"] == [5, 10]
    assert _run_script(_DOWNDATE_KILL_RESUME_SCRIPT, "save", ckpt_dir,
                       tmp_path / "full.npz")["pending"] == 9
    assert _run_script(_DOWNDATE_KILL_RESUME_SCRIPT, "resume", ckpt_dir,
                       tmp_path / "resumed.npz")["shape"] == [5, 10]
    _same_npz(tmp_path / "full.npz", tmp_path / "resumed.npz")


# -- the async double buffer -------------------------------------------------------------


@pytest.mark.parametrize("max_in_flight", [0, 1, 4])
def test_async_modes_bitwise_equal(max_in_flight):
    m, n, r, streams = 8, 10, 3, 4
    rng = np.random.default_rng(4)
    init = [_fresh(m, n, r, rng) for _ in range(streams)]
    events = _traffic(16, streams, m, n, rng)
    ids = [f"s{i}" for i in range(streams)]

    def run(mif):
        svc = SvdService(max_batch=streams, max_in_flight=mif)
        for sid, t in zip(ids, init):
            svc.register(sid, t)
        _feed(svc, events)
        svc.drain()
        return svc

    base = run(0)
    got = run(max_in_flight)
    assert got.stats.in_flight_peak <= max(max_in_flight, 0)
    _exact_states(base, got, ids)


def test_backpressure_bounds_in_flight():
    m, n, r, streams = 8, 10, 3, 4
    rng = np.random.default_rng(6)
    svc = SvdService(max_batch=streams, max_in_flight=1)
    for i in range(streams):
        svc.register(f"s{i}", _fresh(m, n, r, rng))
    _feed(svc, _traffic(streams * 6, streams, m, n, rng))
    svc.drain()
    assert svc.stats.in_flight_peak <= 1
    assert svc.in_flight() == 0
    with pytest.raises(ValueError, match="max_in_flight"):
        SvdService(max_in_flight=-1)


# -- snapshot v5: pending downdates ----------------------------------------------------


def test_snapshot_v5_downdate_pending_bitwise(tmp_path):
    m, n, r = 8, 10, 3

    def build():
        rng = np.random.default_rng(41)
        svc = SvdService(max_batch=16)
        svc.register("x", _fresh(m, n, r, np.random.default_rng(40)))
        svc.enqueue("x", rng.normal(size=m), rng.normal(size=n))
        svc.enqueue_op("x", RemoveRows((0, 5)))
        svc.enqueue_op("x", RemoveCols(2))
        svc.enqueue_op("x", Window(5, lam=0.9))
        svc.enqueue("x", rng.normal(size=5), rng.normal(size=n - 1))
        return svc

    ref_svc = build()
    svc = build()
    assert svc._effective_shape("x") == (5, n - 1)
    snap = svc.snapshot()
    assert snap.version == SNAPSHOT_VERSION == 7
    assert "".join(snap.pending_order) == "pooo" + "o"
    specs = json.dumps(snap.aux())
    assert "remove_rows" in specs and "window" in specs
    svc.save(tmp_path, step=1)
    _, restored = _restore(tmp_path)
    assert restored.pending("x") == ref_svc.pending("x")
    assert restored._effective_shape("x") == (5, n - 1)
    ref_svc.drain()
    restored.drain()
    assert restored.state("x").shape == (5, n - 1)
    _exact_states(ref_svc, restored, ["x"])
    assert restored.stats.ops_applied == ref_svc.stats.ops_applied == 3


def test_snapshot_v3_loads_as_v5():
    svc = SvdService(max_batch=4)
    svc.register("x", _fresh(6, 7, 2))
    svc.enqueue("x", np.zeros(6), np.zeros(7))
    svc.enqueue_op("x", Decay(0.9))
    old = dataclasses.replace(svc.snapshot(), version=3)
    restored = SvdService.from_snapshot(old, device="cpu")
    assert restored.pending("x") == 2
    restored.drain()
    assert torch.equal(restored.state("x").s, 0.9 * svc.state("x").s)


def test_snapshot_v3_aux_refuses_v5_and_loads_older(tmp_path):
    svc = SvdService(max_batch=4)
    svc.register("x", _fresh(6, 7, 2))
    old = dataclasses.replace(svc.snapshot(), version=3)
    old.save(tmp_path / "v3", step=1)
    _, loaded = ServiceSnapshot.load(tmp_path / "v3")
    assert tuple(loaded.states[0].u.shape) == (6, 2)
    fleet_stamped = dataclasses.replace(svc.snapshot(), version=8)
    fleet_stamped.save(tmp_path / "v8", step=1)
    with pytest.raises(ValueError, match="newer"):
        ServiceSnapshot.load(tmp_path / "v8")


def test_mesh_refuses_by_name(tmp_path):
    """A mesh must be a ``dist.Mesh``: anything else is a TypeError at the
    service and at restore; a ``dist.Mesh`` is taken by both (the mesh
    parity tests are in ``tests/test_torch_mesh.py``)."""
    from repro_torch.dist import make_host_mesh

    with pytest.raises(TypeError, match="Mesh"):
        SvdService(policy=api.UpdatePolicy(mesh=object()))
    svc = SvdService(max_batch=4)
    svc.register("x", _fresh(6, 7, 2))
    svc.save(tmp_path, step=1)
    with pytest.raises(TypeError, match="Mesh"):
        SvdService.restore(tmp_path, mesh=object(), device="cpu")
    mesh = make_host_mesh(2, device="cpu")
    _, back = SvdService.restore(tmp_path, mesh=mesh, device="cpu")
    assert back.policy.mesh == mesh
    assert dict(back.snapshot().policy_spec)["had_mesh"] is True


# -- parity with the reference service ---------------------------------------------------

M, NN, R, STREAMS = 16, 24, 4, 4


def _parity_inputs(seed, rounds=3):
    rng = np.random.default_rng(seed)
    init = [_fresh_np(M, NN, R, rng) for _ in range(STREAMS)]
    pairs = [(f"s{i % STREAMS}", rng.normal(size=M), rng.normal(size=NN))
             for i in range(rounds * STREAMS)]
    ops = {
        "rank_k": ("s0", RankK(rng.normal(size=(M, 2)), rng.normal(size=(NN, 2)))),
        "sparse": ("s1", Sparse(rng.integers(0, 2, 9).astype(np.int32),
                                rng.integers(0, NN, 9).astype(np.int32), rng.normal(size=9),
                                rank=2)),
        "append": ("s2", Compose((Decay(0.95), AppendRows(rng.normal(size=(2, NN)))))),
        "window": ("s3", Window(M - 2, lam=0.9)),
    }
    return init, pairs, ops


def _ref_op(op):
    """The reference's op of the same kind and data (numpy leaves)."""
    kind = type(op).__name__
    if kind == "Compose":
        return RU.Compose(tuple(_ref_op(c) for c in op.ops))
    fields = {f.name: getattr(op, f.name) for f in dataclasses.fields(op)}
    return getattr(RU, kind)(**fields)


def _services(method, seed, *, with_ops, max_batch=STREAMS, rounds=3):
    init, pairs, ops = _parity_inputs(seed, rounds)
    pol = dict(method=method)
    svc = SvdService(max_batch=max_batch, policy=api.UpdatePolicy(**pol))
    rsvc = RSERVE.SvdService(max_batch=max_batch, policy=RAPI.UpdatePolicy(**pol))
    for i, (u, s, v) in enumerate(init):
        svc.register(f"s{i}", api.SvdState.from_factors(u, s, v, device="cpu"))
        rsvc.register(f"s{i}", RAPI.SvdState(u=jnp.asarray(u), s=jnp.asarray(s),
                                             v=jnp.asarray(v)))
    for sid, a, b in pairs:
        svc.enqueue(sid, a, b)
        rsvc.enqueue(sid, jnp.asarray(a), jnp.asarray(b))
    if with_ops:
        for sid_op, op in ops.values():
            if method != "direct" and isinstance(op, Window):
                continue      # fused pairing on degenerate downdates: ROADMAP queue C
            svc.enqueue_op(sid_op, op)
            rsvc.enqueue_op(sid_op, _ref_op(op))
        # one more pair a stream, at its geometry after the queued ops
        rng = np.random.default_rng(seed + 1000)
        for i in range(STREAMS):
            m_eff, n_eff = svc._effective_shape(f"s{i}")
            a, b = rng.normal(size=m_eff), rng.normal(size=n_eff)
            svc.enqueue(f"s{i}", a, b)
            rsvc.enqueue(f"s{i}", jnp.asarray(a), jnp.asarray(b))
    return svc, rsvc


def _counts(svc) -> dict:
    """The stats that do not depend on timing (``in_flight_peak`` and
    ``backpressure_waits`` depend on when the device finishes a round)."""
    out = dataclasses.asdict(svc.stats)
    del out["in_flight_peak"], out["backpressure_waits"]
    return out


def _assert_parity(svc, rsvc):
    for sid in svc._streams:
        got, want = svc.state(sid), rsvc.state(sid)
        assert tuple(got.u.shape) == tuple(np.asarray(want.u).shape)
        for f in ("u", "s", "v"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       atol=PARITY_ATOL, rtol=0, err_msg=f"{sid}.{f}")


@pytest.mark.parametrize("method", ["direct", "pallas", "fused"])
def test_service_matches_reference(method):
    svc, rsvc = _services(method, 50 + len(method), with_ops=False)
    svc.drain()
    rsvc.drain()
    assert _counts(svc) == _counts(rsvc)
    _assert_parity(svc, rsvc)


@pytest.mark.parametrize("method", ["direct", "fused"])
def test_service_with_structured_events_matches_reference(method):
    svc, rsvc = _services(method, 60 + len(method), with_ops=True, max_batch=8)
    svc.drain()
    rsvc.drain()
    assert _counts(svc) == _counts(rsvc)
    _assert_parity(svc, rsvc)
    # the warmed sets, entry for entry
    assert svc.snapshot().warmed == rsvc.snapshot().warmed


def test_depth_batched_rounds_match_reference():
    svc, rsvc = _services("direct", 70, with_ops=False, max_batch=64, rounds=4)
    for s in (svc, rsvc):
        while s.pending():
            s.flush_round(max_depth=4)
        s.drain()
    assert svc.stats.scan_rounds == rsvc.stats.scan_rounds > 0
    _assert_parity(svc, rsvc)
    assert svc.snapshot().warmed == rsvc.snapshot().warmed


def _leaves_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_reference_snapshot_restores_in_port(tmp_path):
    """A snapshot the reference wrote (events pending) restores in the port
    with its leaves bitwise, and the port then finishes the traffic as the
    reference does (1e-10)."""
    svc, rsvc = _services("direct", 80, with_ops=True, max_batch=64)
    rsvc.save(tmp_path, step=3)
    ref_leaves = RCKPT.restore(tmp_path, None)[1]
    step, port = _restore(tmp_path)
    assert step == 3
    _leaves_equal(convert.snapshot_to_reference(port.snapshot())[0], ref_leaves)
    # the same through the in-memory conversion
    rsnap = rsvc.snapshot()
    psnap = convert.snapshot_from_reference([np.asarray(x) for x in jax.tree.leaves(rsnap)],
                                            rsnap.aux())
    _leaves_equal(convert.snapshot_to_reference(psnap)[0], ref_leaves)
    assert psnap.aux() == rsnap.aux()
    port.drain()
    rsvc.drain()
    _assert_parity(port, rsvc)


def test_port_snapshot_restores_in_reference(tmp_path):
    svc, rsvc = _services("direct", 81, with_ops=True, max_batch=64)
    svc.save(tmp_path, step=5)
    port_leaves = ckpt.restore(tmp_path, None)[1]
    step, back = RSERVE.SvdService.restore(tmp_path)
    assert step == 5
    _leaves_equal([np.asarray(x) for x in jax.tree.leaves(back.snapshot())], port_leaves)
    # in memory: the reference rebuilds its snapshot from the port's parts
    leaves, aux = convert.snapshot_to_reference(svc.snapshot())
    rs = RSERVE.ServiceSnapshot
    rsnap = jax.tree.unflatten(jax.tree.structure(rs.skeleton(aux)), leaves)
    _leaves_equal([np.asarray(x) for x in jax.tree.leaves(rsnap)], port_leaves)
    back.drain()
    svc.drain()
    _assert_parity(svc, back)


def test_restore_warms_the_warmed_set_through_the_engine(tmp_path):
    svc, _ = _services("direct", 82, with_ops=True, max_batch=8)
    svc.drain()
    svc.save(tmp_path, step=1)
    eng = default_engine("direct")
    eng.cache_clear()
    _, restored = _restore(tmp_path)
    warmed = {w for w in restored._warmed if w[0].startswith("trunc")}
    assert warmed and eng.cache_info().misses == len(warmed)
    for sid in ("s0", "s1"):
        restored.enqueue(sid, np.ones(restored.state(sid).m), np.ones(NN))
    restored.drain()
    assert eng.cache_info().misses == len(warmed)
