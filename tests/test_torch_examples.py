"""The port's four examples on the CPU against the JAX package.

Each ``examples/*_torch.py`` runs through its ``main(argv)`` with ``--device
cpu`` (its self-checks run inside and raise on failure), and its returned
figures are held to the reference on the same inputs:

* quickstart: the updated singular values against the reference's
  ``api.update(..., UpdatePolicy(method="fmm"))`` at 1e-12 of sigma_max (the
  FMM's tolerance, ``max(10 fmm_error_bound(20), 1e-13)``, is below it);
  Eq. 32's error below the reference's 1e-9 in both, and the two within
  1e-12 of each other (both are rounding, ~1e-14);
* streaming: part 1 with 20 events (auto: the fused route in both), its
  singular values against the reference's loop of ``api.update`` at 1e-9
  of the largest (float64; two implementations of the squared fused core
  summing in other orders over 20 steps read 1.4e-10, while the reference's
  own ``auto`` and ``direct`` routes part by 6.4e-7 on the same loop); the
  structured part against the reference's ``api.apply`` at 1e-10 of the
  largest singular value; the deletion part against the reference's
  ``SvdService`` at 1e-10 on the data's two live singular values (the other
  three are the downdates' noise floor, ~sqrt(eps) sigma_max, which two
  implementations round differently: ROADMAP queue C), and both within
  1e-8 of the dense truth; the restore part bitwise (the example
  asserts it) with the reference's round count; the obs part's span names,
  applied events and flush rounds equal to the reference example's;
* compressed_dp: a gloo world of 2 on the CPU, the full 300 steps, its two
  asserts, ``wire_bytes`` equal to the reference's, and the dense-DP
  weights against one-process full-batch gradient descent in float64 at
  1e-4 of the largest weight (the ranks run float32);
* train_lm: repro-tiny from the reference's init (a step-0 checkpoint in
  the shared layout), its losses against the reference's ``train`` on the
  same ``RunConfig`` at 1e-5 relative (float32, as ``test_torch_train``),
  and a run resumed at step 10 equal to the bit to an unbroken one at step
  30.  It runs 10 steps: over the first 4 the warmup's learning rate
  leaves the logged loss above the first batch's, in the reference too, and
  the example's own check requires a fall.
"""

from __future__ import annotations

import ast
import importlib
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_helpers import ref

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
sys.path.insert(0, str(EXAMPLES))

RAPI = ref("api")


def _example(name: str):
    return importlib.import_module(name)


def _rel(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------- quickstart


def test_quickstart_matches_reference():
    fig = _example("quickstart_torch").main(["--device", "cpu"])
    rng = np.random.default_rng(0)
    a_mat = rng.uniform(1, 9, size=(200, 300))
    a, b = rng.normal(size=200), rng.normal(size=300)
    out = RAPI.update(RAPI.SvdState.from_dense(a_mat), a, b, RAPI.UpdatePolicy(method="fmm"))
    recon = np.asarray(out.materialize())
    a_hat = a_mat + np.outer(a, b)
    err_ref = np.max(np.abs(a_hat - recon)) / np.linalg.svd(a_hat, compute_uv=False)[0]
    assert _rel(fig["s"], out.s) <= 1e-12
    assert fig["eq32_error"] < 1e-9 and err_ref < 1e-9
    assert abs(fig["eq32_error"] - err_ref) <= 1e-12
    assert fig["orthogonality"] < 1e-10


# ------------------------------------------------------------------ streaming


@pytest.fixture(scope="module")
def streaming():
    return _example("streaming_svd_torch")


def test_streaming_part1_matches_reference_loop(streaming):
    events = 20
    fig = streaming.stream_demo("cpu", events)
    rng = np.random.default_rng(0)
    m, n, r = streaming.M_USERS, streaming.N_ITEMS, streaming.RANK
    u_true, v_true = rng.normal(size=(m, 4)), rng.normal(size=(n, 4))
    t = RAPI.SvdState.from_factors(np.linalg.qr(rng.normal(size=(m, r)))[0], np.zeros((r,)),
                                   np.linalg.qr(rng.normal(size=(n, r)))[0])
    for _ in range(events):
        a = u_true @ rng.normal(size=4) + 0.1 * rng.normal(size=m)
        b = v_true @ rng.normal(size=4) + 0.1 * rng.normal(size=n)
        t = RAPI.update(t, jnp.asarray(a), jnp.asarray(b), RAPI.UpdatePolicy())
    assert _rel(fig["s"], t.s) <= 1e-9
    assert fig["dominant_rel_dev"] < 1e-6


def test_streaming_structured_matches_reference_apply(streaming):
    from repro.updates import AppendRows, Compose, Decay, RankK

    fig = streaming.structured_demo("cpu")
    rng = np.random.default_rng(2)
    m, n, r, k = 24, 32, 6, 3
    base = rng.normal(size=(m, 2)) @ rng.normal(size=(2, n))
    op = Compose((Decay(0.95),
                  RankK(jnp.asarray(rng.normal(size=(m, k)) / 10),
                        jnp.asarray(rng.normal(size=(n, k)) / 10)),
                  AppendRows(jnp.asarray(rng.normal(size=(2, 2)) / 10 @ rng.normal(size=(2, n))))))
    state = ref("updates.planner").apply(RAPI.SvdState.from_dense(jnp.asarray(base), rank=r), op)
    assert fig["shape"] == tuple(state.shape) == (m + 2, n)
    assert _rel(fig["s"], state.s) <= 1e-10
    assert fig["parity"] < 1e-8


def test_streaming_deletion_matches_reference_service(streaming):
    from repro.serve import SvdService
    from repro.updates import RemoveRows, Window

    fig = streaming.deletion_demo("cpu")
    rng = np.random.default_rng(3)
    m, n, r, events = 40, 32, 5, 12
    dense = rng.normal(size=(m, 2)) @ rng.normal(size=(2, n))
    svc = SvdService(max_batch=4)
    svc.register("tenant-0", RAPI.SvdState.from_dense(jnp.asarray(dense), rank=r))
    for _ in range(events):
        a = dense @ rng.normal(size=n)
        b = dense.T @ rng.normal(size=m)
        svc.enqueue("tenant-0", jnp.asarray(a * 0.02), jnp.asarray(b * 0.02))
        dense = dense + 0.02 * 0.02 * np.outer(a, b)
    svc.enqueue_op("tenant-0", RemoveRows((3, 17)))
    svc.enqueue_op("tenant-0", Window(30, lam=0.97))
    svc.drain()
    state = svc.state("tenant-0")
    assert fig["shape"] == tuple(state.shape) == (30, n)
    assert _rel(fig["s"][:2], np.asarray(state.s)[:2]) <= 1e-10
    truth = 0.97 * np.delete(dense, (3, 17), axis=0)[-30:]
    u, s, vt = np.linalg.svd(truth, full_matrices=False)
    ref_err = np.abs(np.asarray(state.materialize()) - (u[:, :r] * s[:r]) @ vt[:r]).max()
    assert fig["parity"] < 1e-8 and ref_err < 1e-8


def _reference_streaming():
    return importlib.import_module("streaming_svd")


def test_streaming_service_restores_bitwise(streaming, capsys):
    fig = streaming.service_demo("cpu")
    capsys.readouterr()
    _reference_streaming().service_demo()
    rounds = int(re.search(r"(\d+) batched flush rounds", capsys.readouterr().out).group(1))
    assert fig["bitwise"] and fig["rounds"] == rounds


CORE_SPANS = {"brand_residual", "core_update", "brand_rotate", "deflate", "secular_solve",
              "loewner", "givens", "cauchy_product"}


def test_streaming_obs_names_match_reference(streaming, capsys):
    fig = streaming.obs_demo("cpu")
    capsys.readouterr()
    _reference_streaming().obs_demo()
    line = capsys.readouterr().out
    spans = ast.literal_eval(re.search(r"spans (\[.*?\])", line).group(1))
    applied = float(re.search(r"applied=(\d+)", line).group(1))
    rounds = float(re.search(r"flush_rounds=(\d+)", line).group(1))
    # the port's phase chain has spans of its own, which fire on the service's
    # direct route; every other span is the reference's
    assert sorted(set(fig["spans"]) - CORE_SPANS) == spans
    assert (fig["applied"], fig["rounds"]) == (applied, rounds)
    assert fig["ortho_drift"] < 1e-6


def test_streaming_main_runs_every_part(streaming, capsys):
    out = streaming.main(["--device", "cpu", "--events", "4"])
    assert set(out) == {"stream", "service", "structured", "deletion", "obs"}
    assert capsys.readouterr().out.rstrip().endswith("OK")


# -------------------------------------------------------------- compressed_dp


def test_compressed_dp_world_of_two():
    ex = _example("compressed_dp_torch")
    fig = ex.main(["--device", "cpu", "--world", "2"])
    assert fig["wire_bytes"] == ref("optim.compression").wire_bytes(ex.M_IN, ex.M_HID, ex.RANK)
    assert fig["compressed_loss"] < 0.05 * fig["y_power"]
    assert fig["compressed_loss"] < 2.0 * fig["dense_loss"] + 1e-6
    # the dense run is full-batch gradient descent over the reference's data
    _, x_all, y_all = ex.data("cpu")
    x = x_all.reshape(-1, ex.M_IN).double().numpy()
    y = y_all.reshape(-1, ex.M_HID).double().numpy()
    w = np.zeros((ex.M_IN, ex.M_HID))
    for _ in range(ex.STEPS):
        w = w - ex.LR * 2.0 * x.T @ (x @ w - y) / y.size
    assert _rel(fig["w_dense"], w) <= 1e-4


# ------------------------------------------------------------------- train_lm


@pytest.fixture(scope="module")
def train_lm(tmp_path_factory):
    """The reference's init as a step-0 checkpoint, and the reference's own
    10-step run from it."""
    ex = _example("train_lm_torch")
    rreg, rck, ropt, rloop = (ref(m) for m in ("models.registry", "train.checkpoint",
                                               "optim.adamw", "train.loop"))
    rbase = ref("configs.base")
    init = tmp_path_factory.mktemp("init")
    args = ex.parse(["--steps", "10", "--ckpt-dir", str(init)])
    pcfg = ex.run_config(args)
    cfg = importlib.import_module("train_lm").model_for_scale(args.scale)   # the reference's
    params = rreg.build_model(cfg).init(jax.random.PRNGKey(0))
    rck.save(init, 0, (params, ropt.adamw_init(params)))
    rdir = tmp_path_factory.mktemp("ref")
    shutil.copytree(init, rdir, dirs_exist_ok=True)
    o = pcfg.optimizer
    run = rbase.RunConfig(model=cfg, optimizer=rbase.OptimizerConfig(
        lr=o.lr, warmup_steps=o.warmup_steps, total_steps=o.total_steps,
        spectral_rank=o.spectral_rank, basis_refresh_every=o.basis_refresh_every),
        steps=pcfg.steps, log_every=pcfg.log_every, checkpoint_every=pcfg.checkpoint_every,
        checkpoint_dir=str(rdir), seed=pcfg.seed)
    res = rloop.train(run, batch_size=args.batch, seq_len=args.seq)
    return ex, init, res


def _from(init, tmp_path_factory, name) -> str:
    d = tmp_path_factory.mktemp(name)
    shutil.copytree(init, d, dirs_exist_ok=True)
    return str(d)


def test_train_lm_matches_reference_and_resumes_bitwise(train_lm, tmp_path_factory):
    from repro_torch.train import checkpoint as PCK

    ex, init, r_res = train_lm
    broken = _from(init, tmp_path_factory, "broken")
    fig = ex.main(["--steps", "10", "--device", "cpu", "--ckpt-dir", broken])
    assert [s for s, _ in fig["losses"]] == [s for s, _ in r_res.losses] == [0, 9]
    np.testing.assert_allclose([v for _, v in fig["losses"]], [v for _, v in r_res.losses],
                               rtol=1e-5, atol=0)
    assert fig["last_loss"] < fig["first_loss"] and fig["final_step"] == 10

    resumed = ex.main(["--steps", "30", "--device", "cpu", "--ckpt-dir", broken])
    assert resumed["resumed_from"] == 10 and resumed["final_step"] == 30
    unbroken = _from(init, tmp_path_factory, "whole")
    whole = ex.main(["--steps", "30", "--device", "cpu", "--ckpt-dir", unbroken])
    assert resumed["losses"] == [x for x in whole["losses"] if x[0] >= 10]
    (s1, a), (s2, b) = PCK.restore(broken, None), PCK.restore(unbroken, None)
    assert s1 == s2 == 30 and len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_examples_default_to_the_card_and_import_no_jax():
    import subprocess

    code = ("import sys; sys.path.insert(0, 'examples'); "
            "import quickstart_torch, streaming_svd_torch, compressed_dp_torch, train_lm_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=EXAMPLES.parent, text=True,
                         capture_output=True, check=True).stdout
    assert out.strip() == "[]"
    if not torch.cuda.is_available():
        for name, argv in (("quickstart_torch", []), ("streaming_svd_torch", []),
                           ("compressed_dp_torch", []), ("train_lm_torch", ["--steps", "1"])):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                _example(name).main(argv)
