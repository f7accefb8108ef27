"""``repro_torch.optim`` against the reference's ``repro.optim``.

The same numpy inputs, made from a seed, go through each reference function
and its port counterpart, both starting from the reference's state carried
over by ``repro_torch.convert`` (``jax.random`` and ``torch.Generator`` draw
different bits).  Tolerances, all float32 unless said:

* the schedule: equal to the bit to the reference's jitted schedule (the
  learning rate its train step computes);
* AdamW, the spectral tracker, spectral-Adam and the compressor: 1e-5 of
  each array's largest entry after several steps (one float32 step differs
  by a few ulps: XLA and PyTorch sum in other orders);
* float64 compression and the single-worker agreement: 1e-10.

The behaviour tests of ``tests/test_optim.py`` and
``tests/test_spectral_adam.py`` (which fail to collect under jax 0.9, ROADMAP
A0) run here as oracles of the port.  ``compressed_allreduce`` and
``agree_basis`` across processes run in a gloo world of 2 through a file
store (``_torch_optim_worker.py``), held to a numpy model of the two factor
means.
"""

import functools

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

import _torch_optim_worker as W
from _torch_helpers import ref
from repro_torch import convert
from repro_torch.api import SvdState
from repro_torch.optim import adamw as PA
from repro_torch.optim import compression as PC
from repro_torch.optim import schedule as PSCH
from repro_torch.optim import spectral as PS
from repro_torch.optim import spectral_adam as PSA

RA = ref("optim.adamw")
RC = ref("optim.compression")
RSCH = ref("optim.schedule")
RS = ref("optim.spectral")
RSA = ref("optim.spectral_adam")
RSTATE = ref("api.state")

F32 = 1e-5
F64 = 1e-10
JOIN_TIMEOUT_S = 120


def _rel(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


# -- schedule -----------------------------------------------------------------


@pytest.mark.parametrize("lr,warmup,total", [(3e-4, 100, 10_000), (1e-3, 20, 100),
                                             (1.0, 10, 100), (1e-2, 0, 4), (2.5e-4, 7, 1000)])
def test_schedule_equal_to_the_bit(lr, warmup, total):
    steps = np.arange(0, total + 20, max(total // 500, 1), dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: RSCH.warmup_cosine(
        s, base_lr=lr, warmup_steps=warmup, total_steps=total))(jnp.asarray(steps)))
    got = np.array([PSCH.warmup_cosine(int(s), base_lr=lr, warmup_steps=warmup,
                                       total_steps=total).item() for s in steps], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_schedule_warmup_and_decay():
    """tests/test_optim.py::test_schedule_warmup_and_decay on the port."""
    lrs = [float(PSCH.warmup_cosine(s, base_lr=1.0, warmup_steps=10, total_steps=100))
           for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < 1.0
    assert lrs[4] >= 0.1 - 1e-6


# -- AdamW ----------------------------------------------------------------------


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e3])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(8, 6)).astype(np.float32),
              "n": {"b": rng.normal(size=(6,)).astype(np.float32)}}
    r_p, r_s = jax.tree.map(jnp.asarray, params), RA.adamw_init(jax.tree.map(jnp.asarray, params))
    p_p = convert.params_from_reference(params, device="cpu")
    p_s = convert.adamw_state_from_reference(_np(r_s), device="cpu")
    upd = jax.jit(lambda g, s, p, lr: RA.adamw_update(g, s, p, lr=lr, grad_clip=clip))
    for step in range(5):
        g = {"w": rng.normal(size=(8, 6)).astype(np.float32) * 3,
             "n": {"b": rng.normal(size=(6,)).astype(np.float32)}}
        lr = float(np.float32(1e-2 * (step + 1)))
        r_p, r_s, r_n = upd(jax.tree.map(jnp.asarray, g), r_s, r_p, jnp.float32(lr))
        p_p, p_s, p_n = PA.adamw_update(convert.params_from_reference(g, device="cpu"), p_s, p_p,
                                        lr=torch.tensor(lr, dtype=torch.float32), grad_clip=clip)
        assert int(p_s.step) == int(r_s.step) == step + 1
        assert p_s.step.device.type == "cpu" and p_s.step.dtype == torch.int32
        assert abs(float(p_n) - float(r_n)) <= F32 * float(r_n)
    for got, want in ((p_p, r_p), (p_s.m, r_s.m), (p_s.v, r_s.v)):
        assert _rel(got["w"], want["w"]) < F32
        assert _rel(got["n"]["b"], want["n"]["b"]) < F32


def test_port_state_goes_back_to_the_reference():
    """``convert.tree_to_arrays``: the port's AdamW state, its leaves in the
    port's order, unflattened into the reference's structure, runs the
    reference's update to the port's result."""
    from repro_torch.train.checkpoint import tree_leaves

    rng = np.random.default_rng(7)
    params = {"w": rng.normal(size=(5, 4)).astype(np.float32), "b": np.zeros(4, np.float32)}
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    p_p = convert.params_from_reference(params, device="cpu")
    p_p, p_s, _ = PA.adamw_update(convert.params_from_reference(grads, device="cpu"),
                                  PA.adamw_init(p_p), p_p, lr=1e-2)
    r_p = jax.tree.map(jnp.asarray, params)
    r_s = jax.tree.unflatten(jax.tree.structure(RA.adamw_init(r_p)),
                             tree_leaves(convert.tree_to_arrays(p_s)))
    assert int(r_s.step) == 1 and isinstance(r_s, RA.AdamWState)
    r_p = jax.tree.unflatten(jax.tree.structure(r_p), tree_leaves(convert.tree_to_arrays(p_p)))
    r_p2, r_s2, _ = RA.adamw_update(jax.tree.map(jnp.asarray, grads), r_s, r_p, lr=1e-2)
    p_p2, p_s2, _ = PA.adamw_update(convert.params_from_reference(grads, device="cpu"), p_s, p_p,
                                    lr=1e-2)
    assert _rel(p_p2["w"], r_p2["w"]) < F32 and _rel(p_s2.v["w"], r_s2.v["w"]) < F32


def test_adamw_optimizes_quadratic():
    """tests/test_optim.py::test_adamw_optimizes_quadratic on the port."""
    target = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 4)))
    params = {"w": torch.zeros((4, 4), dtype=torch.float64)}
    state = PA.adamw_init(params)
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = PA.adamw_update(grads, state, params, lr=5e-2, weight_decay=0.0)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-2


def test_adamw_grad_clip_reports_pre_clip_norm():
    params = {"w": torch.zeros(3)}
    state = PA.adamw_init(params)
    _, _, gnorm = PA.adamw_update({"w": torch.full((3,), 1e6)}, state, params, lr=1e-3,
                                  grad_clip=1.0)
    assert float(gnorm) > 1e5


# -- spectral tracker ---------------------------------------------------------


def _spec_pair(m, n, r, seed):
    st = RS.spectral_init(jax.random.PRNGKey(seed), m, n, r)
    return st, convert.spectral_state_from_reference(_np(st), device="cpu")


def _assert_spec_close(got, want, tol=F32):
    for f in ("u", "s", "v"):
        assert _rel(getattr(got.tracker, f), getattr(want.tracker, f)) < tol, f
    assert _rel(got.power_v, want.power_v) < tol
    assert int(got.step) == int(want.step)


def test_spectral_update_basis_matches_reference():
    """Six steps from a tracker of zero singular values (the reference's
    init), on the direct Brand route."""
    rng = np.random.default_rng(1)
    r_st, p_st = _spec_pair(32, 24, 3, 0)
    for _ in range(6):
        g = rng.normal(size=(32, 24)).astype(np.float32)
        r_st = RS.spectral_update_basis(r_st, jnp.asarray(g))
        p_st = PS.spectral_update_basis(p_st, torch.as_tensor(g))
    _assert_spec_close(p_st, r_st)


def test_spectral_update_basis_grouped_matches_reference():
    rng = np.random.default_rng(2)
    geos = [(32, 24, 3), (24, 40, 3), (32, 24, 3)]
    pairs = [_spec_pair(m, n, r, i) for i, (m, n, r) in enumerate(geos)]
    r_sts, p_sts = [p[0] for p in pairs], [p[1] for p in pairs]
    for _ in range(2):
        gs = [rng.normal(size=(m, n)).astype(np.float32) for m, n, _ in geos]
        r_sts = RS.spectral_update_basis_grouped(r_sts, [jnp.asarray(g) for g in gs])
        p_sts = PS.spectral_update_basis_grouped(p_sts, [torch.as_tensor(g) for g in gs])
    for got, want in zip(p_sts, r_sts):
        _assert_spec_close(got, want)
    # the grouped path equals the single path leaf by leaf
    one = PS.spectral_update_basis(pairs[0][1], torch.as_tensor(gs[0]))
    grouped = PS.spectral_update_basis_grouped([pairs[0][1]], [torch.as_tensor(gs[0])])[0]
    assert torch.equal(one.tracker.u, grouped.tracker.u)
    with pytest.raises(ValueError, match="geometry"):
        PS.spectral_update_basis_grouped([p_sts[0]], [torch.zeros(5, 5)])


def test_spectral_tracker_finds_dominant_subspace():
    """tests/test_optim.py::test_spectral_tracker_finds_dominant_subspace."""
    rng = np.random.default_rng(0)
    m, n, r = 32, 24, 4
    basis_u = np.linalg.qr(rng.normal(size=(m, 2)))[0]
    basis_v = np.linalg.qr(rng.normal(size=(n, 2)))[0]
    state = PS.spectral_init(torch.Generator().manual_seed(0), m, n, r, device="cpu")
    for _ in range(25):
        state = PS.spectral_update_basis(
            state, torch.as_tensor(basis_u @ rng.normal(size=(2, 2)) @ basis_v.T))
    g = torch.as_tensor(basis_u @ rng.normal(size=(2, 2)) @ basis_v.T, dtype=torch.float32)
    back = PS.unproject(state, PS.project(state, g))
    assert float(torch.linalg.norm(back - g) / torch.linalg.norm(g)) < 0.05


# -- spectral-Adam ------------------------------------------------------------


def _sa_grads(seed, m, n, steps):
    rng = np.random.default_rng(seed)
    rng.normal(size=(m, n))  # the initial weight's draw
    return [{"w": rng.normal(size=(m, n)).astype(np.float32),
             "b": rng.normal(size=(n,)).astype(np.float32)} for _ in range(steps)]


@functools.cache
def _sa_run(rank, refresh, steps, seed=1, m=64, n=40):
    """Both packages from the reference's init on the same gradients: the
    states after each step, ``[(r_params, r_state, p_params, p_state), ...]``."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(m, n)).astype(np.float32), "b": np.zeros((n,), np.float32)}
    r_p = jax.tree.map(jnp.asarray, params)
    r_s = RSA.spectral_adam_init(jax.random.PRNGKey(0), r_p, rank=rank)
    p_p = convert.params_from_reference(params, device="cpu")
    p_s = convert.spectral_adam_state_from_reference(_np(r_s), device="cpu")
    upd = jax.jit(lambda g, s, p: RSA.spectral_adam_update(g, s, p, lr=1e-2,
                                                           basis_refresh_every=refresh))
    history = []
    for g in _sa_grads(seed, m, n, steps):
        r_p, r_s = upd(jax.tree.map(jnp.asarray, g), r_s, r_p)
        p_p, p_s = PSA.spectral_adam_update(convert.params_from_reference(g, device="cpu"),
                                            p_s, p_p, lr=1e-2, basis_refresh_every=refresh)
        history.append((r_p, r_s, p_p, p_s))
    return history


@pytest.mark.parametrize("rank,refresh", [(4, 0), (2, 3)])
def test_spectral_adam_update_matches_reference(rank, refresh):
    """Without a refresh, and with one (rank 2, every 3 steps) where the
    trackers have no zero singular value left when it runs."""
    r_p, r_s, p_p, p_s = _sa_run(rank, refresh, 6)[-1]
    assert int(p_s.step) == int(r_s.step) == 6
    for k in ("w", "b"):
        assert _rel(p_p[k], r_p[k]) < F32
        assert _rel(p_s.leaves[k][0].m, r_s.leaves[k][0].m) < F32
    assert p_s.leaves["b"][0].spectral is None and r_s.leaves["b"][0].spectral is None
    _assert_spec_close(p_s.leaves["w"][0].spectral, r_s.leaves["w"][0].spectral)


def test_refresh_fixes_the_tracker_only_up_to_signs(monkeypatch):
    """A refresh re-factorises each tracker with an r x r SVD
    (``agree_tracker``), which fixes each singular vector pair only up to
    its sign, and the block of zero singular values only up to a rotation.
    The two packages' LAPACK calls, on inputs that differ by rounding, can
    choose differently, and spectral-Adam's moments, kept in the old basis's
    coordinates, are not invariant under that choice (ROADMAP queue C).
    Here the refresh at step 6 (rank 8, every 2 steps) flips two pairs:
    singular values, the pairs up to sign and the zero block up to a
    rotation agree, and the parameters differ far above F32.  Handing the
    port the reference's refreshed trackers at that step brings the
    parameters back within F32: the bases' freedom is the only difference."""
    r_p, r_s, p_p, p_s = _sa_run(8, 2, 6)[-1]
    rt, pt = r_s.leaves["w"][0].spectral.tracker, p_s.leaves["w"][0].spectral.tracker
    s = np.asarray(rt.s)
    live = s > 1e-3 * s[0]
    assert 0 < live.sum() < len(s)                       # a zero block exists
    assert _rel(pt.s[torch.as_tensor(live)], s[live]) < F32
    ru, pu = np.asarray(rt.u, np.float64), pt.u.numpy().astype(np.float64)
    cross = ru.T @ pu
    signs = np.diag(cross)[live]
    np.testing.assert_allclose(np.abs(signs), 1.0, atol=1e-4)             # pairs up to sign
    dead = cross[np.ix_(~live, ~live)]
    np.testing.assert_allclose(dead.T @ dead, np.eye(len(dead)), atol=1e-4)  # a rotation
    np.testing.assert_allclose(ru * s @ np.asarray(rt.v).T,                # the same matrix
                               pu * pt.s.numpy() @ pt.v.numpy().T, atol=1e-4 * s[0])
    assert (signs < 0).sum() == 2
    assert _rel(p_p["w"], r_p["w"]) > 100 * F32

    # the same run with the port's step-6 refresh replaced by the reference's
    ref_spec = convert.spectral_state_from_reference(_np(r_s.leaves["w"][0].spectral), device="cpu")
    calls = []

    def reference_refresh(specs, axis_name):
        calls.append(len(specs))
        return [ref_spec._replace(power_v=sp.power_v, step=sp.step) for sp in specs]

    _, _, p_p5, p_s5 = _sa_run(8, 2, 6)[-2]
    monkeypatch.setattr(PSA, "_refresh", reference_refresh)
    g = _sa_grads(1, 64, 40, 6)[-1]
    p_p6, _ = PSA.spectral_adam_update(convert.params_from_reference(g, device="cpu"), p_s5, p_p5,
                                       lr=1e-2, basis_refresh_every=2)
    assert calls == [1]
    assert _rel(p_p6["w"], r_p["w"]) < F32


def test_spectral_adam_optimizes_low_rank_quadratic():
    """tests/test_spectral_adam.py::test_spectral_adam_optimizes_low_rank_quadratic."""
    rng = np.random.default_rng(0)
    m, n, r = 128, 96, 8
    w_true = torch.as_tensor(rng.normal(size=(m, 4)) @ rng.normal(size=(4, n)), dtype=torch.float32)
    x = torch.as_tensor(rng.normal(size=(64, m)), dtype=torch.float32)
    y = x @ w_true
    params = {"w": torch.zeros((m, n)), "b": torch.zeros((n,))}

    def loss_and_grad(p):
        e = x @ p["w"] + p["b"] - y
        return float(torch.mean(e ** 2)), {"w": 2 * x.T @ e / e.numel(), "b": 2 * e.sum(0) / e.numel()}

    state = PSA.spectral_adam_init(torch.Generator().manual_seed(0), params, rank=r, device="cpu")
    l0 = loss_and_grad(params)[0]
    for _ in range(60):
        params, state = PSA.spectral_adam_update(loss_and_grad(params)[1], state, params, lr=3e-1,
                                                 weight_decay=0.0)
    l1 = loss_and_grad(params)[0]
    assert l1 < 0.2 * l0, f"{l0} -> {l1}"


def test_basis_refresh_keeps_tracker_orthonormal_and_descends():
    """tests/test_spectral_adam.py::test_basis_refresh_every_keeps_tracker_orthonormal_and_descends."""
    rng = np.random.default_rng(1)
    m, n, r = 96, 64, 4
    w_true = torch.as_tensor(rng.normal(size=(m, 3)) @ rng.normal(size=(3, n)), dtype=torch.float32)
    x = torch.as_tensor(rng.normal(size=(48, m)), dtype=torch.float32)
    y = x @ w_true
    params = {"w": torch.zeros((m, n))}

    def loss_and_grad(p):
        e = x @ p["w"] - y
        return float(torch.mean(e ** 2)), {"w": 2 * x.T @ e / e.numel()}

    state = PSA.spectral_adam_init(torch.Generator().manual_seed(0), params, rank=r, device="cpu")
    l0 = loss_and_grad(params)[0]
    for _ in range(40):
        params, state = PSA.spectral_adam_update(loss_and_grad(params)[1], state, params, lr=3e-1,
                                                 weight_decay=0.0, basis_refresh_every=5)
    assert loss_and_grad(params)[0] < 0.3 * l0
    tr = state.leaves["w"][0].spectral.tracker
    np.testing.assert_allclose((tr.u.T @ tr.u).numpy(), np.eye(r), atol=1e-4)
    np.testing.assert_allclose((tr.v.T @ tr.v).numpy(), np.eye(r), atol=1e-4)


def test_moment_memory_and_small_params():
    """tests/test_spectral_adam.py's memory and fall-through tests."""
    params = {"w": torch.zeros((4096, 4096)), "ln": torch.zeros((4096,))}
    assert PSA.moment_memory_ratio(params, rank=32) > 20
    r_params = {"w": jnp.zeros((4096, 4096)), "ln": jnp.zeros((4096,))}
    assert PSA.moment_memory_ratio(params, 32) == RSA.moment_memory_ratio(r_params, 32)
    state = PSA.spectral_adam_init(torch.Generator().manual_seed(0), {"tiny": torch.zeros((8, 8))},
                                   rank=8, device="cpu")
    assert state.leaves["tiny"][0].spectral is None


# -- compression -----------------------------------------------------------------


def _comp_pair(m, n, r, seed, dtype=jnp.float32):
    st = RC.compression_init(jax.random.PRNGKey(seed), m, n, r, dtype)
    return st, convert.compression_state_from_reference(_np(st), device="cpu")


def _assert_comp_close(got, want, tol, column_signs_free=False):
    """The basis and the error buffer, then the tracker: its singular values,
    its matrix, and the pairs of its nonzero singular values.  A pair of a
    zero singular value is free (it adds nothing to the matrix), and the two
    packages can return it with another sign (ROADMAP queue C).
    ``column_signs_free``: the live pairs too are held up to a sign each (a
    rank-k absorb takes its components from an eigh, whose eigenvector signs
    are free; a pair flipped in both factors is the same rank-1 term)."""
    assert _rel(got.v_basis, want.v_basis) < tol
    assert _rel(got.error, want.error) < tol
    gu, gs, gv = (getattr(got.tracker, f).numpy() for f in ("u", "s", "v"))
    wu, ws, wv = (np.asarray(getattr(want.tracker, f)) for f in ("u", "s", "v"))
    assert _rel(gs, ws) < tol
    rec = lambda u, s_, v: u * s_[..., None, :] @ np.swapaxes(v, -1, -2)  # noqa: E731
    assert _rel(rec(gu, gs, gv), rec(wu, ws, wv)) < tol
    live = ws > 1e-6 * ws.max(-1, keepdims=True)
    if column_signs_free:
        sign = np.sign(np.sum(gu * wu, axis=-2, keepdims=True))
        gu, gv = gu * sign, gv * sign
    for g_, w_ in ((gu, wu), (gv, wv)):
        assert _rel(np.where(live[..., None, :], g_, 0), np.where(live[..., None, :], w_, 0)) < tol


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32), (jnp.float64, F64)])
def test_compress_decompress_matches_reference(dtype, tol):
    rng = np.random.default_rng(3)
    r_st, p_st = _comp_pair(24, 16, 3, 0, dtype)
    for _ in range(3):
        g = rng.normal(size=(24, 16)).astype(np.dtype(dtype))
        r_gh, r_st = RC.compress_decompress(r_st, jnp.asarray(g))
        p_gh, p_st = PC.compress_decompress(p_st, torch.as_tensor(g))
        assert _rel(p_gh, r_gh) < tol
    _assert_comp_close(p_st, r_st, tol)
    assert isinstance(p_st.tracker, SvdState)


@pytest.mark.parametrize("tracker_rank", [1, 4])
def test_compress_decompress_batch_matches_reference(tracker_rank):
    rng = np.random.default_rng(4)
    pairs = [_comp_pair(20, 28, 4, i, jnp.float64) for i in range(3)]
    r_st = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs])
    p_st = PC._stack_states([p[1] for p in pairs])
    for _ in range(2):
        g = rng.normal(size=(3, 20, 28))
        r_gh, r_st = RC.compress_decompress_batch(r_st, jnp.asarray(g), tracker_rank=tracker_rank)
        p_gh, p_st = PC.compress_decompress_batch(p_st, torch.as_tensor(g),
                                                  tracker_rank=tracker_rank)
        assert _rel(p_gh, r_gh) < F64
    _assert_comp_close(p_st, r_st, F64, column_signs_free=tracker_rank > 1)
    if tracker_rank == 1:
        # two rank-1 absorbs leave each rank-4 tracker two zero singular
        # values, and the packages return some of their pairs with the other
        # sign: only there
        ws = np.asarray(r_st.tracker.s)
        dead = ws < 1e-6 * ws.max(-1, keepdims=True)
        flipped = np.sum(p_st.tracker.v.numpy() * np.asarray(r_st.tracker.v), axis=-2) < 0
        assert (flipped & dead).any() and not (flipped & ~dead).any()


def test_agree_tracker_and_basis_single_worker():
    """tests/test_dist_merge.py::test_agree_basis_single_worker (which waits
    for this slice), against the reference on the same tracker."""
    rng = np.random.default_rng(5)
    u, s, vt = np.linalg.svd(rng.normal(size=(10, 12)), full_matrices=False)
    tracker = (u[:, :4].copy(), s[:4].copy(), vt[:4].T.copy())
    r_st, p_st = _comp_pair(10, 12, 4, 0, jnp.float64)
    r_st = r_st._replace(tracker=RSTATE.SvdState(*(jnp.asarray(x) for x in tracker)))
    p_st = p_st._replace(tracker=SvdState(*(torch.as_tensor(x) for x in tracker)))
    r_out, p_out = RC.agree_basis(r_st, axis_name=None), PC.agree_basis(p_st, axis_name=None)
    _assert_comp_close(p_out, r_out, F64)
    np.testing.assert_allclose(p_out.v_basis.numpy(), tracker[2])
    pu, pv = p_out.tracker.u.numpy(), p_out.tracker.v.numpy()
    np.testing.assert_allclose(pu.T @ pu, np.eye(4), atol=1e-8)
    np.testing.assert_allclose(pv.T @ pv, np.eye(4), atol=1e-8)
    np.testing.assert_allclose(pu * p_out.tracker.s.numpy() @ pv.T,
                               tracker[0] * tracker[1] @ tracker[2].T, atol=1e-8)
    r_tr, _ = RC.agree_tracker(r_st.tracker, axis_name=None)
    p_tr, merged = PC.agree_tracker(p_st.tracker, axis_name=None)
    assert all(torch.equal(getattr(merged, f), getattr(p_st.tracker, f)) for f in ("u", "s", "v"))
    assert _rel(p_tr.u, r_tr.u) < F64 and _rel(p_tr.s, r_tr.s) < F64
    assert PC.refresh_basis(p_out).v_basis is p_out.tracker.v


def test_compression_error_feedback_converges():
    """tests/test_optim.py::test_compression_error_feedback_converges."""
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.normal(size=(24, 16)), dtype=torch.float32)
    state = PC.compression_init(torch.Generator().manual_seed(0), 24, 16, 2, device="cpu")
    acc = torch.zeros_like(g)
    for _ in range(60):
        g_hat, state = PC.compress_decompress(state, g)
        acc = acc + g_hat
    assert float(torch.linalg.norm(acc / 60 - g) / torch.linalg.norm(g)) < 0.1


def test_compression_exact_for_low_rank_grad():
    """tests/test_optim.py::test_compression_exact_for_low_rank_grad."""
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.normal(size=(30, 3)) @ rng.normal(size=(3, 20)), dtype=torch.float32)
    state = PC.compression_init(torch.Generator().manual_seed(1), 30, 20, 4, device="cpu")
    g_hat, state = PC.compress_decompress(state, g)
    assert float(torch.linalg.norm(g_hat - g) / torch.linalg.norm(g)) < 1e-5
    assert float(torch.linalg.norm(state.error)) < 1e-5 * float(torch.linalg.norm(g))


def test_wire_bytes_ratio():
    assert PC.wire_bytes(8192, 8192, 64) == RC.wire_bytes(8192, 8192, 64)
    assert PC.wire_bytes(8192, 8192, 64)["ratio"] > 60


# -- across processes --------------------------------------------------------------


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo_optim")
    init = f"file://{out / 'store'}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run, args=(r, 2, init, str(out))) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=JOIN_TIMEOUT_S)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(timeout=10)
    assert not alive, f"{len(alive)} of 2 gloo ranks did not finish in {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0, 0]
    results = []
    for r in range(2):
        with np.load(out / f"rank{r}.npz") as z:
            results.append({k: z[k] for k in z.files})
    return results


def _model_allreduce(key, m, n, seed):
    """A numpy model of one compressed round over both ranks: the factor
    means, the shared reconstruction and each rank's error buffer."""
    v0, _ = W.init_state(m, n, seed)
    gs = [W.grads(r)[key] for r in range(2)]
    p = np.mean([g @ v0 for g in gs], axis=0)
    p_hat = np.linalg.qr(p)[0]
    q = np.mean([g.T @ p_hat for g in gs], axis=0)
    g_hat = p_hat @ q.T
    return g_hat, [g - g_hat for g in gs]


def test_compressed_allreduce_across_two_processes(world2):
    for key, (m, n, seed) in {"a": (W.M, W.N, 1), "b": (W.M, W.N, 2), "c": (W.N, W.M, 3)}.items():
        g_hat, errs = _model_allreduce(key, m, n, seed)
        for r, res in enumerate(world2):
            assert _rel(res[f"g_{key}"], g_hat) < F64
            assert _rel(res[f"err_{key}"], errs[r]) < F64
        for f in ("g", "vb", "tr_{}_u", "tr_{}_s", "tr_{}_v"):
            name = f.format(key) if "{}" in f else f"{f}_{key}"
            np.testing.assert_array_equal(world2[0][name], world2[1][name])
    bias = np.mean([W.grads(r)["bias"] for r in range(2)], axis=0)
    for res in world2:
        np.testing.assert_allclose(res["g_bias"], bias, rtol=0, atol=1e-15)


def test_agree_basis_across_two_processes(world2):
    """Every rank ends with the same ``v_basis``: the right basis of the
    merged trackers, which the reference's single-process merge gives."""
    rmerge = ref("dist.merge")
    rtsvd = ref("core.svd_update").TruncatedSvd
    merged = rmerge.merge_tree([rtsvd(*(jnp.asarray(x) for x in W.tracker(r))) for r in range(2)],
                               rank=W.R)
    np.testing.assert_array_equal(world2[0]["agree_vb"], world2[1]["agree_vb"])
    vb = world2[0]["agree_vb"]
    np.testing.assert_allclose(np.abs(vb.T @ np.asarray(merged.v)), np.eye(W.R), atol=1e-8)
    rows = [W.tracker(r) for r in range(2)]
    for r, res in enumerate(world2):
        u, s, v = res["agree_u"], res["agree_s"], res["agree_v"]
        np.testing.assert_allclose(u.T @ u, np.eye(W.R), atol=1e-10)
        block = np.asarray(merged.u)[r * W.M:(r + 1) * W.M] * np.asarray(merged.s) @ np.asarray(merged.v).T
        np.testing.assert_allclose(u * s @ v.T, block, atol=1e-8)
        assert rows[r][0].shape == u.shape
