"""``repro_torch.models.rwkv`` and ``rwkv_model`` (RWKV-6) against the
reference.

The same numpy inputs, made from a seed, go through each reference function
and its port counterpart (parameters carried over by
``convert.params_from_reference``); rwkv6-1.6b's smoke config (2 layers, d
64, head 16, chunk 8).  Tolerances, relative to the largest entry of the
reference's output:

* the WKV in float64: the recurrence and the chunked form against the
  reference's, and the chunked form against the recurrence, 1e-12
  (``F64``; the readings are ~1e-16 to 1e-15), with a zero and a non-zero
  initial state; with planted strong decays, where the chunked form's clips
  at ``_LOGW_CLIP`` bind, the chunked form parts from the recurrence by
  O(1) in both packages and the two packages still agree at 1e-12; in
  float32, 1e-5 (``F32``);
* the train loss and its gradients against ``jax.value_and_grad``: the
  limits ``tests/test_torch_models.py`` holds the other families to (float32
  1e-5 of each gradient's largest entry, the loss 1e-5 relative; bfloat16
  compute the loss 1e-4 and the gradients 2**-6), remat off, "full" and
  "dots" equal to the bit;
* prefill logits and states, and three decode steps: 1e-5; under bf16
  compute (the decode specs' token shifts are bf16) the states' dtypes equal
  the reference's after a prefill and after a step from the specs' zeros,
  and the values within 2**-6;
* ``train.loop.train``: the losses and gradient norms at 1e-5 relative, the
  final parameters and AdamW moments at 1e-5 of each array's largest entry,
  as ``tests/test_torch_train.py`` holds the decoder;
* the reference's own oracles (``tests/test_models.py``) run on the port at
  their own limits (3e-4 for prefill + decode against the forward).
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import configs as PCFG
from repro_torch import convert
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.models import registry as PREG
from repro_torch.models import rwkv as PRW
from repro_torch.models import rwkv_model as PRM
from repro_torch.serve import engine as PENG
from repro_torch.train import checkpoint as PCK
from repro_torch.train import loop as PLOOP

RCFG = ref("configs")
RBASE = ref("configs.base")
RCK = ref("train.checkpoint")
RENG = ref("serve.engine")
RLOOP = ref("train.loop")
ROPT = ref("optim.adamw")
RREG = ref("models.registry")
RRW = ref("models.rwkv")

ARCH = "rwkv6-1.6b"
F64 = 1e-12
F32 = 1e-5
BF16 = 2.0 ** -6
MODEL = {"float32": {"loss": 1e-5, "grads": 1e-5},
         "bfloat16": {"loss": 1e-4, "grads": 2.0 ** -6}}
FORWARD = 3e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(x):
    return torch.as_tensor(np.array(x))


def _port(tree):
    return convert.params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _dtypes(tree):
    return [str(x.dtype).removeprefix("torch.") for x in _leaves(tree)]


def _cfgs(**kw):
    return RCFG.get_smoke(ARCH).replace(**kw), PCFG.get_smoke(ARCH).replace(**kw)


# -- the WKV -----------------------------------------------------------------------


def _wkv_inputs(seed, *, strong=False, state=True, dtype=np.float64):
    rng = np.random.default_rng(seed)
    b, l, h, dk = 2, 32, 3, 8
    r, k, v = (rng.normal(size=(b, l, h, dk)) for _ in range(3))
    # strong: 4-8 nats a step, so a chunk of 8 sums past _LOGW_CLIP (30)
    logw = -rng.uniform(4.0, 8.0, (b, l, h, dk)) if strong else -rng.uniform(0.01, 0.3, (b, l, h, dk))
    u = rng.normal(size=(h, dk))
    s0 = rng.normal(size=(b, h, dk, dk)) if state else np.zeros((b, h, dk, dk))
    return [a.astype(dtype) for a in (r, k, v, logw, u, s0)]


@pytest.mark.parametrize("state", [False, True], ids=["zero-state", "state"])
@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong-decay"])
def test_wkv_float64(strong, state):
    ins = _wkv_inputs(1, strong=strong, state=state)
    r_rec = RRW.wkv_recurrent(*map(jnp.asarray, ins))
    r_chk = RRW._wkv_chunked(*map(jnp.asarray, ins), chunk=8)
    p_rec = PRW.wkv_recurrent(*map(_t, ins))
    p_chk = PRW._wkv_chunked(*map(_t, ins), chunk=8)
    for got, want in ((p_rec, r_rec), (p_chk, r_chk)):
        for g, w in zip(got, want):
            assert g.dtype == torch.float64 and _rel(g, w) < F64
    parts = [_rel(p_chk[0], p_rec[0]), _rel(r_chk[0], r_rec[0])]
    if strong:   # the clips bind: the chunked form is not the recurrence, in either package
        assert min(parts) > 1e-3 and abs(parts[0] - parts[1]) < F64 * 1e3, parts
    else:
        assert max(parts) < F64, parts
        assert _rel(p_chk[1], p_rec[1]) < F64


@pytest.mark.parametrize("fn", ["wkv_recurrent", "_wkv_chunked"])
def test_wkv_float32(fn):
    ins = _wkv_inputs(2, dtype=np.float32)
    kw = {"chunk": 8} if fn == "_wkv_chunked" else {}
    want = getattr(RRW, fn)(*map(jnp.asarray, ins), **kw)
    got = getattr(PRW, fn)(*map(_t, ins), **kw)
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype) == "float32"
        assert _rel(g, w) < F32


def test_wkv_chunked_refuses_a_partial_chunk():
    """l % chunk != 0 raises, as the reference's reshape does (no padding)."""
    ins = _wkv_inputs(3)
    ins = [a[:, :30] if a.ndim == 4 and a.shape[1] == 32 else a for a in ins]
    with pytest.raises(TypeError, match="cannot reshape") as want:
        RRW._wkv_chunked(*map(jnp.asarray, ins), chunk=8)
    with pytest.raises(TypeError, match="cannot reshape") as got:
        PRW._wkv_chunked(*map(_t, ins), chunk=8)
    assert str(got.value) == str(want.value)


def test_rwkv_chunked_matches_recurrent_oracle():
    """tests/test_models.py::test_rwkv_chunked_matches_recurrent on the port:
    the chunked WKV equals the recurrence (atol 1e-10), f64."""
    rng = np.random.default_rng(0)
    b, l, h, dk = 2, 32, 3, 8
    r = rng.normal(size=(b, l, h, dk))
    k = rng.normal(size=(b, l, h, dk))
    v = rng.normal(size=(b, l, h, dk))
    logw = -rng.uniform(0.01, 0.3, size=(b, l, h, dk))
    u = rng.normal(size=(h, dk))
    s0 = rng.normal(size=(b, h, dk, dk))
    y_ref, s_ref = PRW.wkv_recurrent(*map(_t, (r, k, v, logw, u, s0)))
    y_chk, s_chk = PRW._wkv_chunked(*map(_t, (r, k, v, logw, u, s0)), chunk=8)
    np.testing.assert_allclose(y_chk.numpy(), y_ref.numpy(), atol=1e-10)
    np.testing.assert_allclose(s_chk.numpy(), s_ref.numpy(), atol=1e-10)


def test_time_and_channel_mix_blocks():
    """One block's time mix (train and decode) and channel mix, with carried
    token shifts and a non-zero wkv state, against the reference."""
    rcfg, pcfg = _cfgs()
    p = RRW.rwkv_init(jax.random.PRNGKey(4), rcfg, jnp.float32)
    pp = _port(p)
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 16, 64)) * 0.5).astype(np.float32)
    x_last = (rng.normal(size=(2, 64)) * 0.5).astype(np.float32)
    st = (rng.normal(size=(2, 4, 16, 16)) * 0.1).astype(np.float32)
    state = {"tm_x": x_last, "wkv": st, "cm_x": x[:, 3]}

    @jax.jit
    def reference(p, x, x_last, st, state):
        return (RRW.rwkv_time_mix_train(x, p, rcfg, x_last, st),
                RRW.rwkv_channel_mix_train(x, p, rcfg, x_last),
                RRW.rwkv_decode_step(x[:, :1], p, rcfg, state),
                RRW.rwkv_channel_mix_decode(x[:, :1], p, rcfg, state))

    (r_out, (r_xl, r_st)), (r_cm, r_cx), (r_o, r_s), (r_c, r_dx) = reference(
        p, jnp.asarray(x), jnp.asarray(x_last), jnp.asarray(st), jax.tree.map(jnp.asarray, state))
    p_out, (p_xl, p_st) = PRW.rwkv_time_mix_train(_t(x), pp, pcfg, _t(x_last), _t(st))
    assert _rel(p_out, r_out) < F32 and _rel(p_st, r_st) < F32 and _rel(p_xl, r_xl) == 0
    p_cm, p_cx = PRW.rwkv_channel_mix_train(_t(x), pp, pcfg, _t(x_last))
    assert _rel(p_cm, r_cm) < F32 and _rel(p_cx, r_cx) == 0
    p_state = {k: _t(v) for k, v in state.items()}
    p_o, p_s = PRW.rwkv_decode_step(_t(x[:, :1]), pp, pcfg, p_state)
    assert _rel(p_o, r_o) < F32
    for k in ("tm_x", "wkv", "cm_x"):
        assert _rel(p_s[k], r_s[k]) < F32, k
    p_c, p_dx = PRW.rwkv_channel_mix_decode(_t(x[:, :1]), pp, pcfg, p_state)
    assert _rel(p_c, r_c) < F32 and _rel(p_dx, r_dx) == 0


# -- the model: train loss and gradients --------------------------------------------


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_train_loss_and_grads(cd):
    rcfg, _ = _cfgs(compute_dtype=cd)
    rapi = RREG.build_model(rcfg)
    params = rapi.init(jax.random.PRNGKey(0))
    batch = _batch(rcfg)
    loss, grads = jax.jit(jax.value_and_grad(rapi.train_loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    runs = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        papi = PREG.build_model(PCFG.get_smoke(ARCH).replace(compute_dtype=cd, remat=remat,
                                                             remat_policy=policy))
        pp = _port(params)
        leaves = _leaves(pp)
        for x in leaves:
            x.requires_grad_(True)
        pl = papi.train_loss(pp, {k: _t(v) for k, v in batch.items()})
        runs.append((pl.detach(), torch.autograd.grad(pl, leaves)))
    pl, pg = runs[0]
    tol = MODEL[cd]
    assert _rel(pl, loss) < tol["loss"]
    errs = [_rel(g, r) for g, r in zip(pg, _leaves(grads))]
    assert max(errs) < tol["grads"], errs
    for other_loss, other_grads in runs[1:]:           # remat changes no bit
        assert torch.equal(other_loss, pl)
        assert all(torch.equal(a, b) for a, b in zip(other_grads, pg))


def test_init_layout_and_first_loss():
    """The port's init builds the reference's layout (names, shapes, dtypes)
    and a first loss near ln(vocab)."""
    cfg = PCFG.get_smoke(ARCH)
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    want = RREG.build_model(RCFG.get_smoke(ARCH)).init(jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype)) for k, v in flat] == [
        (n, tuple(x.shape), str(x.dtype).removeprefix("torch."))
        for n, x in zip(*_named(params))]
    loss = api.train_loss(params, {k: _t(v) for k, v in _batch(cfg, s=32).items()})
    assert abs(float(loss) - np.log(cfg.vocab_size)) < 1.0


def _named(tree):
    from repro_torch._tree import tree_flatten_with_names

    return tree_flatten_with_names(tree)


# -- serving: prefill, decode, states ----------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """The reference's prefill of 16 tokens and three jitted decode steps,
    at f32 compute."""
    rcfg, _ = _cfgs()
    rapi = RREG.build_model(rcfg)
    params = rapi.init(jax.random.PRNGKey(6))
    toks = np.random.default_rng(7).integers(0, rcfg.vocab_size, (2, 19)).astype(np.int32)
    logits, states = jax.jit(lambda p, t: rapi.prefill(p, {"tokens": t}))(params,
                                                                           jnp.asarray(toks[:, :16]))
    step = jax.jit(rapi.decode_step)
    outs = [(logits, states)]
    for i in range(16, 19):
        logits, states = step(params, states, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(i, jnp.int32))
        outs.append((logits, states))
    return params, toks, outs


def test_prefill_and_decode_match_reference(served):
    params, toks, outs = served
    api = PREG.build_model(PCFG.get_smoke(ARCH))
    pp = _port(params)
    with torch.no_grad():
        logits, states = api.prefill(pp, {"tokens": _t(toks[:, :16])})
        got = [(logits, states)]
        for i in range(16, 19):
            logits, states = api.decode_step(pp, states, _t(toks[:, i:i + 1]), i)
            got.append((logits, states))
    for (pl, ps), (rl, rs) in zip(got, outs):
        assert _rel(pl, rl) < F32
        assert jax.tree.structure(convert.cache_to_arrays(ps)) == jax.tree.structure(rs)
        for g, w in zip(_leaves(ps), jax.tree.leaves(rs)):
            assert tuple(g.shape) == w.shape and _rel(g, w) < F32


def test_decode_returns_a_new_state(served):
    """A decode step writes nothing into the state it is given; ``pos`` is
    ignored (a tensor or any int gives the same bits)."""
    params, toks, _ = served
    api = PREG.build_model(PCFG.get_smoke(ARCH))
    pp = _port(params)
    with torch.no_grad():
        _, states = api.prefill(pp, {"tokens": _t(toks[:, :16])})
        before = {k: v.clone() for k, v in states.items()}
        l1, s1 = api.decode_step(pp, states, _t(toks[:, 16:17]), 16)
        l2, s2 = api.decode_step(pp, states, _t(toks[:, 16:17]), torch.tensor(999, dtype=torch.int32))
    assert all(torch.equal(states[k], before[k]) for k in states)
    assert torch.equal(l1, l2) and all(torch.equal(s1[k], s2[k]) for k in s1)


def test_state_dtypes_follow_the_reference_under_bf16_compute():
    """The decode specs hold the token shifts in the compute dtype (bf16) and
    wkv in f32; a prefill's states and a step's are in the activations'
    dtype (f32 parameters): the dtypes equal the reference's at each point,
    the values within a bf16 ulp's reach."""
    rcfg, pcfg = _cfgs(compute_dtype="bfloat16")
    rapi, papi = RREG.build_model(rcfg), PREG.build_model(pcfg)
    params = rapi.init(jax.random.PRNGKey(8))
    pp = _port(params)
    toks = np.random.default_rng(9).integers(0, rcfg.vocab_size, (2, 17)).astype(np.int32)
    r_spec = rapi.input_specs(RBASE.ShapeConfig("d", 16, 2, "decode"))["cache"]
    p_spec = papi.input_specs(ShapeConfig("d", 16, 2, "decode"))["cache"]
    assert _dtypes(p_spec) == [str(s.dtype) for s in jax.tree.leaves(r_spec)] == \
        ["bfloat16", "bfloat16", "float32"]   # cm_x, tm_x, wkv
    r_l, r_s = jax.jit(lambda p, t: rapi.prefill(p, {"tokens": t}))(params, jnp.asarray(toks[:, :16]))
    r_l2, r_s2 = jax.jit(rapi.decode_step)(params, RREG.zeros_like_specs(r_spec),
                                           jnp.asarray(toks[:, 16:]), jnp.asarray(3, jnp.int32))
    with torch.no_grad():
        p_l, p_s = papi.prefill(pp, {"tokens": _t(toks[:, :16])})
        p_l2, p_s2 = papi.decode_step(pp, PREG.zeros_like_specs(p_spec, device="cpu"),
                                      _t(toks[:, 16:]), 3)
    for got, want in ((p_s, r_s), (p_s2, r_s2)):
        assert _dtypes(got) == [str(x.dtype) for x in jax.tree.leaves(want)] == ["float32"] * 3
        assert max(_rel(g, w) for g, w in zip(_leaves(got), jax.tree.leaves(want))) < BF16
    assert _rel(p_l, r_l) < BF16 and _rel(p_l2, r_l2) < BF16


def test_state_round_trip_both_ways(served):
    """``convert`` carries the stacked {tm_x, wkv, cm_x} state, and the
    layers' parameters, both ways, dtypes kept (bf16 shifts too)."""
    params, _, outs = served
    for tree in (outs[1][1], jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim == 3 else x,
                                          outs[1][1]), params):
        port = convert.cache_from_reference(jax.tree.map(np.asarray, tree), device="cpu")
        assert _dtypes(port) == [str(x.dtype) for x in jax.tree.leaves(tree)]
        back = convert.cache_to_arrays(port)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(jnp.asarray(got, want.dtype), want)


def test_decode_from_a_converted_reference_state(served):
    params, toks, outs = served
    pcfg = PCFG.get_smoke(ARCH)
    st = convert.cache_from_reference(jax.tree.map(np.asarray, outs[1][1]), device="cpu")
    with torch.no_grad():
        p_l, p_s = PREG.build_model(pcfg).decode_step(_port(params), st, _t(toks[:, 17:18]), 17)
    assert _rel(p_l, outs[2][0]) < F32
    for g, w in zip(_leaves(p_s), jax.tree.leaves(outs[2][1])):
        assert _rel(g, w) < F32


def test_generate_raises_the_reference_type_error():
    """``rwkv_prefill`` takes no ``max_len``: ``generate`` raises the
    reference's ``TypeError`` in both packages (ROADMAP queue C)."""
    rcfg, pcfg = _cfgs()
    rapi, papi = RREG.build_model(rcfg), PREG.build_model(pcfg)
    params = rapi.init(jax.random.PRNGKey(0))
    prompts = np.zeros((1, 8), np.int32)
    with pytest.raises(TypeError, match="unexpected keyword argument 'max_len'") as want:
        RENG.generate(rapi, params, jnp.asarray(prompts), RENG.ServeConfig(max_new_tokens=2))
    with pytest.raises(TypeError, match="unexpected keyword argument 'max_len'") as got:
        PENG.generate(papi, _port(params), _t(prompts), PENG.ServeConfig(max_new_tokens=2))
    assert str(got.value) == str(want.value)


# -- the reference's own oracles on the port -------------------------------------------


def test_smoke_train_step_oracle():
    """tests/test_models.py::test_smoke_train_step: one fwd/bwd on the train
    specs, finite, loss ~ln(vocab)."""
    cfg = PCFG.get_smoke(ARCH)
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    specs = api.input_specs(ShapeConfig("train_small", 32, 2, "train"))["batch"]
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, s.shape), dtype=torch.int32)
             for k, s in specs.items()}
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss = api.train_loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert 1.0 < float(loss.detach()) < 20.0
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_smoke_decode_step_oracle():
    """tests/test_models.py::test_smoke_decode_step: one step at pos 3 from
    the zero state of the decode specs; finite logits, the same structure."""
    cfg = PCFG.get_smoke(ARCH)
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    specs = api.input_specs(ShapeConfig("decode_small", 32, 2, "decode"))
    cache = PREG.zeros_like_specs(specs["cache"], device="cpu")
    token = torch.zeros(specs["token"].shape, dtype=torch.int32)
    with torch.no_grad():
        logits, cache2 = api.decode_step(params, cache, token, torch.tensor(3, dtype=torch.int32))
    assert logits.shape[0] == 2 and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    assert sorted(cache2) == sorted(cache) and all(cache2[k].shape == cache[k].shape for k in cache)


def test_prefill_decode_matches_forward_oracle():
    """tests/test_models.py::test_prefill_decode_matches_forward, the rwkv
    case, on the port: prefill 8 tokens, decode 3, each against the full
    forward over 16 (3e-4)."""
    cfg = PCFG.get_smoke(ARCH)
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(1), device="cpu")
    toks = _t(np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    with torch.no_grad():
        full = PRM.rwkv_forward(params, {"tokens": toks}, cfg)
        logits, states = api.prefill(params, {"tokens": toks[:, :8]})
        torch.testing.assert_close(logits[:, -1], full[:, 7], rtol=FORWARD, atol=FORWARD)
        for i in range(8, 11):
            logits, states = api.decode_step(params, states, toks[:, i:i + 1], i)
            torch.testing.assert_close(logits[:, 0], full[:, i], rtol=FORWARD, atol=FORWARD)


# -- train.loop.train ---------------------------------------------------------------------


BATCH, SEQ, STEPS = 2, 16, 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def test_train_matches_reference(tmp_path):
    """``train`` on the smoke config from the reference's init (a step-0
    checkpoint both packages resume from), 4 AdamW steps."""
    init = tmp_path / "init"
    params = RREG.build_model(RCFG.get_smoke(ARCH)).init(jax.random.PRNGKey(0))
    RCK.save(init, 0, (params, ROPT.adamw_init(params)))
    rd, pd = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(init, rd)
    shutil.copytree(init, pd)
    common = dict(steps=STEPS, log_every=1, checkpoint_every=100, seed=0)
    r_res = RLOOP.train(RBASE.RunConfig(model=RCFG.get_smoke(ARCH),
                                        optimizer=RBASE.OptimizerConfig(**OPT),
                                        checkpoint_dir=str(rd), **common),
                        batch_size=BATCH, seq_len=SEQ)
    p_res = PLOOP.train(RunConfig(model=PCFG.get_smoke(ARCH), optimizer=OptimizerConfig(**OPT),
                                  checkpoint_dir=str(pd), **common),
                        batch_size=BATCH, seq_len=SEQ, device="cpu")
    assert [s for s, _ in p_res.losses] == [s for s, _ in r_res.losses] == list(range(STEPS))
    np.testing.assert_allclose([v for _, v in p_res.losses], [v for _, v in r_res.losses],
                               rtol=F32, atol=0)
    np.testing.assert_allclose([g for _, g in p_res.grad_norms], [g for _, g in r_res.grad_norms],
                               rtol=F32, atol=0)
    (rs, r_leaves), (ps, p_leaves) = PCK.restore(rd, None), PCK.restore(pd, None)
    assert rs == ps == STEPS and len(r_leaves) == len(p_leaves)
    for a, b in zip(p_leaves, r_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float(np.abs(a.astype(np.float64) - b).max()) <= F32 * max(float(np.abs(b).max()), 1e-30)
