"""``repro_torch.models.encdec`` (the Whisper-style encoder-decoder) against
the reference.

The same numpy inputs, made from a seed, go through each reference function
and its port counterpart (parameters carried over by
``convert.params_from_reference``); whisper-base's smoke config (2 encoder
and 2 decoder layers, d 64, 4 heads).  Tolerances, relative to the largest
entry of the reference's output:

* the sinusoid: each entry within 4 float32 eps times (1 + position) (the
  two packages' ``exp`` round a frequency to neighbouring floats, an error
  the angle multiplies by the position: 6.1e-5 at position 1499, d 512);
* the train loss and its gradients against ``jax.value_and_grad``: the
  limits ``tests/test_torch_models.py`` holds the other families to (float32
  1e-5; bfloat16 compute, the frames in bf16, the loss 1e-4 and the
  gradients 2**-6), remat off, "full" and "dots" equal to the bit;
* prefill logits and caches, and three decode steps: 1e-5 (``F32``); under
  bf16 compute the caches' dtypes equal the reference's (the cross K/V in
  the frames' bf16, the self K/V in the activations' float32) and the
  values within 2**-6;
* the reference's own oracles (``tests/test_models.py``) on the port at
  their own limit (3e-4).

``generate`` raises the reference's ``TypeError`` (``encdec_prefill`` takes
``max_dec_len``, not ``max_len``) and ``train`` its ``KeyError: 'frames'``
(its data stream has no frames), in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import configs as PCFG
from repro_torch import convert
from repro_torch._tree import tree_flatten_with_names, tree_leaves
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.models import encdec as PED
from repro_torch.models import registry as PREG
from repro_torch.serve import engine as PENG
from repro_torch.train import loop as PLOOP

RCFG = ref("configs")
RBASE = ref("configs.base")
RED = ref("models.encdec")
RENG = ref("serve.engine")
RLOOP = ref("train.loop")
RREG = ref("models.registry")

ARCH = "whisper-base"
F32 = 1e-5
BF16 = 2.0 ** -6
MODEL = {"float32": {"loss": 1e-5, "grads": 1e-5},
         "bfloat16": {"loss": 1e-4, "grads": 2.0 ** -6}}
FORWARD = 3e-4
EPS32 = float(np.finfo(np.float32).eps)


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


def _inputs(cfg, b=2, s_enc=24, s_dec=16, seed=0, frames_dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"frames": (rng.normal(size=(b, s_enc, cfg.d_model)) * 0.02).astype(frames_dtype),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s_dec)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s_dec)).astype(np.int32)}


def _jbatch(batch, keys, cd="float32"):
    return {k: jnp.asarray(batch[k], jnp.dtype(cd) if k == "frames" else None) for k in keys}


def _pbatch(batch, keys, cd="float32"):
    out = {k: _t(batch[k]) for k in keys}
    if "frames" in out:
        out["frames"] = out["frames"].to(getattr(torch, cd))
    return out


@pytest.mark.parametrize("d", [64, 512])
def test_sinusoid(d):
    pos = np.arange(1500, dtype=np.int32)
    want = np.asarray(jax.jit(lambda p: RED._sinusoid(p, d))(jnp.asarray(pos)))
    got = PED._sinusoid(_t(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert (np.abs(got.numpy() - want) <= 4 * EPS32 * (1.0 + pos)[:, None]).all()


# -- train loss and gradients -------------------------------------------------------------


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_train_loss_and_grads(cd):
    rcfg, _ = _cfgs(compute_dtype=cd)
    rapi = RREG.build_model(rcfg)
    params = rapi.init(jax.random.PRNGKey(0))
    batch = _inputs(rcfg)
    keys = ("frames", "tokens", "labels")
    loss, grads = jax.jit(jax.value_and_grad(rapi.train_loss))(params, _jbatch(batch, keys, cd))
    runs = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        papi = PREG.build_model(PCFG.get_smoke(ARCH).replace(compute_dtype=cd, remat=remat,
                                                             remat_policy=policy))
        pp = _port(params)
        leaves = _leaves(pp)
        for x in leaves:
            x.requires_grad_(True)
        pl = papi.train_loss(pp, _pbatch(batch, keys, cd))
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
    """The port's init builds the reference's layout (names, shapes, dtypes:
    ``enc_layers`` and ``dec_layers`` stacked) and a first loss near
    ln(vocab)."""
    cfg = PCFG.get_smoke(ARCH)
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    want = RREG.build_model(RCFG.get_smoke(ARCH)).init(jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype)) for k, v in flat] == [
        (n, tuple(x.shape), str(x.dtype).removeprefix("torch."))
        for n, x in zip(*tree_flatten_with_names(params))]
    loss = api.train_loss(params, _pbatch(_inputs(cfg), ("frames", "tokens", "labels")))
    assert abs(float(loss) - np.log(cfg.vocab_size)) < 1.0


def test_params_round_trip_both_ways():
    params = RREG.build_model(RCFG.get_smoke(ARCH)).init(jax.random.PRNGKey(1))
    port = convert.params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    back = convert.tree_to_arrays(port)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)


# -- serving ------------------------------------------------------------------------------


def _served(rcfg, seed, *, max_dec_len, cd="float32"):
    """The reference's prefill of 8 decoder tokens over 24 frames and three
    jitted decode steps."""
    rapi = RREG.build_model(rcfg)
    params = rapi.init(jax.random.PRNGKey(seed))
    batch = _inputs(rcfg, s_dec=11, seed=seed)
    pre = jax.jit(lambda p, f, t: rapi.prefill(p, {"frames": f, "tokens": t},
                                               max_dec_len=max_dec_len))
    logits, cache = pre(params, jnp.asarray(batch["frames"], jnp.dtype(cd)),
                        jnp.asarray(batch["tokens"][:, :8]))
    step = jax.jit(rapi.decode_step)
    outs = [(logits, cache)]
    for i in range(8, 11):
        logits, cache = step(params, cache, jnp.asarray(batch["tokens"][:, i:i + 1]),
                             jnp.asarray(i, jnp.int32))
        outs.append((logits, cache))
    return params, batch, outs


def _port_served(pcfg, params, batch, max_dec_len, cd="float32"):
    api = PREG.build_model(pcfg)
    pp = _port(params)
    with torch.no_grad():
        logits, cache = api.prefill(pp, {"frames": _t(batch["frames"]).to(getattr(torch, cd)),
                                         "tokens": _t(batch["tokens"][:, :8])},
                                    max_dec_len=max_dec_len)
        got = [(logits, {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in cache.items()})]
        for i in range(8, 11):
            logits, cache = api.decode_step(pp, cache, _t(batch["tokens"][:, i:i + 1]), i)
            got.append((logits, {k: {kk: vv.clone() for kk, vv in v.items()}
                                 for k, v in cache.items()}))
    return got


@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa-self"])
def test_prefill_and_decode_match_reference(kvh):
    """Prefill (the self cache padded to 12) and three decode steps; with
    ``n_kv_heads`` 2 the self cache has 2 heads and the cross cache 4."""
    rcfg, pcfg = _cfgs(n_kv_heads=kvh)
    params, batch, outs = _served(rcfg, 2, max_dec_len=12)
    got = _port_served(pcfg, params, batch, 12)
    assert tuple(got[0][1]["self"]["k"].shape) == (2, 2, 12, kvh, 16)
    assert tuple(got[0][1]["cross"]["k"].shape) == (2, 2, 24, 4, 16)
    for (pl, pc), (rl, rc) in zip(got, outs):
        assert _rel(pl, rl) < F32
        assert jax.tree.structure(convert.cache_to_arrays(pc)) == jax.tree.structure(rc)
        for g, w in zip(_leaves(pc), jax.tree.leaves(rc)):
            assert tuple(g.shape) == w.shape and _rel(g, w) < F32


def test_cache_dtypes_follow_the_reference_under_bf16_compute():
    """bf16 frames: the memory and the cross K/V are bf16, the decoder's
    activations and self K/V float32 (f32 parameters), as the reference's."""
    rcfg, pcfg = _cfgs(compute_dtype="bfloat16")
    params, batch, outs = _served(rcfg, 3, max_dec_len=12, cd="bfloat16")
    got = _port_served(pcfg, params, batch, 12, cd="bfloat16")
    for (pl, pc), (rl, rc) in zip(got, outs):
        assert _dtypes(pc) == [str(x.dtype) for x in jax.tree.leaves(rc)] == \
            ["bfloat16", "bfloat16", "float32", "float32"]      # cross k, v; self k, v
        assert _rel(pl, rl) < BF16
        assert max(_rel(g, w) for g, w in zip(_leaves(pc), jax.tree.leaves(rc))) < BF16


def test_decode_writes_the_self_cache_in_place():
    """``decode_step`` returns the cache it was given, its tensors the same
    storage; only the self entries at ``pos`` move, the cross cache not at
    all.  A 0-dim tensor ``pos`` gives the int's bits."""
    cfg = PCFG.get_smoke(ARCH)
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(2), device="cpu")
    batch = _pbatch(_inputs(cfg, s_dec=9), ("frames", "tokens"))
    with torch.no_grad():
        _, cache = api.prefill(params, {"frames": batch["frames"],
                                        "tokens": batch["tokens"][:, :8]}, max_dec_len=12)
        twin = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in cache.items()}
        before = {(k, kk): vv.clone() for k, v in cache.items() for kk, vv in v.items()}
        ptrs = {(k, kk): vv.data_ptr() for k, v in cache.items() for kk, vv in v.items()}
        l1, out = api.decode_step(params, cache, batch["tokens"][:, 8:9], 8)
        l2, _ = api.decode_step(params, twin, batch["tokens"][:, 8:9],
                                torch.tensor(8, dtype=torch.int32))
    assert out is cache and torch.equal(l1, l2)
    for (k, kk), v in before.items():
        now = cache[k][kk]
        assert now.data_ptr() == ptrs[(k, kk)] and torch.equal(now, twin[k][kk])
        if k == "cross":
            assert torch.equal(now, v)
        else:
            moved = (now != v).any(dim=(0, 1, 3, 4))
            assert moved.nonzero().flatten().tolist() == [8]


def test_decode_from_zero_specs_matches_reference():
    """tests/test_models.py's decode smoke test, held to the reference: one
    step at position 3 from the zero cache of the decode specs."""
    rcfg, pcfg = _cfgs()
    rapi, papi = RREG.build_model(rcfg), PREG.build_model(pcfg)
    params = rapi.init(jax.random.PRNGKey(0))
    r_sp = rapi.input_specs(RBASE.ShapeConfig("d", 16, 2, "decode"))
    p_sp = papi.input_specs(ShapeConfig("d", 16, 2, "decode"))
    token = np.array([[5], [7]], np.int32)
    r_l, r_c = jax.jit(rapi.decode_step)(params, RREG.zeros_like_specs(r_sp["cache"]),
                                         jnp.asarray(token), jnp.asarray(3, jnp.int32))
    p_l, p_c = papi.decode_step(_port(params), PREG.zeros_like_specs(p_sp["cache"], device="cpu"),
                                _t(token), torch.tensor(3, dtype=torch.int32))
    assert _rel(p_l, r_l) < F32
    for got, want in zip(jax.tree.leaves(convert.cache_to_arrays(p_c)), jax.tree.leaves(r_c)):
        assert _rel(got, want) < F32


def test_cache_round_trip_and_decode_from_a_converted_cache():
    """``convert`` carries the {"self", "cross"} cache both ways (f32 and
    bf16 leaves, dtypes kept), and the port decodes from the reference's
    prefill cache as the reference does."""
    rcfg, pcfg = _cfgs()
    params, batch, outs = _served(rcfg, 4, max_dec_len=12)
    cache = outs[1][1]
    for tree in (cache, jax.tree.map(lambda x: x.astype(jnp.bfloat16), cache)):
        port = convert.cache_from_reference(jax.tree.map(np.asarray, tree), device="cpu")
        assert _dtypes(port) == [str(x.dtype) for x in jax.tree.leaves(tree)]
        back = convert.cache_to_arrays(port)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(jnp.asarray(got, want.dtype), want)
    pc = convert.cache_from_reference(jax.tree.map(np.asarray, cache), device="cpu")
    with torch.no_grad():
        p_l, _ = PREG.build_model(pcfg).decode_step(_port(params), pc,
                                                    _t(batch["tokens"][:, 9:10]), 9)
    assert _rel(p_l, outs[2][0]) < F32


def test_generate_raises_the_reference_type_error():
    """``encdec_prefill`` takes ``max_dec_len``: ``generate`` raises the
    reference's ``TypeError`` naming ``max_len`` in both packages."""
    rcfg, pcfg = _cfgs()
    rapi, papi = RREG.build_model(rcfg), PREG.build_model(pcfg)
    params = rapi.init(jax.random.PRNGKey(0))
    prompts = np.zeros((1, 4), np.int32)
    with pytest.raises(TypeError, match="unexpected keyword argument 'max_len'") as want:
        RENG.generate(rapi, params, jnp.asarray(prompts), RENG.ServeConfig(max_new_tokens=2))
    with pytest.raises(TypeError, match="unexpected keyword argument 'max_len'") as got:
        PENG.generate(papi, _port(params), _t(prompts), PENG.ServeConfig(max_new_tokens=2))
    assert str(got.value) == str(want.value) == \
        "encdec_prefill() got an unexpected keyword argument 'max_len'"


def test_train_raises_key_error_frames_in_both(tmp_path):
    """``train``'s data stream has tokens and labels only: both packages
    raise ``KeyError: 'frames'`` at the first step."""
    common = dict(steps=2, log_every=1, checkpoint_every=100, seed=0)
    with pytest.raises(KeyError, match="frames"):
        RLOOP.train(RBASE.RunConfig(model=RCFG.get_smoke(ARCH), checkpoint_dir=str(tmp_path / "r"),
                                    **common), batch_size=2, seq_len=16)
    with pytest.raises(KeyError, match="frames"):
        PLOOP.train(RunConfig(model=PCFG.get_smoke(ARCH), optimizer=OptimizerConfig(),
                              checkpoint_dir=str(tmp_path / "p"), **common),
                    batch_size=2, seq_len=16, device="cpu")


# -- the reference's own oracles on the port -------------------------------------------


def test_smoke_train_step_oracle():
    """tests/test_models.py::test_smoke_train_step: one fwd/bwd on the train
    specs (frames (2, 32, d), 64 decoder tokens), finite, loss ~ln(vocab)."""
    cfg = PCFG.get_smoke(ARCH)
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    specs = api.input_specs(ShapeConfig("train_small", 32, 2, "train"))["batch"]
    rng = np.random.default_rng(0)
    batch = {k: (torch.as_tensor(rng.integers(0, cfg.vocab_size, s.shape), dtype=torch.int32)
                 if s.dtype == torch.int32
                 else torch.as_tensor(rng.normal(size=s.shape) * 0.02, dtype=s.dtype))
             for k, s in specs.items()}
    assert tuple(batch["tokens"].shape) == (2, 64) and tuple(batch["frames"].shape) == (2, 32, 64)
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss = api.train_loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert 1.0 < float(loss.detach()) < 20.0
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_smoke_decode_step_oracle():
    cfg = PCFG.get_smoke(ARCH)
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    specs = api.input_specs(ShapeConfig("decode_small", 32, 2, "decode"))
    cache = PREG.zeros_like_specs(specs["cache"], device="cpu")
    token = torch.zeros(specs["token"].shape, dtype=torch.int32)
    with torch.no_grad():
        logits, cache2 = api.decode_step(params, cache, token, torch.tensor(3, dtype=torch.int32))
    assert logits.shape[0] == 2 and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    assert sorted(cache2) == ["cross", "self"] and all(sorted(v) == ["k", "v"] for v in cache2.values())


def test_prefill_decode_matches_forward_oracle():
    """tests/test_models.py::test_prefill_decode_matches_forward, the whisper
    case, on the port: frames (2, 16, d), prefill 8 tokens with max_dec_len
    16, one decode step, each against ``encdec_forward`` (3e-4)."""
    cfg = PCFG.get_smoke(ARCH)
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(17)
    toks = _t(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    frames = torch.as_tensor(rng.normal(size=(2, 16, cfg.d_model)) * 0.02, dtype=torch.float32)
    with torch.no_grad():
        full = PED.encdec_forward(params, {"frames": frames, "tokens": toks}, cfg)
        logits, cache = api.prefill(params, {"frames": frames, "tokens": toks[:, :8]},
                                    max_dec_len=16)
        torch.testing.assert_close(logits[:, -1], full[:, 7], rtol=FORWARD, atol=FORWARD)
        for i in range(8, 11):
            logits, cache = api.decode_step(params, cache, toks[:, i:i + 1], i)
            torch.testing.assert_close(logits[:, 0], full[:, i], rtol=FORWARD, atol=FORWARD)
