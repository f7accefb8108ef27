"""The port's serving modules, one by one, against the reference: the KV
cache (fp and int8), MLA's compressed cache, MoE, Mamba2's states, the
hybrid's prefill and decode, the spec functions, the cache converters, and
the port's own prefill + decode against its forward.

The same numpy inputs, made from a seed, go through each reference function
and its port counterpart (parameters carried over by
``convert.params_from_reference``); smoke configs, float32 compute.
Tolerances, relative to the largest entry of the reference's output:

* outputs, logits and float caches: 1e-5 (``F32``; the readings are 1e-7 to
  1e-6, the two packages summing in other orders);
* int8 cache entries: equal, except where the two float32 values straddle a
  rounding boundary of ``x / scale``, which moves an entry by one step: at
  most 1 apart, and at least 99 % equal; scales 1e-5;
* MoE routing decisions (indices, kept choices): equal;
* the port's prefill + decode against its own forward: 3e-4 absolute and
  relative, the reference's own limit (``tests/test_models.py``), with the
  MoE router made dropless as that test makes it.

The decode cache is written in place (the reference donates it): the tests
that reuse a cache give the port a ``clone()``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import configs as PCFG
from repro_torch import convert
from repro_torch.models import attention as PATT
from repro_torch.models import hybrid as PHY
from repro_torch.models import mla as PMLA
from repro_torch.models import moe as PMOE
from repro_torch.models import registry as PREG
from repro_torch.models import ssm as PSSM
from repro_torch.models import transformer as PTR

RCFG = ref("configs")
RATT = ref("models.attention")
RHY = ref("models.hybrid")
RMLA = ref("models.mla")
RMOE = ref("models.moe")
RREG = ref("models.registry")
RSSM = ref("models.ssm")
RTR = ref("models.transformer")

F32 = 1e-5
FORWARD = 3e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _port(tree):
    return convert.params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")


def _cfgs(arch, **kw):
    return RCFG.get_smoke(arch).replace(**kw), PCFG.get_smoke(arch).replace(**kw)


def _pos(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (b, s)).copy()


# -- the KV cache --------------------------------------------------------------------


@pytest.mark.parametrize("h,kvh,bias", [(4, 4, True), (4, 2, False), (4, 1, False)],
                         ids=["mha-bias", "gqa", "mqa"])
def test_attn_prefill_then_decode_fp(h, kvh, bias):
    rcfg, pcfg = _cfgs("granite-34b", n_heads=h, n_kv_heads=kvh, qkv_bias=bias, d_model=32)
    params = RATT.attn_init(jax.random.PRNGKey(3), rcfg, jnp.float32)
    pp = _port(params)
    x = _x((2, 12, 32), 1)
    r_out, r_cache = RATT.attn_prefill(jnp.asarray(x[:, :8]), params, rcfg, jnp.asarray(_pos(2, 8)))
    p_out, p_cache = PATT.attn_prefill(_t(x[:, :8]), pp, pcfg, _t(_pos(2, 8)))
    assert _rel(p_out, r_out) < F32
    for k in ("k", "v"):
        assert _rel(p_cache[k], r_cache[k]) < F32
    # decode 4 tokens from a cache padded to 12
    rc = {k: jnp.pad(v, ((0, 0), (0, 4), (0, 0), (0, 0))) for k, v in r_cache.items()}
    pc = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4)) for k, v in p_cache.items()}
    for i in range(8, 12):
        r_o, rc = RATT.attn_decode(jnp.asarray(x[:, i:i + 1]), params, rcfg, rc, i)
        p_o, pc = PATT.attn_decode(_t(x[:, i:i + 1]), pp, pcfg, pc, i)
        assert _rel(p_o, r_o) < F32, i
    for k in ("k", "v"):
        assert _rel(pc[k], rc[k]) < F32


@pytest.mark.parametrize("pos", [0, 3, 4, 7, -2, -9], ids=["0", "last", "sk", "sk+3", "negative",
                                                        "below-negative"])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_write_clamps_like_dynamic_update_slice(pos, as_tensor):
    """``_write`` into a cache of 4 slots equals the reference's
    ``lax.dynamic_update_slice_in_dim``, which clamps the start into
    [0, sk - 1]: at pos = sk and past it the entry overwrites the last slot
    (ROADMAP queue C, C1), for a Python and a 0-dim tensor ``pos``; a
    negative ``pos`` counts from the end first, as jax's index rule."""
    buf = np.zeros((2, 4, 3), np.float32)
    new = np.arange(1, 7, dtype=np.float32).reshape(2, 1, 3)
    want = jax.lax.dynamic_update_slice_in_dim(jnp.asarray(buf), jnp.asarray(new),
                                               jnp.asarray(pos, jnp.int32), axis=1)
    p = torch.tensor(pos, dtype=torch.int32) if as_tensor else pos
    got = PATT._write(_t(buf), _t(new), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encdec_first_decode_after_a_default_prefill():
    """``encdec_prefill``'s self cache is the prompt's own length by default,
    so the first decode step writes past its end: the reference overwrites
    the last slot (C1), and so does the port; logits and caches equal the
    reference's."""
    rcfg, pcfg = _cfgs("whisper-base")
    rapi, papi = RREG.build_model(rcfg), PREG.build_model(pcfg)
    params = rapi.init(jax.random.PRNGKey(21))
    rng = np.random.default_rng(22)
    frames = (rng.normal(size=(2, 12, rcfg.d_model)) * 0.02).astype(np.float32)
    toks = rng.integers(0, rcfg.vocab_size, (2, 9)).astype(np.int32)
    r_l, r_c = jax.jit(lambda p, f, t: rapi.prefill(p, {"frames": f, "tokens": t}))(
        params, jnp.asarray(frames), jnp.asarray(toks[:, :8]))
    r_l, r_c = jax.jit(rapi.decode_step)(params, r_c, jnp.asarray(toks[:, 8:]),
                                         jnp.asarray(8, jnp.int32))
    with torch.no_grad():
        _, p_c = papi.prefill(_port(params), {"frames": _t(frames), "tokens": _t(toks[:, :8])})
        assert tuple(p_c["self"]["k"].shape[2:3]) == (8,)
        p_l, p_c = papi.decode_step(_port(params), p_c, _t(toks[:, 8:]), 8)
    assert _rel(p_l, r_l) < F32
    for got, want in zip(jax.tree.leaves(convert.cache_to_arrays(p_c)), jax.tree.leaves(r_c)):
        assert got.shape == want.shape and _rel(got, want) < F32


def _int8_entries_agree(got, want):
    got, want = _np(got).astype(np.int64), np.asarray(want).astype(np.int64)
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= 0.99


def test_attn_decode_int8_entries_scales_and_outputs():
    rcfg, pcfg = _cfgs("qwen2-72b", kv_cache_dtype="int8")
    params = RATT.attn_init(jax.random.PRNGKey(4), rcfg, jnp.float32)
    pp = _port(params)
    rc = RATT.init_kv_cache(2, 10, rcfg, jnp.float32)
    pc = PATT.init_kv_cache(2, 10, pcfg, torch.float32, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in rc.items()} == \
        {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in pc.items()}
    x = _x((2, 10, rcfg.d_model), 2)
    for i in range(10):
        r_o, rc = RATT.attn_decode(jnp.asarray(x[:, i:i + 1]), params, rcfg, rc, i)
        p_o, pc = PATT.attn_decode(_t(x[:, i:i + 1]), pp, pcfg, pc, i)
        assert _rel(p_o, r_o) < F32, i
    for k in ("k", "v"):
        assert pc[k].dtype == torch.int8
        _int8_entries_agree(pc[k], rc[k])
        assert _rel(pc[k + "_scale"], rc[k + "_scale"]) < F32


def test_quantize_kv_rounds_half_to_even_like_the_reference():
    x = np.array([[[[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5, -127.0]]]], np.float32)
    rq, rs = RATT._quantize_kv(jnp.asarray(x))
    pq, ps = PATT._quantize_kv(_t(x))
    np.testing.assert_array_equal(_np(pq), np.asarray(rq))
    np.testing.assert_array_equal(_np(ps), np.asarray(rs))
    y = _x((2, 5, 3, 8), 5, 3.0)
    rq, rs = RATT._quantize_kv(jnp.asarray(y))
    pq, ps = PATT._quantize_kv(_t(y))
    _int8_entries_agree(pq, rq)
    assert _rel(ps, rs) < F32
    assert _rel(PATT._dequantize_kv(pq, ps, torch.float32),
                RATT._dequantize_kv(rq, rs, jnp.float32)) < 1e-2  # one int8 step


def test_int8_decode_into_a_float_cache_raises_in_both():
    """The reference's refusal, mirrored: ``attn_prefill`` returns float K/V
    with no scales, and an int8 config's decode writes int8 into them."""
    rcfg, pcfg = _cfgs("qwen2-72b", kv_cache_dtype="int8")
    params = RATT.attn_init(jax.random.PRNGKey(4), rcfg, jnp.float32)
    x = _x((2, 4, rcfg.d_model), 3)
    _, rc = RATT.attn_prefill(jnp.asarray(x), params, rcfg, jnp.asarray(_pos(2, 4)))
    _, pc = PATT.attn_prefill(_t(x), _port(params), pcfg, _t(_pos(2, 4)))
    with pytest.raises(TypeError, match="same dtypes, got float32, int8"):
        RATT.attn_decode(jnp.asarray(x[:, :1]), params, rcfg, rc, 3)
    with pytest.raises(TypeError, match="same dtypes, got float32, int8"):
        PATT.attn_decode(_t(x[:, :1]), _port(params), pcfg, pc, 3)


# -- MLA ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_chunk", [0, 4])
def test_mla_train_prefill_decode(q_chunk):
    rcfg, pcfg = _cfgs("deepseek-v2-lite-16b", mla_q_chunk=q_chunk)
    params = RMLA.mla_init(jax.random.PRNGKey(5), rcfg, jnp.float32)
    pp = _port(params)
    x = _x((2, 12, rcfg.d_model), 6)
    pos = _pos(2, 8)
    want = RMLA.mla_train(jnp.asarray(x[:, :8]), params, rcfg, jnp.asarray(pos))
    assert _rel(PMLA.mla_train(_t(x[:, :8]), pp, pcfg, _t(pos)), want) < F32
    r_o, r_c = RMLA.mla_prefill(jnp.asarray(x[:, :8]), params, rcfg, jnp.asarray(pos))
    p_o, p_c = PMLA.mla_prefill(_t(x[:, :8]), pp, pcfg, _t(pos))
    assert _rel(p_o, r_o) < F32
    for k in ("c_kv", "k_rope"):
        assert _rel(p_c[k], r_c[k]) < F32
    rc = RMLA.init_mla_cache(2, 12, rcfg, jnp.float32)
    pc = PMLA.init_mla_cache(2, 12, pcfg, torch.float32, device="cpu")
    rc = {k: v.at[:, :8].set(r_c[k]) for k, v in rc.items()}
    r_step = jax.jit(lambda x_, p_, c_, i_: RMLA.mla_decode(x_, p_, rcfg, c_, i_))
    for k in pc:
        pc[k][:, :8] = p_c[k]
    for i in range(8, 12):
        r_o, rc = r_step(jnp.asarray(x[:, i:i + 1]), params, rc, jnp.asarray(i, jnp.int32))
        p_o, pc = PMLA.mla_decode(_t(x[:, i:i + 1]), pp, pcfg, pc, i)
        assert _rel(p_o, r_o) < F32, i
    for k in ("c_kv", "k_rope"):
        assert _rel(pc[k], rc[k]) < F32


def test_mla_caches_k_rope_after_rope():
    """The shared RoPE key is cached rotated: position 0's entry equals the
    unrotated projection, later ones do not."""
    _, pcfg = _cfgs("deepseek-v2-lite-16b")
    params = _port(RMLA.mla_init(jax.random.PRNGKey(5), RCFG.get_smoke("deepseek-v2-lite-16b"),
                                 jnp.float32))
    x = _t(_x((1, 4, pcfg.d_model), 7))
    _, cache = PMLA.mla_prefill(x, params, pcfg, _t(_pos(1, 4)))
    raw = (x @ params["w_dkv"])[..., pcfg.mla.kv_lora_rank:]
    assert torch.allclose(cache["k_rope"][:, 0], raw[:, 0], atol=1e-6)
    assert not torch.allclose(cache["k_rope"][:, 3], raw[:, 3], atol=1e-3)


# -- MoE ---------------------------------------------------------------------------


def _moe_case(moe=None):
    rcfg, pcfg = _cfgs("deepseek-moe-16b")
    if moe:
        rcfg = rcfg.replace(moe=dataclasses.replace(rcfg.moe, **moe))
        pcfg = pcfg.replace(moe=dataclasses.replace(pcfg.moe, **moe))
    params = RMOE.moe_init(jax.random.PRNGKey(8), rcfg, jnp.float32)
    return rcfg, pcfg, params, _port(params)


@pytest.mark.parametrize("shape", [(2, 16), (8, 1)], ids=["prefill", "decode"])
def test_moe_apply_and_aux_loss(shape):
    rcfg, pcfg, params, pp = _moe_case()
    x = _x(shape + (rcfg.d_model,), 9)
    assert _rel(PMOE.moe_apply(_t(x), pp, pcfg)[0], RMOE.moe_apply(jnp.asarray(x), params, rcfg)) < F32
    assert _rel(PMOE.moe_aux_loss(_t(x), pp, pcfg),
                RMOE.moe_aux_loss(jnp.asarray(x), params, rcfg)) < F32


def test_moe_decode_batch_drops_like_the_reference():
    """A decode-shaped batch (b tokens, one group) at the published capacity
    factor and expert ratio: capacity max(1, int(1.25 * 8 * 6 / 64)) = 1, so
    colliding routed choices are dropped, by both packages alike."""
    rcfg, pcfg, params, pp = _moe_case({"n_routed": 64, "top_k": 6, "capacity_factor": 1.25})
    x = _x((8, 1, rcfg.d_model), 10)
    xg = _t(x).reshape(1, 8, -1)
    _, _, idx = PMOE._route(xg, pp["router"], pcfg.moe)
    onehot = PMOE._one_hot(idx, 64, torch.int32).reshape(1, 48, 64)
    pos = ((torch.cumsum(onehot, 1) - onehot) * onehot).sum(-1)
    assert int((pos >= 1).sum()) > 0                       # some choices collide and drop
    _, r_idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x).reshape(1, 8, -1) @ params["router"]), 6)
    np.testing.assert_array_equal(_np(idx), np.asarray(r_idx))
    assert _rel(PMOE.moe_apply(_t(x), pp, pcfg)[0], RMOE.moe_apply(jnp.asarray(x), params, rcfg)) < F32


def test_moe_ties_go_to_the_lower_index():
    """All-equal router probabilities (a zero input): ``lax.top_k`` takes the
    lowest indices, and so does the port."""
    rcfg, pcfg, params, pp = _moe_case()
    x = np.zeros((2, 4, rcfg.d_model), np.float32)
    _, _, idx = PMOE._route(_t(x), pp["router"], pcfg.moe)
    assert (_np(idx) == np.arange(pcfg.moe.top_k)).all()
    assert _rel(PMOE.moe_apply(_t(x), pp, pcfg)[0] + 1, RMOE.moe_apply(jnp.asarray(x), params, rcfg) + 1) < F32
    assert _rel(PMOE.moe_aux_loss(_t(x), pp, pcfg), RMOE.moe_aux_loss(jnp.asarray(x), params, rcfg)) < F32


# -- Mamba2 --------------------------------------------------------------------------


def test_ssm_train_final_state_and_decode():
    rcfg, pcfg = _cfgs("zamba2-7b")
    params = RSSM.ssm_init(jax.random.PRNGKey(11), rcfg, jnp.float32)
    pp = _port(params)
    x = _x((2, 32, rcfg.d_model), 12, 0.5)
    r_out, r_st = jax.jit(lambda x_, p_: RSSM.ssm_train(x_, p_, rcfg, return_final_state=True))(
        jnp.asarray(x), params)
    r_step = jax.jit(lambda x_, p_, s_: RSSM.ssm_decode(x_, p_, rcfg, s_))
    p_out, p_st = PSSM.ssm_train(_t(x), pp, pcfg, return_final_state=True)
    assert _rel(p_out, r_out) < F32
    for k in ("conv", "ssm"):
        assert _rel(p_st[k], r_st[k]) < F32
    assert p_st["ssm"].dtype == torch.float32
    y = _x((2, 3, rcfg.d_model), 13, 0.5)
    for i in range(3):
        r_o, r_st = r_step(jnp.asarray(y[:, i:i + 1]), params, r_st)
        p_o, p_st = PSSM.ssm_decode(_t(y[:, i:i + 1]), pp, pcfg, p_st)
        assert _rel(p_o, r_o) < F32, i
    for k in ("conv", "ssm"):
        assert _rel(p_st[k], r_st[k]) < F32


def test_ssm_decode_from_zero_state_matches_train():
    """tests/test_models.py's oracle on the port: the chunked training
    outputs equal the step-by-step decode outputs (2e-4 absolute, its limit)."""
    _, pcfg = _cfgs("zamba2-7b")
    pp = _port(RSSM.ssm_init(jax.random.PRNGKey(0), RCFG.get_smoke("zamba2-7b"), jnp.float32))
    x = _t(_x((2, 32, pcfg.d_model), 14, 0.1))
    y_train = PSSM.ssm_train(x, pp, pcfg)
    st = PSSM.init_ssm_state(2, pcfg, torch.float32, device="cpu")
    outs = []
    for t in range(32):
        y, st = PSSM.ssm_decode(x[:, t:t + 1], pp, pcfg, st)
        outs.append(y)
    assert float((torch.cat(outs, 1) - y_train).abs().max()) < 2e-4


# -- the hybrid ----------------------------------------------------------------------


def test_hybrid_prefill_and_decode_states():
    rcfg, pcfg = _cfgs("zamba2-7b")
    params = RHY.hybrid_init(jax.random.PRNGKey(15), rcfg)
    pp = _port(params)
    toks = np.random.default_rng(16).integers(0, rcfg.vocab_size, (2, 19)).astype(np.int32)
    r_l, r_s = jax.jit(lambda p, t: RHY.hybrid_prefill(p, {"tokens": t}, rcfg, max_len=20))(
        params, jnp.asarray(toks[:, :16]))
    r_step = jax.jit(lambda p, s, t, i: RHY.hybrid_decode_step(p, s, t, i, rcfg))
    p_l, p_s = PHY.hybrid_prefill(pp, {"tokens": _t(toks[:, :16])}, pcfg, max_len=20)
    assert _rel(p_l, r_l) < F32
    assert jax.tree.structure(r_s) == jax.tree.structure(convert.cache_to_arrays(p_s))
    for got, want in zip(jax.tree.leaves(convert.cache_to_arrays(p_s)), jax.tree.leaves(r_s)):
        assert got.shape == want.shape and _rel(got, want) < F32
    for i in range(16, 19):
        r_l, r_s = r_step(params, r_s, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(i, jnp.int32))
        p_l, p_s = PHY.hybrid_decode_step(pp, p_s, _t(toks[:, i:i + 1]), i, pcfg)
        assert _rel(p_l, r_l) < F32, i
    for got, want in zip(jax.tree.leaves(convert.cache_to_arrays(p_s)), jax.tree.leaves(r_s)):
        assert _rel(got, want) < F32


# -- the spec functions and the zero caches --------------------------------------------


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))


@pytest.mark.parametrize("arch,kv", [("qwen1.5-32b", None), ("qwen1.5-32b", "int8"),
                                     ("deepseek-v2-lite-16b", None), ("zamba2-7b", None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spec_functions_shapes_and_dtypes(arch, kv, dtype):
    rcfg, pcfg = _cfgs(arch, kv_cache_dtype=kv)
    if rcfg.ssm is not None:
        want = RHY.hybrid_state_spec(rcfg, 3, 20, jnp.dtype(dtype))
        got = PHY.hybrid_state_spec(pcfg, 3, 20, dtype)
    else:
        want = RTR.decode_cache_spec(rcfg, 3, 20, jnp.dtype(dtype))
        got = PTR.decode_cache_spec(pcfg, 3, 20, dtype)
    assert _shapes(got) == jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), want)
    zeros = PREG.zeros_like_specs(got, device="cpu")
    assert _shapes(zeros) == _shapes(got)


@pytest.mark.parametrize("arch", ["granite-34b", "deepseek-v2-lite-16b", "zamba2-7b"])
def test_decode_from_zero_specs_matches_reference(arch):
    """tests/test_models.py's decode smoke test, held to the reference: one
    step at position 3 from the zero cache of the decode specs."""
    rcfg, pcfg = _cfgs(arch)
    rapi, papi = RREG.build_model(rcfg), PREG.build_model(pcfg)
    params = rapi.init(jax.random.PRNGKey(0))
    shape = RCFG.ShapeConfig("d", 16, 2, "decode")
    r_sp = rapi.input_specs(shape)
    p_sp = papi.input_specs(PCFG.ShapeConfig("d", 16, 2, "decode"))
    token = np.array([[5], [7]], np.int32)
    r_l, r_c = jax.jit(rapi.decode_step)(params, RREG.zeros_like_specs(r_sp["cache"]),
                                         jnp.asarray(token), jnp.asarray(3, jnp.int32))
    p_l, p_c = papi.decode_step(_port(params), PREG.zeros_like_specs(p_sp["cache"], device="cpu"),
                                _t(token), torch.tensor(3, dtype=torch.int32))
    assert _rel(p_l[..., :pcfg.vocab_size], r_l[..., :rcfg.vocab_size]) < F32
    for got, want in zip(jax.tree.leaves(convert.cache_to_arrays(p_c)), jax.tree.leaves(r_c)):
        assert _rel(got, want) < F32


# -- caches carried over by convert ------------------------------------------------------


def _reference_caches():
    """One cache of each kind, from the reference: fp KV (bf16 too), int8
    KV with scales, MLA, and the hybrid state."""
    out = {}
    for arch, kv in (("qwen1.5-32b", None), ("qwen1.5-32b", "int8"),
                     ("deepseek-v2-lite-16b", None), ("zamba2-7b", None)):
        rcfg = RCFG.get_smoke(arch).replace(kv_cache_dtype=kv)
        rapi = RREG.build_model(rcfg)
        params = rapi.init(jax.random.PRNGKey(2))
        toks = jnp.asarray(np.random.default_rng(3).integers(0, 500, (2, 16)), jnp.int32)
        if kv == "int8":
            cache = RREG.zeros_like_specs(rapi.input_specs(RCFG.ShapeConfig("d", 20, 2, "decode"))["cache"])
            step = jax.jit(rapi.decode_step)
            for i in range(6):
                _, cache = step(params, cache, toks[:, i:i + 1], jnp.asarray(i, jnp.int32))
        else:
            _, cache = jax.jit(lambda p, t, a=rapi: a.prefill(p, {"tokens": t}, max_len=20))(
                params, toks)
        out[(arch, kv)] = (rcfg, params, cache)
    bf = out[("qwen1.5-32b", None)]
    out[("qwen1.5-32b", "bf16")] = (bf[0], bf[1], jax.tree.map(lambda c: c.astype(jnp.bfloat16), bf[2]))
    return out


@pytest.fixture(scope="module")
def reference_caches():
    return _reference_caches()


@pytest.mark.parametrize("case", [("qwen1.5-32b", None), ("qwen1.5-32b", "int8"),
                                  ("qwen1.5-32b", "bf16"), ("deepseek-v2-lite-16b", None),
                                  ("zamba2-7b", None)], ids=["fp", "int8", "bf16", "mla", "hybrid"])
def test_cache_round_trip_both_ways(reference_caches, case):
    _, _, cache = reference_caches[case]
    arrays = jax.tree.map(np.asarray, cache)
    port = convert.cache_from_reference(arrays, device="cpu")
    back = convert.cache_to_arrays(port)
    assert jax.tree.structure(back) == jax.tree.structure(cache)
    for got, want, p in zip(jax.tree.leaves(back), jax.tree.leaves(cache), jax.tree.leaves(
            jax.tree.map(lambda x: x, port, is_leaf=lambda x: isinstance(x, torch.Tensor)))):
        assert str(p.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_array_equal(jnp.asarray(got, want.dtype), want)   # port -> reference
    again = convert.cache_from_reference(back, device="cpu")                 # and back again
    for a, b in zip(jax.tree.leaves(convert.cache_to_arrays(again)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [("qwen1.5-32b", None), ("qwen1.5-32b", "int8"),
                                  ("deepseek-v2-lite-16b", None), ("zamba2-7b", None)],
                         ids=["fp", "int8", "mla", "hybrid"])
def test_decode_from_a_converted_reference_cache(reference_caches, case):
    rcfg, params, cache = reference_caches[case]
    pcfg = PCFG.get_smoke(case[0]).replace(kv_cache_dtype=case[1])
    pos = 6 if case[1] == "int8" else 16
    token = np.array([[11], [12]], np.int32)
    pc = convert.cache_from_reference(jax.tree.map(np.asarray, cache), device="cpu")
    r_l, _ = RREG.build_model(rcfg).decode_step(params, cache, jnp.asarray(token),
                                                jnp.asarray(pos, jnp.int32))
    p_l, _ = PREG.build_model(pcfg).decode_step(_port(params), pc, _t(token), pos)
    assert _rel(p_l, r_l) < F32


# -- the port's prefill + decode against its own forward -----------------------------------


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "granite-34b", "qwen2-72b", "deepseek-moe-16b",
                                  "deepseek-v2-lite-16b", "zamba2-7b"])
def test_prefill_decode_matches_forward(arch):
    """tests/test_models.py's consistency oracle on the port: prefill 8
    tokens, decode the next 3 one by one, each against the full causal
    forward over 16 tokens.  The MoE router is made dropless (capacity
    dropping depends on the batch's composition, GShard semantics)."""
    cfg = PCFG.get_smoke(arch)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_routed) / cfg.moe.top_k))
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(1), device="cpu")
    toks = _t(np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    fwd = PHY.hybrid_forward if cfg.ssm is not None else PTR.decoder_forward
    with torch.no_grad():
        full = fwd(params, {"tokens": toks}, cfg)
        logits, cache = api.prefill(params, {"tokens": toks[:, :8]}, max_len=16)
        torch.testing.assert_close(logits[:, -1], full[:, 7], rtol=FORWARD, atol=FORWARD)
        for i in range(8, 11):
            logits, cache = api.decode_step(params, cache, toks[:, i:i + 1], i)
            torch.testing.assert_close(logits[:, 0], full[:, i], rtol=FORWARD, atol=FORWARD)


# -- the in-place cache contract -----------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-72b", "deepseek-v2-lite-16b", "zamba2-7b"])
def test_decode_writes_the_cache_in_place(arch):
    """``decode_step`` returns the tree it was given, its tensors the same
    storage, with the entries at ``pos`` written and nothing else moved but
    the SSM states; a ``clone()`` taken before is untouched."""
    cfg = PCFG.get_smoke(arch)
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(2), device="cpu")
    toks = _t(np.random.default_rng(18).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32))
    with torch.no_grad():
        _, cache = api.prefill(params, {"tokens": toks[:, :16]}, max_len=20)
        before = {k: v.clone() for k, v in _flat(cache).items()}
        ptrs = {k: v.data_ptr() for k, v in _flat(cache).items()}
        _, out = api.decode_step(params, cache, toks[:, 16:17], 16)
    assert out is cache
    after = _flat(out)
    assert {k: v.data_ptr() for k, v in after.items()} == ptrs
    for k, v in after.items():
        if k.endswith("ssm") or k.endswith("conv"):
            assert not torch.equal(v, before[k]), k           # the SSM state moved
            continue
        moved = (v != before[k]).any(dim=tuple(i for i in range(v.dim()) if i != 2))
        assert moved.nonzero().flatten().tolist() == [16], k  # only the entry at pos


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {kk: vv for k, v in tree.items() for kk, vv in _flat(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}
