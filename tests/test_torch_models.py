"""``repro_torch.configs``, ``data``, ``models`` against the reference.

The same numpy inputs, made from a seed, go through each reference function
and its port counterpart (parameters carried over by
``convert.params_from_reference``):

* configs: every field of every arch's ``config()`` and ``smoke()``, the
  shapes and the run dataclasses' defaults: equal;
* the data stream: equal to the bit over many seeds and steps, steps near
  2**32 included;
* each function of ``models.layers``, each MLP and norm type, at 1e-6 of the
  output's largest entry in float32 (1e-6 relative: XLA and PyTorch sum and
  round elementwise functions in other orders, a few ulps);
* attention, full and blockwise, MHA, GQA and MQA, with and without
  ``qkv_bias``: 1e-6; in bfloat16 compute, the output and its gradients at
  one bf16 ulp of the largest entry (2**-7): the products are exact in
  float32, so the two sides part only where an operand rounds to the other
  bf16 neighbour (5.2e-4 at most, measured on the CPU);
* ``decoder_train_loss`` and its gradients (``torch.autograd`` against
  ``jax.value_and_grad``) at the dense smoke configs: 1e-5 relative to each
  gradient's largest entry, with remat off, "full" and "dots" equal to the
  bit to each other.  In bfloat16 compute: the loss at 1e-4 and the
  gradients at two bf16 ulps of each leaf's largest entry (2**-6).  A bf16
  rounding that one side takes to the other neighbour moves everything
  after it by a bf16 ulp, and the gradients are rounded to bf16 at every
  product, so the two sides part by up to one ulp (loss 1.4e-5, gradients
  7.4e-3, measured on the CPU); bf16 against f32 compute parts by 1.1e-2
  to 1.4e-2, so this bound holds the structure of the bf16 path (operands,
  transposes, which side is rounded), not each rounding;
* the same for the MoE (deepseek-moe-16b), MLA + MoE (deepseek-v2-lite-16b)
  and hybrid (zamba2-7b) smoke configs.  Two exceptions, each stated where
  it applies: XLA's CPU backend cannot run the reference's MoE and MLA
  einsums in bfloat16 (``_Bf16EinsumOnF32`` takes them on float32 upcasts,
  the card's arithmetic); and the hybrid's SSM decay parameters are sums
  with cancellation whose float32 value the reference itself moves by up to
  5e-6 of the leaf's largest entry between its jitted and its eager
  gradient (``tail.ssm.a_log``, measured on the CPU), so a hybrid leaf past
  1e-5 is held to 1e-5 plus that spread, measured in the test;
* every entry point's input specs (train, prefill, decode; fp and int8
  caches, MLA, hybrid, RWKV's state, whisper's frames and caches) equal to
  the reference's in shape and dtype, and the MoE, MLA and hybrid inits in
  the reference's layout; ``generate``'s refusal of RWKV and whisper (the
  reference's ``TypeError``) in both packages.

``tests/test_data_checkpoint.py``'s data tests run here as oracles of the
port; a test checks that the new modules import neither jax nor the
reference package.
"""

import ast
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import configs as PCFG
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import synthetic as PD
from repro_torch import convert
from repro_torch.models import attention as PATT
from repro_torch.models import layers as PL
from repro_torch.models import registry as PREG
from repro_torch.models import transformer as PTR
from repro_torch.serve import engine as PENG

RCFG = ref("configs")
RBASE = ref("configs.base")
RD = ref("data.synthetic")
RATT = ref("models.attention")
RL = ref("models.layers")
RREG = ref("models.registry")
RMOE = ref("models.moe")
RMLA = ref("models.mla")
RENG = ref("serve.engine")

F32_LAYER = 1e-6
F32_MODEL = 1e-5
BF16_LAYER = 2.0 ** -7
BF16_MODEL = {"loss": 1e-4, "grads": 2.0 ** -6}
DENSE = ("qwen1.5-32b", "nemotron-4-15b", "granite-34b", "qwen2-72b")
# the MoE, MLA (+ MoE) and hybrid families (train path; serving in
# tests/test_torch_decode.py and test_torch_serving.py)
SPARSE = ("deepseek-moe-16b", "deepseek-v2-lite-16b", "zamba2-7b")
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def _t(x):
    return torch.as_tensor(np.array(x))


# -- configs ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", RCFG.ARCH_IDS)
def test_configs_equal_field_by_field(arch):
    assert PCFG.ARCH_IDS == RCFG.ARCH_IDS
    for kind in ("get", "get_smoke"):
        want = dataclasses.asdict(getattr(RCFG, kind)(arch))
        got = dataclasses.asdict(getattr(PCFG, kind)(arch))
        assert got == want
    got, want = PCFG.get(arch), RCFG.get(arch)
    assert (got.head_dim, got.padded_vocab) == (want.head_dim, want.padded_vocab)


def test_shapes_cells_and_run_defaults_equal():
    assert {k: dataclasses.asdict(v) for k, v in PCFG.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RCFG.SHAPES.items()}
    assert PCFG.cells() == RCFG.cells()
    assert PCFG.LONG_CONTEXT_ARCHS == RCFG.LONG_CONTEXT_ARCHS
    assert dataclasses.asdict(PCFG.OptimizerConfig()) == dataclasses.asdict(RCFG.OptimizerConfig())
    for cls in ("MoEConfig", "MLAConfig", "SSMConfig", "RWKVConfig"):
        assert dataclasses.asdict(getattr(PCFG, cls)()) == dataclasses.asdict(getattr(RCFG, cls)())
    run_p = PCFG.RunConfig(model=PCFG.get_smoke("granite-34b"))
    run_r = RCFG.RunConfig(model=RCFG.get_smoke("granite-34b"))
    assert dataclasses.asdict(run_p) == dataclasses.asdict(run_r)
    with pytest.raises(KeyError, match="unknown arch"):
        PCFG.get("gpt-5")


# -- data -------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,batch,seq,vocab", [
    (0, 0, 4, 16, 64), (3, 5, 8, 16, 50), (123456789, 2**32 - 3, 3, 9, 49152),
    (2**32 - 1, 2**31 + 7, 2, 33, 2), (7, 2**32 + 5, 5, 12, 1), (1, 17, 8, 32, 100),
    (11, 999_999, 16, 128, 2048), (2**31, 2**32 - 1, 1, 4096, 49152)])
def test_data_equal_to_the_bit(seed, step, batch, seq, vocab):
    want = RD.batch_for_step(seed, step, batch=batch, seq=seq, vocab=vocab)
    got = PD.batch_for_step(seed, step, batch=batch, seq=seq, vocab=vocab, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_data_many_seeds_and_steps_equal_to_the_bit():
    for seed in range(0, 40, 7):
        for step in (0, 1, 2, 1000, 2**20 + 3, 2**32 - 2):
            want = RD.batch_for_step(seed, step, batch=3, seq=8, vocab=97)
            got = PD.batch_for_step(seed, step, batch=3, seq=8, vocab=97, device="cpu")
            np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


def test_data_oracles():
    """tests/test_data_checkpoint.py's data tests on the port."""
    a = PD.batch_for_step(0, 17, batch=8, seq=32, vocab=100, device="cpu")
    b = PD.batch_for_step(0, 17, batch=8, seq=32, vocab=100, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])                    # restart-exact
    c = PD.batch_for_step(0, 2, batch=8, seq=32, vocab=100, device="cpu")
    d = PD.batch_for_step(0, 1, batch=8, seq=32, vocab=100, device="cpu")
    assert not torch.equal(c["tokens"], d["tokens"])                # steps differ
    full = PD.batch_for_step(3, 5, batch=8, seq=16, vocab=50, device="cpu")
    parts = [PD.host_slice_for_step(3, 5, batch=8, seq=16, vocab=50, rank=r, world=4,
                                    device="cpu") for r in range(4)]
    assert torch.equal(torch.cat([p["tokens"] for p in parts]), full["tokens"])
    e = PD.batch_for_step(0, 0, batch=4, seq=16, vocab=64, device="cpu")
    assert tuple(e["tokens"].shape) == tuple(e["labels"].shape) == (4, 16)
    assert int(e["tokens"].max()) < 64
    assert torch.equal(e["tokens"][:, 1:], e["labels"][:, :-1])     # labels are shifted tokens


def test_data_refuses_a_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PD.batch_for_step(0, 0, batch=1, seq=4, vocab=8)


# -- layers -----------------------------------------------------------------------


@functools.cache
def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_norms():
    x, w, b = _x((2, 5, 16)), _x((16,), 1), _x((16,), 2)
    assert _rel(PL.rmsnorm(_t(x), _t(w)), RL.rmsnorm(jnp.asarray(x), jnp.asarray(w))) < F32_LAYER
    assert _rel(PL.layernorm(_t(x), _t(w), _t(b)),
                RL.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))) < F32_LAYER
    for nt in ("rmsnorm", "layernorm"):
        p = {"w": w, "b": b} if nt == "layernorm" else {"w": w}
        got = PL.norm_apply(_t(x), {k: _t(v) for k, v in p.items()}, nt)
        want = RL.norm_apply(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, nt)
        assert _rel(got, want) < F32_LAYER
        init = PL.norm_init(16, nt, "float32", "cpu")
        assert sorted(init) == sorted(RL.norm_init(16, nt, jnp.float32))


@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2", "gelu"])
def test_mlp(mlp_type):
    params = RL.mlp_init(jax.random.PRNGKey(1), 16, 40, mlp_type, jnp.float32)
    x = _x((2, 7, 16))
    got = PL.mlp_apply(_t(x), convert.params_from_reference(jax.tree.map(np.asarray, params),
                                                            device="cpu"), mlp_type, "float32")
    want = RL.mlp_apply(jnp.asarray(x), params, mlp_type, jnp.float32)
    assert _rel(got, want) < F32_LAYER
    ported = PL.mlp_init(torch.Generator().manual_seed(0), 16, 40, mlp_type, "float32")
    assert {k: tuple(v.shape) for k, v in ported.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}


def test_rope_embed_unembed_cross_entropy():
    x = _x((2, 9, 3, 8))
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    assert _rel(PL.rope_freqs(8, 10_000.0), RL.rope_freqs(8, 10_000.0)) < F32_LAYER
    assert _rel(PL.rope_apply(_t(x), _t(pos), 10_000.0),
                RL.rope_apply(jnp.asarray(x), jnp.asarray(pos), 10_000.0)) < F32_LAYER
    table = _x((50, 8), 3)
    toks = np.random.default_rng(4).integers(0, 50, (2, 9)).astype(np.int32)
    np.testing.assert_array_equal(PL.embed_lookup(_t(toks), {"table": _t(table)}).numpy(),
                                  np.asarray(RL.embed_lookup(jnp.asarray(toks),
                                                             {"table": jnp.asarray(table)})))
    h = _x((2, 9, 8), 5)
    assert _rel(PL.unembed(_t(h), {"table": _t(table)}, "float32"),
                RL.unembed(jnp.asarray(h), {"table": jnp.asarray(table)}, jnp.float32)) < F32_LAYER
    logits = _x((2, 9, 50), 6) * 4
    assert _rel(PL.cross_entropy(_t(logits), _t(toks), 50),
                RL.cross_entropy(jnp.asarray(logits), jnp.asarray(toks), 50)) < F32_LAYER


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_dot_and_its_backward(cd):
    """``dot`` in a compute dtype with float32 output, and its gradients: the
    reference's transpose rule (float32 cotangent x compute-dtype operand,
    rounded to the compute dtype).  bf16 products are exact in float32, so
    the bf16 forward holds the float32 tolerance too; its gradients are
    bf16-rounded, so they are held to bf16's half ulp, 2**-8."""
    x, w, gy = _x((3, 5, 16)), _x((16, 12), 1), _x((3, 5, 12), 2)
    jcd = jnp.dtype(cd)
    want, vjp = jax.vjp(lambda a, b: RL.dot(a, b, jcd), jnp.asarray(x), jnp.asarray(w))
    wx, ww = vjp(jnp.asarray(gy))
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    got = PL.dot(xt, wt, cd)
    assert got.dtype == torch.float32
    assert _rel(got, want) < F32_LAYER
    gx, gw = torch.autograd.grad(got, (xt, wt), _t(gy))
    tol = F32_LAYER if cd == "float32" else 2.0 ** -8
    assert _rel(gx, wx) < tol and _rel(gw, ww) < tol


# -- attention ----------------------------------------------------------------------


def _attn_cfg(h, kvh, bias, block):
    return (RCFG.get_smoke("granite-34b").replace(n_heads=h, n_kv_heads=kvh, qkv_bias=bias,
                                                  attn_block_k=block, d_model=32),
            PCFG.get_smoke("granite-34b").replace(n_heads=h, n_kv_heads=kvh, qkv_bias=bias,
                                                  attn_block_k=block, d_model=32))


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (4, 1)], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("block", [0, 4])
def test_attention_train(h, kvh, bias, block):
    rcfg, pcfg = _attn_cfg(h, kvh, bias, block)
    params = RATT.attn_init(jax.random.PRNGKey(2), rcfg, jnp.float32)
    if bias:
        rng = np.random.default_rng(9)
        params = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) if k[0] == "b"
                      else v) for k, v in params.items()}
    x = _x((2, 16, 32), 7)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    want = RATT.attn_train(jnp.asarray(x), params, rcfg, jnp.asarray(pos))
    pp = convert.params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    got = PATT.attn_train(_t(x), pp, pcfg, _t(pos))
    assert _rel(got, want) < F32_LAYER
    if block:  # the blockwise form equals the full form
        full = PATT.attn_train(_t(x), pp, pcfg.replace(attn_block_k=0), _t(pos))
        assert _rel(got, full.numpy()) < F32_LAYER
    init = PATT.attn_init(torch.Generator().manual_seed(0), pcfg, "float32")
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 1)], ids=["mha", "mqa"])
@pytest.mark.parametrize("block", [0, 4])
def test_attention_train_bf16_with_grads(h, kvh, block):
    """bfloat16 compute: the output and the gradients of the input and of
    every weight, through ``bdot``'s 3-D products and their backward."""
    rcfg, pcfg = _attn_cfg(h, kvh, True, block)
    rcfg, pcfg = rcfg.replace(compute_dtype="bfloat16"), pcfg.replace(compute_dtype="bfloat16")
    params = RATT.attn_init(jax.random.PRNGKey(2), rcfg, jnp.float32)
    x, gy = _x((2, 16, 32), 7), _x((2, 16, 32), 8)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    fn = lambda x_, p_: jnp.sum(RATT.attn_train(x_, p_, rcfg, jnp.asarray(pos)) * gy)  # noqa: E731
    want = RATT.attn_train(jnp.asarray(x), params, rcfg, jnp.asarray(pos))
    gx, gp = jax.grad(fn, argnums=(0, 1))(jnp.asarray(x), params)
    xt = _t(x).requires_grad_(True)
    pp = convert.params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    for v in pp.values():
        v.requires_grad_(True)
    got = PATT.attn_train(xt, pp, pcfg, _t(pos))
    got.backward(_t(gy))
    assert _rel(got, want) < BF16_LAYER
    assert _rel(xt.grad, gx) < BF16_LAYER
    for k in pp:
        assert _rel(pp[k].grad, gp[k]) < BF16_LAYER, k


# -- the decoder -----------------------------------------------------------------------


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vision":
        p = cfg.n_frontend_tokens
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, s - p)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab_size, (b, s - p)).astype(np.int32),
                "patches": (rng.normal(size=(b, p, cfg.d_model)) * 0.02).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


class _Bf16EinsumOnF32:
    """``jnp`` for the reference's MoE and MLA modules with each einsum of
    bfloat16 operands taken on their float32 upcasts (exact products,
    float32 accumulation, rounded to the einsum's output dtype): XLA's CPU
    backend cannot run those modules' batched bfloat16 einsums (a
    ``JaxRuntimeError``: its DotThunk has no BF16 x BF16 = F32), and the card's
    ``bmm.dtype`` computes them this way.  The reference's source is not
    touched: the modules' ``jnp`` global is swapped while a test runs."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if not any(o.dtype == jnp.bfloat16 for o in ops):
            return jnp.einsum(spec, *ops, preferred_element_type=preferred_element_type, **kw)
        out = preferred_element_type or jnp.result_type(*ops)
        ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o for o in ops]
        return jnp.einsum(spec, *ops, preferred_element_type=jnp.float32, **kw).astype(out)


def _leaf_spread(rapi, params, batch):
    """The reference's own float32 spread on each gradient leaf: its jitted
    gradient against its eager one, over the leaf's largest entry."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jit_g = jax.jit(jax.grad(rapi.train_loss))(params, jb)
    eager_g = jax.grad(rapi.train_loss)(params, jb)
    return [_rel(np.asarray(a), b) for a, b in zip(_leaves(jit_g), _leaves(eager_g))]


def _decoder_against_reference(arch, compute_dtype, tol, monkeypatch=None):
    rcfg = RCFG.get_smoke(arch).replace(compute_dtype=compute_dtype)
    if compute_dtype == "bfloat16" and (rcfg.moe or rcfg.mla):
        for mod in (RMOE, RMLA):
            monkeypatch.setattr(mod, "jnp", _Bf16EinsumOnF32())
    rapi = RREG.build_model(rcfg)
    params = rapi.init(jax.random.PRNGKey(0))
    batch = _batch(rcfg, s=32 if rcfg.ssm else 24)  # the SSD chunk (16) divides 32
    loss, grads = jax.jit(jax.value_and_grad(rapi.train_loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    runs = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        papi = PREG.build_model(PCFG.get_smoke(arch).replace(
            compute_dtype=compute_dtype, remat=remat, remat_policy=policy))
        pp = convert.params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
        leaves = _leaves(pp)
        for x in leaves:
            x.requires_grad_(True)
        pl = papi.train_loss(pp, {k: _t(v) for k, v in batch.items()})
        runs.append((pl.detach(), torch.autograd.grad(pl, leaves)))
    pl, pg = runs[0]
    assert _rel(pl, loss) < tol["loss"]
    errs = [_rel(g, r) for g, r in zip(pg, _leaves(grads))]
    if tol.get("plus_reference_spread") and max(errs) >= tol["grads"]:
        spread = _leaf_spread(rapi, params, batch)
        assert all(e < tol["grads"] + sp for e, sp in zip(errs, spread)), (errs, spread)
    else:
        assert max(errs) < tol["grads"], errs
    for other_loss, other_grads in runs[1:]:           # remat changes no bit
        assert torch.equal(other_loss, pl)
        assert all(torch.equal(a, b) for a, b in zip(other_grads, pg))


@pytest.mark.parametrize("arch", DENSE + ("phi-3-vision-4.2b",) + SPARSE)
def test_decoder_train_loss_and_grads(arch):
    tol = {"loss": F32_MODEL, "grads": F32_MODEL}
    if arch == "zamba2-7b":
        tol["plus_reference_spread"] = True
    _decoder_against_reference(arch, "float32", tol)


@pytest.mark.parametrize("arch", DENSE + ("phi-3-vision-4.2b",) + SPARSE)
def test_decoder_train_loss_and_grads_bf16(arch, monkeypatch):
    _decoder_against_reference(arch, "bfloat16", BF16_MODEL, monkeypatch)


def test_decoder_init_layout_and_first_loss():
    """The reference's layout (stacked layers), and a first loss near
    ln(vocab), as tests/test_models.py bounds it."""
    cfg = PCFG.get_smoke("granite-34b")
    params = PTR.decoder_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = RREG.build_model(RCFG.get_smoke("granite-34b")).init(jax.random.PRNGKey(0))
    flat_p = [(tuple(x.shape), x.dtype) for x in _leaves(params)]
    flat_r = [(tuple(x.shape), str(x.dtype)) for x in _leaves(want)]
    assert [s for s, _ in flat_p] == [s for s, _ in flat_r]
    assert all(d == torch.float32 for _, d in flat_p)
    assert params["layers"]["attn"]["wq"].shape[0] == cfg.n_layers
    loss = PREG.build_model(cfg).train_loss(params, {k: _t(v) for k, v in _batch(cfg).items()})
    assert abs(float(loss) - np.log(cfg.vocab_size)) < 1.0


def test_registry_specs_and_refusals():
    """Every config builds (RWKV and the encoder-decoder too), and
    ``generate`` refuses those two families with the reference's
    ``TypeError`` naming ``max_len``, in both packages: their ``prefill``
    takes no ``max_len`` (RWKV none, whisper ``max_dec_len``; ROADMAP queue
    C).  The specs are held in ``test_registry_specs_match_reference``."""
    for arch in PCFG.ARCH_IDS:
        for get in (PCFG.get, PCFG.get_smoke):
            assert PREG.build_model(get(arch)).cfg == get(arch)
    for arch, who in (("rwkv6-1.6b", "_rwkv_api.<locals>.<lambda>()"),
                      ("whisper-base", "encdec_prefill()")):
        rapi = RREG.build_model(RCFG.get_smoke(arch))
        papi = PREG.build_model(PCFG.get_smoke(arch))
        params = rapi.init(jax.random.PRNGKey(0))
        pp = convert.params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
        prompts = np.zeros((1, 8), np.int32)
        msg = f"{who} got an unexpected keyword argument 'max_len'"
        with pytest.raises(TypeError) as want:
            RENG.generate(rapi, params, jnp.asarray(prompts), RENG.ServeConfig(max_new_tokens=2))
        with pytest.raises(TypeError) as got:
            PENG.generate(papi, pp, _t(prompts), PENG.ServeConfig(max_new_tokens=2))
        assert str(got.value) == str(want.value) == msg


def _spec_shapes(tree):
    if isinstance(tree, dict):
        return {k: _spec_shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))


def test_registry_train_specs_match_reference():
    cfg = PCFG.get_smoke("granite-34b")
    api = PREG.build_model(cfg)
    specs = api.input_specs(ShapeConfig("t", 32, 2, "train"))["batch"]
    want = RREG.build_model(RCFG.get_smoke("granite-34b")).input_specs(
        RBASE.ShapeConfig("t", 32, 2, "train"))["batch"]
    assert {k: tuple(v.shape) for k, v in specs.items()} == {k: v.shape for k, v in want.items()}
    zeros = PREG.zeros_like_specs(specs, device="cpu")
    assert zeros["tokens"].dtype == torch.int32 and tuple(zeros["tokens"].shape) == (2, 32)
    vlm = PREG.build_model(PCFG.get_smoke("phi-3-vision-4.2b"))
    assert tuple(vlm.input_specs(ShapeConfig("t", 32, 2, "train"))["batch"]["patches"].shape) == (2, 8, 64)


@pytest.mark.parametrize("arch", DENSE + ("phi-3-vision-4.2b",) + SPARSE + (
    "rwkv6-1.6b", "whisper-base"))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_registry_specs_match_reference(arch, kind):
    """Every entry point's input specs, shapes and dtypes, equal to the
    reference's (bf16 compute, as published; the int8 cache for one dense
    config; RWKV's state with wkv float32; whisper's frames, its decoder
    tokens at max(s // dec_ratio, 64) and its self and cross caches at s)."""
    rcfg, pcfg = RCFG.get_smoke(arch), PCFG.get_smoke(arch)
    if arch == "qwen1.5-32b":
        rcfg, pcfg = rcfg.replace(kv_cache_dtype="int8"), pcfg.replace(kv_cache_dtype="int8")
    rcfg, pcfg = rcfg.replace(compute_dtype="bfloat16"), pcfg.replace(compute_dtype="bfloat16")
    got = PREG.build_model(pcfg).input_specs(ShapeConfig("s", 32, 2, kind))
    want = RREG.build_model(rcfg).input_specs(RBASE.ShapeConfig("s", 32, 2, kind))
    want = jax.tree.map(lambda sd: (tuple(sd.shape), str(sd.dtype)), want)
    assert _spec_shapes(got) == want


@pytest.mark.parametrize("arch", SPARSE)
def test_sparse_family_init_layout(arch):
    """The MoE, MLA and hybrid inits build the reference's layout (leaf
    names, shapes, dtypes: the router float32, stacked groups and tail) and a
    first loss near ln(vocab)."""
    cfg = PCFG.get_smoke(arch)
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    want = RREG.build_model(RCFG.get_smoke(arch)).init(jax.random.PRNGKey(0))
    assert _spec_shapes(params) == jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), want)
    loss = api.train_loss(params, {k: _t(v) for k, v in _batch(cfg, s=32).items()})
    assert abs(float(loss) - np.log(cfg.vocab_size)) < 1.0


def test_scan_or_unroll_stacks_outputs():
    stacked = {"a": torch.arange(6.0).reshape(3, 2)}
    carry, ys = PTR.scan_or_unroll(lambda c, sl: (c + sl["a"].sum(), sl["a"] * 2), torch.tensor(0.0),
                                   stacked)
    assert float(carry) == 15.0 and torch.equal(ys, stacked["a"] * 2)
    carry, ys = PTR.scan_or_unroll(lambda c, _: (c + 1, None), 0, None, length=4)
    assert carry == 4 and ys is None


# -- the port imports neither jax nor the reference ------------------------------------


NEW_MODULES = sorted(str(p.relative_to(SRC)) for d in ("configs", "data", "models", "optim")
                     for p in (SRC / d).glob("*.py")) + ["_tree.py", "train/loop.py", "convert.py",
                                                          "serve/engine.py"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_the_reference(module):
    tree = ast.parse((SRC / module).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names += [a.value for a in node.args if isinstance(a, ast.Constant)]
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{module} imports {bad}"
