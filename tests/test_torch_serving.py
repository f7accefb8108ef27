"""``repro_torch.serve.engine.generate`` against the reference's
``repro.serve.engine.generate``.

* Greedy: token for token equal to the reference at the smoke configs of
  granite-34b (MQA), qwen2-72b (GQA, QKV bias), deepseek-moe-16b,
  deepseek-v2-lite-16b (MLA + MoE) and zamba2-7b (hybrid), float32 compute,
  b 2, prompts of 12 tokens, 6 new tokens.  The reference's decode is jitted
  (its numerics are XLA's); the logits agree to ~1e-6 and the argmax to the
  token.
* Sampling at temperature > 0: the threefry-2x32 key schedule and random
  bits equal to ``jax.random``'s to the bit (``PRNGKey``, ``split``,
  ``random_bits``); the Gumbel noise within 4 float32 eps of
  ``jax.random.gumbel`` (relative above 1, absolute below: two ``log``
  implementations, the inner one's rounding carried through the outer) and
  equal on most entries; the sampled tokens
  equal to the reference's for a fixed list of seeds.
* ``kv_cache_dtype="int8"``: ``generate`` raises the reference's
  ``TypeError`` in both packages (ROADMAP queue C).
* Determinism, the ``ServeConfig`` defaults, and the reference's own oracles
  (``tests/test_serve_system.py``: greedy generation deterministic and equal
  to the argmax of the full forward at each step) on the port.
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
from repro_torch.models import registry as PREG
from repro_torch.models import transformer as PTR
from repro_torch.serve import engine as PENG

RCFG = ref("configs")
RREG = ref("models.registry")
RENG = ref("serve.engine")

ARCHS = ("granite-34b", "qwen2-72b", "deepseek-moe-16b", "deepseek-v2-lite-16b", "zamba2-7b")
SEEDS = (0, 1, 7, 12345, 2**32 + 5)


def _case(arch, seed=0, **kw):
    rcfg, pcfg = RCFG.get_smoke(arch).replace(**kw), PCFG.get_smoke(arch).replace(**kw)
    rapi, papi = RREG.build_model(rcfg), PREG.build_model(pcfg)
    params = rapi.init(jax.random.PRNGKey(seed))
    pp = convert.params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    prompts = np.random.default_rng(seed).integers(0, rcfg.vocab_size, (2, 12)).astype(np.int32)
    return rapi, papi, params, pp, prompts


def _both(case, serve_kw):
    rapi, papi, params, pp, prompts = case
    want = RENG.generate(rapi, params, jnp.asarray(prompts), RENG.ServeConfig(**serve_kw))
    got = PENG.generate(papi, pp, torch.as_tensor(prompts), PENG.ServeConfig(**serve_kw))
    return got, np.asarray(want)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return _case(request.param)


def test_generate_greedy_equals_the_reference(case):
    got, want = _both(case, {"max_new_tokens": 6})
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_sampled_equals_the_reference(case):
    got, want = _both(case, {"max_new_tokens": 4, "temperature": 0.7, "seed": 11})
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_sampled_tokens_equal_on_fixed_seeds(seed):
    c = _case("qwen2-72b", seed=3)
    got, want = _both(c, {"max_new_tokens": 4, "temperature": 1.3, "seed": seed})
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_and_bits_equal_to_the_bit(seed):
    key = jax.random.PRNGKey(seed)
    assert PENG.prng_key(seed) == tuple(int(v) for v in np.asarray(key))
    pk = PENG.prng_key(seed)
    for _ in range(3):                                  # the engine's key schedule
        key, sub = jax.random.split(key)
        pk, psub = PENG.split(pk)
        assert (pk, psub) == (tuple(int(v) for v in np.asarray(key)),
                              tuple(int(v) for v in np.asarray(sub)))
    np.testing.assert_array_equal(jax.random.split(key, 5), np.array(PENG.split(pk, 5)))
    for shape in ((7,), (2, 5), (3, 513)):
        want = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(PENG.random_bits(pk, shape, "cpu").numpy(), want)


def test_gumbel_matches_jax():
    key = jax.random.PRNGKey(42)
    want = np.asarray(jax.random.gumbel(key, (4, 1000), jnp.float32))
    got = PENG.gumbel(PENG.prng_key(42), (4, 1000), "cpu").numpy()
    # the inner log's rounding reaches the outer one's output absolutely near 0
    assert (np.abs(got - want) <= 4 * np.finfo(np.float32).eps * np.maximum(1.0, np.abs(want))).all()
    assert (got == want).mean() > 0.5


def test_int8_generate_raises_in_both():
    """The reference's refusal (ROADMAP queue C): ``prefill`` returns float
    caches, and the first int8 decode step writes int8 into them."""
    rapi, papi, params, pp, prompts = _case("qwen2-72b", kv_cache_dtype="int8")
    with pytest.raises(TypeError, match="same dtypes, got float32, int8"):
        RENG.generate(rapi, params, jnp.asarray(prompts), RENG.ServeConfig(max_new_tokens=3))
    with pytest.raises(TypeError, match="same dtypes, got float32, int8"):
        PENG.generate(papi, pp, torch.as_tensor(prompts), PENG.ServeConfig(max_new_tokens=3))


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "deepseek-v2-lite-16b", "zamba2-7b"])
def test_generate_past_a_short_max_len_equals_the_reference(arch):
    """``max_len`` shorter than prompt + new tokens: past the end of its
    cache each decode step overwrites the last slot, in the reference (its
    dynamic update slice clamps the start) and in the port (C1); the
    tokens equal the reference's."""
    rcfg, pcfg = RCFG.get_smoke(arch), PCFG.get_smoke(arch)
    rapi, papi = RREG.build_model(rcfg), PREG.build_model(pcfg)
    params = rapi.init(jax.random.PRNGKey(0))
    pp = convert.params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    prompts = np.random.default_rng(0).integers(0, rcfg.vocab_size, (2, 8)).astype(np.int32)
    want = RENG.generate(rapi, params, jnp.asarray(prompts), RENG.ServeConfig(max_new_tokens=5),
                         max_len=10)
    got = PENG.generate(papi, pp, torch.as_tensor(prompts), PENG.ServeConfig(max_new_tokens=5),
                        max_len=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_config_defaults_equal():
    assert dataclasses.asdict(PENG.ServeConfig()) == dataclasses.asdict(RENG.ServeConfig())


def test_generate_deterministic_and_in_vocab():
    """tests/test_serve_system.py's first oracle on the port, greedy and
    sampled."""
    cfg = PCFG.get_smoke("granite-34b")
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)),
                              dtype=torch.int32)
    for sc in (PENG.ServeConfig(max_new_tokens=6), PENG.ServeConfig(6, 0.9, 5)):
        out1 = PENG.generate(api, params, prompts, sc)
        out2 = PENG.generate(api, params, prompts, sc)
        assert torch.equal(out1, out2) and tuple(out1.shape) == (2, 6)
        assert int(out1.max()) < cfg.vocab_size


def test_generate_matches_teacher_forcing():
    """tests/test_serve_system.py's second oracle on the port: greedy
    generation equals the argmax of the full forward at each step."""
    cfg = PCFG.get_smoke("qwen2-72b")
    api = PREG.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(3), device="cpu")
    seq = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 8)),
                          dtype=torch.int32)
    gen = PENG.generate(api, params, seq, PENG.ServeConfig(max_new_tokens=4))
    with torch.no_grad():
        for i in range(4):
            nxt = int(torch.argmax(PTR.decoder_forward(params, {"tokens": seq}, cfg)[0, -1]))
            assert nxt == int(gen[0, i]), i
            seq = torch.cat([seq, torch.tensor([[nxt]], dtype=torch.int32)], dim=1)
