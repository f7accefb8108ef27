"""Serving engine: batched prefill + decode with greedy/temperature sampling,
in PyTorch.

Counterpart of ``repro.serve.engine``: the requests are batched, prefilled
once, then decoded step by step through the per-architecture cache machinery
(KV / compressed MLA / SSM states behind the same ``ModelApi``).  The cache
is written in place each step (the reference donates it to a jitted
``decode_step``).  ``generate`` runs under ``torch.inference_mode()``; the
position is a Python int, the sampled token stays on the device and the
tokens are concatenated there, so a greedy decode step makes no host wait.

Sampling at temperature > 0 reproduces the reference's draws: its key
schedule (``PRNGKey(seed)`` for the first token, then ``key, sub =
split(key)`` each step) and ``jax.random.categorical``, the argmax of
``logits / temperature`` plus Gumbel noise, ``-log(-log(u))`` of uniforms
made from threefry-2x32 bits (jax's partitionable form, the default of jax
0.9: a draw of shape S hashes the counts 0 .. prod(S) - 1 and xors the two
output words).  The keys are made on the host (they depend on the seed
only); the bits of a draw are made on the logits' device, in int64
arithmetic on values kept in ``[0, 2**32)``, as ``data.synthetic`` does its
hash.  The bits equal jax's to the bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.registry import ModelApi

__all__ = ["ServeConfig", "generate", "prng_key", "random_bits", "split", "gumbel"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0   # 0 = greedy
    seed: int = 0


# -- threefry-2x32 -------------------------------------------------------------


def _rotl(x, r):
    return ((x << r) & _M32) | (x >> (32 - r))


def _threefry2x32(k1: int, k2: int, x1, x2):
    """jax's threefry-2x32 hash of the counts ``(x1, x2)`` (Python ints or
    int64 tensors in ``[0, 2**32)``) under the key ``(k1, k2)``; 20 rounds."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1, x2 = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s two words (a 64-bit seed's high and low
    halves, as under ``jax_enable_x64``)."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)``: key ``i`` is the hash of the count
    ``(0, i)``."""
    return [_threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def random_bits(key: tuple[int, int], shape, device) -> torch.Tensor:
    """jax's 32-bit random bits of ``shape`` under ``key``, as int64 in
    ``[0, 2**32)`` on ``device`` (counts beyond 2**32 not supported)."""
    n = 1
    for d in shape:
        n *= d
    if n > 2 ** 32:
        raise ValueError(f"a draw of {n} values exceeds the 32-bit count")
    lo = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    b1, b2 = _threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return b1 ^ b2


def _uniform_tiny(key, shape, device) -> torch.Tensor:
    """``_uniform(key, minval=tiny, maxval=1., shape, float32)``: 23 mantissa
    bits under the exponent of 1.0, minus 1, then ``max(tiny, u * (1 -
    tiny) + tiny)`` (``1 - tiny`` is 1.0 in float32)."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    return torch.clamp_min(floats * 1.0 + tiny, tiny)


def gumbel(key, shape, device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low")."""
    return -torch.log(-torch.log(_uniform_tiny(key, shape, device)))


def _sample(logits, temperature, key):
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / temperature
    return torch.argmax(gumbel(key, tuple(scaled.shape), scaled.device) + scaled,
                        dim=-1).to(torch.int32)


@torch.inference_mode()
def generate(api: ModelApi, params, prompts: torch.Tensor, serve_cfg: ServeConfig,
             *, max_len: int | None = None) -> torch.Tensor:
    """``prompts`` (b, prompt_len) int32 on the parameters' device.  Returns
    (b, max_new_tokens) int32 there.  Past ``max_len`` each decode step
    overwrites the cache's last slot, as the reference's does.  The RWKV and
    encoder-decoder families raise the reference's ``TypeError`` here (their
    ``prefill`` takes no ``max_len``): they serve through ``prefill`` +
    ``decode_step``."""
    b, prompt_len = prompts.shape
    total = prompt_len + serve_cfg.max_new_tokens
    max_len = max_len or total

    logits, cache = api.prefill(params, {"tokens": prompts}, max_len=max_len)
    key = prng_key(serve_cfg.seed)
    token = _sample(logits[:, -1, :], serve_cfg.temperature, key)[:, None]
    out = [token]
    pos = prompt_len
    for _ in range(serve_cfg.max_new_tokens - 1):
        key, sub = split(key)
        logits, cache = api.decode_step(params, cache, token, pos)
        token = _sample(logits[:, -1, :], serve_cfg.temperature, sub)[:, None]
        out.append(token)
        pos += 1
    return torch.cat(out, dim=1)
