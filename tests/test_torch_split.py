"""The backward's products through three bf16 planes, on the CPU.

* ``kernels.split_bf16x3_plain`` (the kernel's oracle): ``(hi + mid) + lo``
  gives each float32 back bit for bit from 1e-30 to 3e38 and for +-0, in
  every chunking.  The bound below bf16's normal range: exact for
  ``|g| >= 2**-110`` (~7.7e-34), where ``lo``'s lowest bit is still a bf16
  subnormal's (2**-133); padding past the axis splits into zeros.
* ``layers._split_products``: each chunk's planes stacked, the chunks summed
  in float32 (one batched product, or in place), against the float64
  product: within twice the float32 product's error (the CPU sums upcast
  operands in float32, so both sit at float32's rounding).
* ``_DotF32.backward`` takes the planes only for bf16 compute on a card: on
  the CPU (bf16 and f16) it gives the float32 product's bits as before, and
  a float32 compute dtype never reaches it.  ``read_counters`` counts the
  products by path while ``obs`` is enabled, nothing while it is not.
"""

import pytest
import torch

from repro_torch import obs
from repro_torch.kernels.split_bf16x3 import repeat_bf16x3, split_bf16x3, split_bf16x3_plain
from repro_torch.models import layers as L

EXACT_BELOW = 2.0 ** -110


def _values(n, lo_exp, hi_exp, seed):
    gen = torch.Generator().manual_seed(seed)
    mags = torch.logspace(lo_exp, hi_exp, n, dtype=torch.float64).float()
    signs = torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0)
    return torch.cat([mags * signs, torch.tensor([0.0, -0.0])])


def _reconstruct(planes, dim, k):
    """The planes of ``split_bf16x3_plain(g, dim, length)`` summed back
    ``(hi + mid) + lo`` in float32, the padding cut off."""
    p = planes.float().movedim(dim + 1, 1)
    r = (p[:, 2] + p[:, 1]) + p[:, 0]
    return r.movedim(0, dim).flatten(dim, dim + 1).narrow(dim, 0, k)


@pytest.mark.parametrize("length", [1, 7, 64, 4097])
def test_plain_split_gives_float32_back_bit_for_bit(length):
    g = _values(4095, -30, 38.477, seed=length)          # 1e-30 .. 3.0e38, +-0
    planes = split_bf16x3_plain(g, 0, length)
    assert planes.dtype == torch.bfloat16
    assert planes.shape == (-(-g.numel() // length), 3, length)
    back = _reconstruct(planes, 0, g.numel())
    assert torch.equal(back.view(torch.int32), g.view(torch.int32))   # -0 stays -0
    assert float(g.abs().max()) > 2.9e38 and float(g[g != 0].abs().min()) < 1.1e-30


def test_plain_split_is_exact_down_to_its_bound_and_pads_with_zeros():
    g = torch.tensor([EXACT_BELOW, -EXACT_BELOW * 1.5, 1e-33, -3e-34], dtype=torch.float32)
    g = g * (1 + torch.arange(4) * 2.0 ** -20)          # low significand bits set
    back = _reconstruct(split_bf16x3_plain(g, 0, 3), 0, 4)
    exact = g.abs() >= EXACT_BELOW
    assert exact.tolist() == [True, True, True, False]
    assert torch.equal(back[exact].view(torch.int32), g[exact].view(torch.int32))
    assert float((back[~exact] - g[~exact]).abs().max()) <= 2.0 ** -133   # below it: a subnormal ulp
    planes = split_bf16x3_plain(g, 0, 3)                 # 4 -> 2 chunks of 3, 2 padded
    assert torch.equal(planes[1, :, 1:].float(), torch.zeros(3, 2))


@pytest.mark.parametrize("shape,dim,length", [((3, 10, 7), 1, 4), ((3, 10, 7), 2, 3),
                                              ((10, 7), 0, 10), ((10, 7), 1, 2)])
def test_plain_split_chunks_either_matrix_axis(shape, dim, length):
    gen = torch.Generator().manual_seed(1)
    g = torch.randn(shape, generator=gen) * torch.exp(torch.randn(shape, generator=gen) * 8)
    planes = split_bf16x3(g, dim, length)                # a CPU tensor takes the plain version
    c = -(-shape[dim] // length)
    assert planes.shape == (c, *shape[:dim], 3, length, *shape[dim + 1:])
    assert planes.is_contiguous()
    back = _reconstruct(planes, dim, shape[dim])
    assert torch.equal(back.view(torch.int32), g.view(torch.int32))


@pytest.mark.parametrize("shape,dim,length", [((3, 10, 7), 1, 4), ((10, 7), 1, 2)])
def test_plain_repeat_lays_a_bf16_operand_out_as_the_planes(shape, dim, length):
    """``repeat_bf16x3``: a bf16 operand's chunks in the planes' layout, the
    same values in each of the three, zero past the axis."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2)).bfloat16()
    rep = repeat_bf16x3(x, dim, length)
    assert rep.shape == split_bf16x3(x.float(), dim, length).shape and rep.is_contiguous()
    for p in range(3):
        back = rep.select(dim + 1, p).movedim(0, dim).flatten(dim, dim + 1)
        assert torch.equal(back.narrow(dim, 0, shape[dim]), x)
        assert not back.narrow(dim, shape[dim], back.shape[dim] - shape[dim]).any()


def _rel(x, want):
    return float((x.double() - want).norm() / want.norm())


@pytest.mark.parametrize("chunk", [512, 16, 5])
@pytest.mark.parametrize("shapes", [((96, 200), (96, 40), (40, 200)),
                                    ((3, 130, 20), (3, 130, 30), (3, 30, 20)),
                                    ((2, 10, 70), (2, 10, 16), (2, 16, 70))],
                         ids=["2d", "3d-long-m", "3d-long-n"])
def test_split_products_within_twice_the_float32_error(monkeypatch, chunk, shapes):
    monkeypatch.setattr(L, "SPLIT_CHUNK", chunk)
    gen = torch.Generator().manual_seed(chunk)
    g, a, b = (torch.randn(s, generator=gen, dtype=torch.float64) for s in shapes)
    g, a, b = g.float(), a.bfloat16(), b.bfloat16()
    want_a, want_b = g.double() @ b.double().mT, a.double().mT @ g.double()
    f32_a, f32_b = g @ b.float().mT, a.float().mT @ g
    for need in ((True, True), (True, False), (False, True)):
        ga, gb = L._split_products(g, a, b, *need)
        assert (ga is None, gb is None) == (not need[0], not need[1])
        if ga is not None:
            assert ga.dtype == torch.float32 and ga.shape == want_a.shape
            assert _rel(ga, want_a) <= 2 * _rel(f32_a, want_a) + 1e-9
        if gb is not None:
            assert gb.dtype == torch.float32 and gb.shape == want_b.shape
            assert _rel(gb, want_b) <= 2 * _rel(f32_b, want_b) + 1e-9


@pytest.mark.parametrize("chain_bytes,partials_bytes", [(1, 1 << 31), (1 << 24, 1 << 31),
                                                        (1 << 24, 4 * 3 * 20 * 30 * 2)],
                         ids=["in-place", "one-batch", "two-at-a-time"])
def test_chunk_sums_agree_however_they_are_grouped(monkeypatch, chain_bytes, partials_bytes):
    monkeypatch.setattr(L, "SPLIT_CHUNK", 8)
    monkeypatch.setattr(L, "_CHAIN_BYTES", chain_bytes)
    monkeypatch.setattr(L, "_PARTIALS_BYTES", partials_bytes)
    gen = torch.Generator().manual_seed(3)
    g = torch.randn((3, 50, 20), generator=gen)
    a = torch.randn((3, 50, 30), generator=gen).bfloat16()
    b = torch.randn((3, 30, 20), generator=gen).bfloat16()
    ga, gb = L._split_products(g, a, b, True, True)
    assert float((ga - g @ b.float().mT).abs().max()) < 1e-5
    assert float((gb - a.float().mT @ g).abs().max()) < 1e-5


@pytest.mark.parametrize("cd", ["bfloat16", "float16"])
def test_cpu_backward_keeps_the_float32_product(cd):
    """Off the card the backward is the float32 product rounded to the
    compute dtype, then to the input's dtype, bit for bit as before."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 9, 40), generator=gen).requires_grad_(True)
    w = torch.randn((40, 24), generator=gen).requires_grad_(True)
    gy = torch.randn((2, 9, 24), generator=gen)
    obs.enable()
    try:
        L.read_counters()
        gx, gw = torch.autograd.grad(L.dot(x, w, cd), (x, w), gy)
        counts = L.read_counters()
    finally:
        obs.disable()
    dt = getattr(torch, cd)
    xc, wc = x.detach().to(dt).reshape(18, 40), w.detach().to(dt)
    want_x = torch.matmul(gy.reshape(18, 24), wc.float().mT).to(dt).float().reshape(2, 9, 40)
    want_w = torch.matmul(xc.float().mT, gy.reshape(18, 24)).to(dt).float()
    assert torch.equal(gx, want_x) and torch.equal(gw, want_w)
    assert counts == {"split": 0, "float32": 1}


def test_counters_count_nothing_while_obs_is_disabled():
    x = torch.randn((4, 8), requires_grad=True)
    w = torch.randn((8, 3), requires_grad=True)
    assert not obs.enabled()
    L.read_counters()
    L.bdot(x[None], w[None], "bfloat16").sum().backward()
    assert L.read_counters() == {"split": 0, "float32": 0}
    obs.enable()
    try:
        L.dot(x, w, "float32").sum().backward()          # float32 compute: no _DotF32
        L.bdot(x[None], w[None], "bfloat16").sum().backward()
        L.bdot(x[None], w[None], "bfloat16").sum().backward()
        counts = L.read_counters()
        assert L.read_counters() == {"split": 0, "float32": 0}   # reset on read
    finally:
        obs.disable()
    assert counts == {"split": 0, "float32": 2}
    assert obs.registry().counter("dot_bwd_float32").value >= 2
