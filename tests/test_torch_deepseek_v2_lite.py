"""DeepSeek-V2-Lite as the benchmark trains it, at a smoke size on the CPU:
the port's options for it (``configs.base.MoEPortConfig``,
``MLAPortConfig``: an expert share, unnormalised top-k gates, leading dense
layers, YaRN, the sequence-wise balance loss) against the plain reference
``perfbench/reference/deepseek_v2.py``, which the benchmark's cell
``deepseek-v2-lite.spectral-adam`` compares the program with on the card.

* loss and every leaf's gradient: in float32 compute at 1e-5 (relative to
  each leaf's largest entry; the two sides differ in summation order, and
  the port takes MLA in its absorbed form, the reference unabsorbed:
  measured 1.3e-6); in bfloat16 compute the loss at 5e-4 and the gradients
  at 2**-4 of each leaf's largest entry (measured 2.9e-2 at most): the two
  sides round other intermediates to bf16 (the absorbed query against the
  up-projected key, the combine's output), so this holds the structure, not
  each rounding;
* three spectral-Adam steps through ``train.loop.train_step`` (the cell's
  driver) against the reference's, in float32 compute;
* the expert share: over the shares of a layer's experts, the held parts
  sum to the uncut layer's routed output, with the shared experts and the
  balance loss counted once, in the port and in the reference;
* YaRN's frequencies and softmax scale against the formulas at the
  published rope settings (ramp ends 10 and 23);
* the options off: the port computes what it computed without them (the
  parity tests against the JAX package stay as they are); donating the
  step's state changes no bit; the spans and counters change no value.
"""

from __future__ import annotations

import copy
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import manifest  # noqa: E402
from perfbench.inputs import deepseek_v2 as din  # noqa: E402
from perfbench.reference import deepseek_v2 as dref  # noqa: E402
from perfbench.reference import granite as gref  # noqa: E402
from perfbench.reference import train as rtrain  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    MLAConfig,
    MLAPortConfig,
    MoEConfig,
    MoEPortConfig,
    OptimizerConfig,
    YarnConfig,
)
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import mla as PMLA  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.optim.spectral_adam import spectral_adam_init  # noqa: E402
from repro_torch.train import loop  # noqa: E402

CELL = "deepseek-v2-lite.spectral-adam"


def small_cell(compute_dtype="bfloat16"):
    """The cell at a smoke size: every width cut, every option kept (27 -> 3
    layers, one dense; 8 of 64 -> 2 of 8 experts held, chip 1 of 4)."""
    cell = copy.deepcopy(manifest.resolve(CELL))
    cfg = cell.config
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
               intermediate_size=96, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, moe_intermediate_size=32, n_routed_experts=2,
               num_experts_per_tok=2, num_hidden_layers=3, vocab_size=512, vocab_pad_to=64,
               moe_group_size=16, seq_len=32, global_batch=2, compute_dtype=compute_dtype)
    cfg["expert_parallel"] = dict(cfg["expert_parallel"], chips=4, rank=1, routed_experts=8)
    cfg["rope_scaling"] = dict(cfg["rope_scaling"], original_max_position_embeddings=16)
    cell.traffic["optimizer"]["spectral_rank"] = 4
    return cell


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size products on one intra-op thread: beside the suite's other
    workers a thread pool per process oversubscribes the cores, and these
    small products then take tens of times longer."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def drv():
    return manifest.driver("train_model")


@pytest.fixture
def f32_reference(monkeypatch):
    """The reference's products without rounding (float32 compute)."""
    monkeypatch.setitem(gref.ROUNDING, "float32", lambda x: x)


def _leaf_gaps(got: dict, want: dict) -> dict:
    return {"/".join(k): float((got[k] - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for k, w in want.items()}


@pytest.mark.parametrize("cd,loss_tol,grad_tol", [("float32", 1e-6, 1e-5),
                                                  ("bfloat16", 5e-4, 2.0 ** -4)])
@pytest.mark.parametrize("seed", [3, 4])
def test_loss_and_grads_match_the_reference(drv, f32_reference, cd, loss_tol, grad_tol, seed):
    cell = small_cell(cd)
    cfg = cell.config
    api, _ = drv.program(cfg, cell.traffic)
    params = din.make_weights(cfg, seed, "cpu")
    batch = din.Batches(cfg, seed, "cpu").next()
    got_loss, got = loop.loss_and_grads(api, params, batch)
    want_loss, want = dref.loss_and_grads(params, batch, cfg, cd)
    assert abs(float(got_loss) - float(want_loss)) <= loss_tol * abs(float(want_loss))
    gaps = _leaf_gaps(din.flatten(got), want)
    assert max(gaps.values()) <= grad_tol, gaps


def test_spectral_adam_steps_match_the_reference(drv, f32_reference):
    """The cell's own set-up (three compared steps and a refresh through
    ``train_step`` with the state donated) against the reference's steps."""
    cell = small_cell("float32")
    cfg, traffic = cell.config, cell.traffic
    api, opt = drv.program(cfg, traffic)
    for seed in (3, 4):
        _, prog = drv.program_readings(cfg, traffic, seed, "cpu", api, opt)
        want = rtrain.run_steps(dref, din, cfg, traffic, seed, "cpu", drv.COMPARED,
                                fmt="float32", align=prog["align"])
        nums = drv.compare(prog, want, traffic)
        # measured at most 1.5e-7, 1.7e-4, 6.2e-4, 3.0e-4 (float32 trackers)
        assert nums["loss"] <= 1e-6 and nums["seen_grad"] <= 2e-3, nums
        assert nums["change"] <= 5e-3 and nums["tracker_sigma"] <= 5e-3, nums


def _moe_cfg(n_held=0, start=0, **kw):
    base = get_smoke("deepseek-v2-lite-16b")
    moe = MoEPortConfig(n_routed=8, n_shared=1, top_k=3, d_ff_expert=24, capacity_factor=1.0,
                        group_size=16, n_held=n_held, held_start=start, norm_topk=False,
                        seq_aux_alpha=0.01, **kw)
    return base.replace(moe=moe)


@pytest.mark.parametrize("n_held", [1, 2, 4])
def test_expert_shares_sum_to_the_uncut_layer(n_held):
    """Each share holds ``n_held`` experts and routes over all 8 with the
    uncut layer's capacity: the shares' routed parts add up to the uncut
    layer's (some choices dropped over capacity), the shared experts and the
    balance loss counted once; the same in the reference."""
    full = _moe_cfg()
    gen = torch.Generator().manual_seed(11)
    p_full = PMOE.moe_init(gen, full, torch.float32)
    x = torch.randn(2, 24, full.d_model, generator=gen)
    want, want_aux = PMOE.moe_apply(x, p_full, full)
    shared = PL.mlp_apply(x, p_full["shared"], "swiglu", full.compute_dtype)

    got = shared.clone()
    ref_sum = 0
    rcfg = {"expert_parallel": {"routed_experts": 8, "rank": 0}, "n_routed_experts": 8,
            "num_experts_per_tok": 3, "hidden_size": full.d_model, "n_shared_experts": 1,
            "aux_loss_alpha": 0.01, "moe_group_size": 16, "capacity_factor": 1.0}
    for share in range(8 // n_held):
        cfg = _moe_cfg(n_held, share * n_held)
        sl = slice(share * n_held, (share + 1) * n_held)
        p = dict(p_full, **{k: p_full[k][sl] for k in ("wg", "wu", "wd")})
        out, aux = PMOE.moe_apply(x, p, cfg)
        got = got + (out - shared)
        assert torch.equal(aux, want_aux)
        r = dict(rcfg, n_routed_experts=n_held,
                 expert_parallel={"routed_experts": 8, "rank": share})
        with _dims(r):
            r_out, r_aux = dref._moe(x, p, r, "float32")
        ref_sum = ref_sum + r_out - shared
        torch.testing.assert_close(r_aux, want_aux, rtol=1e-6, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(ref_sum + shared, want, rtol=0, atol=1e-5)


class _dims:
    """Give ``reference.deepseek_v2._moe`` the sizes of a bare MoE layer (the
    inputs' ``dims`` reads them from a whole configuration file), with its
    products in float32."""

    def __init__(self, cfg):
        self.cfg = cfg

    def __enter__(self):
        c = self.cfg
        self.saved = din.dims
        ep = c["expert_parallel"]
        din.dims = lambda _: {"n_routed": ep["routed_experts"], "n_held": c["n_routed_experts"],
                              "held_start": ep["rank"] * c["n_routed_experts"],
                              "k": c["num_experts_per_tok"], "n_shared": c["n_shared_experts"]}
        self.round = gref.ROUNDING.get("float32")
        gref.ROUNDING["float32"] = lambda x: x

    def __exit__(self, *exc):
        din.dims = self.saved
        if self.round is None:
            del gref.ROUNDING["float32"]


def test_yarn_frequencies_and_scale_are_the_formulas():
    yarn = YarnConfig(factor=40, original_max_position=4096, beta_fast=32, beta_slow=1,
                      mscale=0.707, mscale_all_dim=0.707)
    d, b = 64, 10000.0
    assert PL.yarn_range(d, b, yarn) == (10, 23)
    got = PL.rope_freqs(d, b, yarn=yarn).double()
    for i in range(d // 2):
        extra = b ** (-2 * i / d)
        ramp = min(max((i - 10) / 13, 0.0), 1.0)
        assert got[i].item() == pytest.approx((extra / 40) * ramp + extra * (1 - ramp), rel=1e-6)
    assert got[:10].tolist() == pytest.approx([b ** (-2 * i / d) for i in range(10)], rel=1e-6)
    assert got[23:].tolist() == pytest.approx([b ** (-2 * i / d) / 40 for i in range(23, 32)],
                                              rel=1e-6)
    g = 0.1 * 0.707 * math.log(40) + 1
    cfg = get_smoke("deepseek-v2-lite-16b").replace(mla=MLAPortConfig(
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, yarn=yarn))
    assert PMLA.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * g * g, rel=1e-12)
    assert g * g == pytest.approx(1.590, abs=1e-3)
    # the published mscale equals mscale_all_dim: cos and sin unscaled
    x = torch.randn(1, 5, 2, d)
    pos = torch.arange(5, dtype=torch.int32)[None]
    inv = PL.rope_freqs(d, b, yarn=yarn)
    ang = pos[0, :, None].float() * inv
    x1, x2 = x[..., :32], x[..., 32:]
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    torch.testing.assert_close(PL.rope_apply(x, pos, b, yarn),
                               torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1))
    # the reference's frequencies are the port's
    sc = {"factor": 40, "original_max_position_embeddings": 4096, "beta_fast": 32,
          "beta_slow": 1}
    assert torch.equal(dref.yarn_inv_freq(d, b, sc), PL.rope_freqs(d, b, yarn=yarn))


def _smoke_pair():
    """deepseek-v2-lite's smoke config with the reference's sub-configs and
    with the port's at their defaults."""
    plain = get_smoke("deepseek-v2-lite-16b").replace(compute_dtype="bfloat16", remat=True)
    m, a = plain.moe, plain.mla
    port = plain.replace(moe=MoEPortConfig(**vars(m)), mla=MLAPortConfig(**vars(a)))
    assert type(plain.moe) is MoEConfig and type(plain.mla) is MLAConfig
    return plain, port


def test_options_off_compute_what_the_plain_configs_compute():
    plain, port = _smoke_pair()
    gen = torch.Generator().manual_seed(5)
    api_plain, api_port = build_model(plain), build_model(port)
    params = api_plain.init(gen, device="cpu")
    shapes = lambda t: [tuple(x.shape) for x in tree_leaves(t)]  # noqa: E731
    assert shapes(api_port.init(None, device="meta")) == shapes(params)
    toks = torch.randint(0, plain.vocab_size, (2, 33), generator=gen, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    la, ga = loop.loss_and_grads(api_plain, params, batch)
    lb, gb = loop.loss_and_grads(api_port, params, batch)
    assert torch.equal(la, lb)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(ga), tree_leaves(gb)))


def _full_options_cfg(**moe_kw):
    base = get_smoke("deepseek-v2-lite-16b")
    moe = MoEPortConfig(n_routed=8, n_shared=1, top_k=2, d_ff_expert=32, group_size=16,
                        n_held=2, held_start=2, norm_topk=False, first_dense=1,
                        seq_aux_alpha=0.01, **moe_kw)
    mla = MLAPortConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                        yarn=YarnConfig(original_max_position=16))
    return base.replace(n_layers=3, compute_dtype="bfloat16", remat=True, moe=moe, mla=mla)


def _batch(cfg, seed=1, b=2, s=32):
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=torch.Generator().manual_seed(
        seed), dtype=torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("spectral", [True, False], ids=["spectral-adam", "adamw"])
def test_donated_steps_change_no_bit(spectral):
    cfg = _full_options_cfg()
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    opt = OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=100, spectral_rank=4,
                          basis_refresh_every=2)
    runs = []
    for donate in (False, True):
        p = tree_map(lambda x: x.clone(), params)
        st = (spectral_adam_init(torch.Generator().manual_seed(2), p, rank=4, device="cpu")
              if spectral else adamw_init(p))
        losses = []
        for t in range(3):
            p, st, loss, _ = loop.train_step(api, opt, p, st, _batch(cfg, t), t,
                                             spectral=spectral, donate=donate)
            losses.append(float(loss))
        runs.append((losses, tree_leaves(p)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_spans_cover_forward_recompute_and_backward_and_change_nothing():
    """With tracing on, each layer's ``mla`` and ``moe`` (``dense_mlp`` for the
    leading layer) are entered in the forward, the remat recompute and the
    backward, no span of one name inside another of the same name; the loss
    and gradients are those with tracing off."""
    cfg = _full_options_cfg()
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg)
    want_loss, want = loop.loss_and_grads(api, params, batch)
    obs.clear_trace()
    obs.start_tracing()
    try:
        loss, grads = loop.loss_and_grads(api, params, batch)
    finally:
        obs.stop_tracing()
    events = obs.trace_events()
    obs.clear_trace()
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(want)))
    names = [e["name"] for e in events]
    # fwd + recompute of 3 layers, 2 MoE layers, 1 dense; each backward at least once more
    assert names.count("mla") >= 9 and names.count("moe") >= 6 and names.count("dense_mlp") >= 3
    for child in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared"):
        assert names.count(child) == 4
    for name in ("mla", "moe", "dense_mlp"):
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == name)
        assert all(b[0] >= a[1] for a, b in zip(spans, spans[1:])), name


def test_counters_only_with_obs_and_once_a_forward():
    """Off: nothing accumulates.  On: the choices routed to held experts and
    those dropped, counted in the forward and not in the recompute (remat on
    and off count the same)."""
    counts = {}
    for remat in (True, False):
        cfg = _full_options_cfg().replace(remat=remat)
        api = build_model(cfg)
        params = api.init(torch.Generator().manual_seed(0), device="cpu")
        PMOE._COUNTS.clear()
        loop.loss_and_grads(api, params, _batch(cfg))
        assert not PMOE._COUNTS
        obs.enable()
        try:
            loop.loss_and_grads(api, params, _batch(cfg))
            counts[remat] = PMOE.read_counters()
        finally:
            obs.disable()
    assert counts[True] == counts[False]
    assert 0 < counts[True]["dropped"] < counts[True]["routed_held"] <= 2 * 32 * 2 * 2


def test_balance_loss_is_the_formula():
    cfg = _moe_cfg()
    gen = torch.Generator().manual_seed(3)
    p = PMOE.moe_init(gen, cfg, torch.float32)
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    _, aux = PMOE.moe_apply(x, p, cfg)
    probs = torch.softmax(x @ p["router"], -1)                  # (b, s, E)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :3]
    want = 0.0
    for b in range(2):
        f = torch.bincount(idx[b].reshape(-1), minlength=8).double() * 8 / (16 * 3)
        want += float((f * probs[b].double().mean(0)).sum()) / 2
    assert float(aux) == pytest.approx(0.01 * want, rel=1e-5)


def test_serving_takes_the_options():
    """Prefill, then decode through the cache, equals the training forward's
    logits with every option on (float32, a stack of dense then MoE layers)."""
    cfg = _full_options_cfg().replace(compute_dtype="float32", remat=False)
    cfg = cfg.replace(moe=MoEPortConfig(**dict(vars(cfg.moe), capacity_factor=8.0)))
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    toks = _batch(cfg, s=16)["tokens"]
    from repro_torch.models import transformer as PTR

    with torch.no_grad():
        full = PTR.decoder_forward(params, {"tokens": toks}, cfg)
        logits, cache = api.prefill(params, {"tokens": toks[:, :8]}, max_len=16)
        torch.testing.assert_close(logits[:, 0], full[:, 7], rtol=0, atol=1e-4)
        for pos in range(8, 12):
            logits, cache = api.decode_step(params, cache, toks[:, pos:pos + 1], pos)
            torch.testing.assert_close(logits[:, 0], full[:, pos], rtol=0, atol=1e-4)
