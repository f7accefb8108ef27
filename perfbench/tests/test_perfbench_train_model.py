"""The cells of ``drivers/train_model.py`` (``deepseek-v2-lite.spectral-adam``,
``granite34b.adamw``): their configuration, traffic, limits and readers
load; the DeepSeek-V2 configuration is the published one but for its
stated cut, and the driver turns it into the port's config or refuses it;
``counts/deepseek_v2.py`` against a hand count; both cells run at a test
size, the AdamW one correct, and each cell's control (float8 products) is
not correct."""

import copy
import json

import pytest
import torch

from _cells import ROOT, Ctx

from perfbench.counts import deepseek_v2 as dcount
from perfbench.harness import manifest
from perfbench.run import checks_of, passes, result_line

V2, ADAMW = "deepseek-v2-lite.spectral-adam", "granite34b.adamw"
NEW_METRICS = ("train_mfu.moe", "train.span.mla_ms", "train.span.moe_ms")
# the published config.json of DeepSeek-V2-Lite (the catalog row's numbers)
PUBLISHED = {"first_k_dense_replace": 1, "hidden_size": 2048, "intermediate_size": 10944,
             "kv_lora_rank": 512, "max_position_embeddings": 163840,
             "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
             "n_routed_experts": 64, "n_shared_experts": 2, "num_attention_heads": 16,
             "num_experts_per_tok": 6, "num_hidden_layers": 27, "num_key_value_heads": 16,
             "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-6,
             "rope_theta": 10000, "routed_scaling_factor": 1, "topk_group": 1,
             "v_head_dim": 128, "vocab_size": 102400}


@pytest.fixture(scope="module")
def drv():
    return manifest.driver("train_model")


@pytest.fixture(scope="module")
def v2_cfg():
    return json.loads((ROOT / "perfbench/configs/deepseek-v2-lite-ep8.json").read_text())


@pytest.mark.parametrize("cell", [V2, ADAMW])
def test_cells_load_with_their_limits_and_readers(cell):
    c = manifest.resolve(cell)
    assert c.traffic["driver"] == "train_model" and c.chips == 1
    assert {m["name"] for m in c.end_to_end} == {"train_tokens_per_s", "setup_s"}
    want = {"loss", "seen_grad", "change"} | ({"tracker_sigma"} if cell == V2 else set())
    assert set(c.limits["limits"]) == want
    for m in c.per_layer:
        assert callable(manifest.layer_reader(m["name"]))
    names = {m["name"] for m in c.per_layer}
    assert set(NEW_METRICS) <= names if cell == V2 else not names & set(NEW_METRICS)
    assert not names & {"train.fwd_bwd_ms", "train.tracker_ms", "train.optimizer_rest_ms"}


def test_v2_config_is_the_published_one_but_its_cut(v2_cfg):
    reduced = next(c for c in manifest.load_manifest()["configs"]
                   if c["name"] == "deepseek-v2-lite-ep8")["reduced"]
    for key, value in PUBLISHED.items():
        if key in reduced:
            assert v2_cfg[key] != value and v2_cfg["published"][key] == value
        else:
            assert v2_cfg[key] == value, key
    ep = v2_cfg["expert_parallel"]
    assert ep["chips"] * v2_cfg["n_routed_experts"] == ep["routed_experts"] == 64
    assert ep["chips"] * v2_cfg["vocab_size"] == ep["vocab_size"] == 102400
    assert v2_cfg["rope_scaling"] == {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                                      "mscale": 0.707, "mscale_all_dim": 0.707,
                                      "original_max_position_embeddings": 4096, "type": "yarn"}


def test_driver_builds_the_port_config_and_refuses_what_it_does_not_know(drv, v2_cfg):
    mc = drv.model_config(v2_cfg)
    m, a = mc.moe, mc.mla
    assert (mc.n_layers, mc.d_model, mc.d_ff, mc.vocab_size) == (27, 2048, 10944, 12800)
    assert (m.n_routed, m.n_held, m.held_start, m.top_k, m.d_ff_expert) == (64, 8, 0, 6, 1408)
    assert (m.first_dense, m.norm_topk, m.seq_aux_alpha, m.n_shared) == (1, False, 0.001, 2)
    assert (a.kv_lora_rank, a.yarn.factor, a.yarn.original_max_position) == (512, 40, 4096)
    for bad in ({"dropout": 0.1}, {"scoring_func": "sigmoid"}, {"routed_scaling_factor": 2.5},
                {"rope_scaling": dict(v2_cfg["rope_scaling"], type="linear")},
                {"expert_parallel": dict(v2_cfg["expert_parallel"], chips=4)}):
        with pytest.raises(ValueError):
            drv.model_config(dict(v2_cfg, **bad))
    granite = manifest.resolve(ADAMW).config
    assert drv.model_config(granite).n_layers == 3
    with pytest.raises(ValueError, match="does not know"):
        drv.model_config(dict(granite, sliding_window=4096))


def test_counts_by_hand(v2_cfg):
    # MLA: wq 2048 x 16*192, w_dkv 2048 x 576, w_uk and w_uv 512 x 2048, wo 2048 x 2048
    mla = 2048 * 3072 + 2048 * 576 + 2 * 512 * 2048 + 2048 * 2048
    assert dcount.mla_params(v2_cfg) == mla == 13_762_560
    # a token: 1 dense layer (SwiGLU 10944), 26 MoE layers (router 64, 6 x 8/64 of three
    # 2048 x 1408 experts, two shared experts as one SwiGLU of 2816), the head over 12800
    moe = 2048 * 64 + 0.75 * 3 * 2048 * 1408 + 3 * 2048 * 2816
    tok = (mla + 3 * 2048 * 10944) + 26 * (mla + moe) + 2048 * 12800
    assert dcount.token_params(v2_cfg) == pytest.approx(tok, rel=1e-15)
    attn = 6 * 27 * 2 * 4096 * 4096 * 16 * (128 + 64 + 128)
    flops = dcount.step_flops(v2_cfg, 2, 4096)
    assert flops == pytest.approx(6 * tok * 2 * 4096 + attn, rel=1e-15)
    assert flops == pytest.approx(8.129e13, rel=1e-3)


def test_readers_of_the_new_metrics(v2_cfg):
    rec = {"steps": 10, "step_s": 3.0, "model": v2_cfg,
           "program_spans": [{"train_step": 3000.0, "fwd_bwd": 2800.0, "mla": 2000.0,
                              "moe": 600.0}] * 2}
    read = {m: manifest.layer_reader(m)(rec) for m in NEW_METRICS}
    assert read["train_mfu.moe"] == pytest.approx(
        100 * dcount.step_flops(v2_cfg, 2, 4096) / 3.0 / 989e12)
    assert (read["train.span.mla_ms"], read["train.span.moe_ms"]) == (2000.0, 600.0)
    assert all(manifest.layer_reader(m)({}) is None for m in NEW_METRICS[1:])
    granite = manifest.resolve(ADAMW).config
    assert manifest.layer_reader("train_mfu.moe")({"steps": 1, "step_s": 1.0,
                                                   "model": granite}) is None


def small(cell_name: str):
    """The cell at test size: every width cut, every rule kept."""
    cell = copy.deepcopy(manifest.resolve(cell_name))
    if cell_name == ADAMW:
        cell.config.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_head=16, d_ff=128,
                           vocab_size=512, vocab_pad_to=64, seq_len=32, global_batch=1)
        return cell
    cell.config.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                       intermediate_size=96, kv_lora_rank=32, qk_nope_head_dim=16,
                       qk_rope_head_dim=8, v_head_dim=16, moe_intermediate_size=32,
                       n_routed_experts=2, num_experts_per_tok=2, num_hidden_layers=3,
                       vocab_size=512, vocab_pad_to=64, moe_group_size=16, seq_len=32)
    cell.config["expert_parallel"] = dict(cell.config["expert_parallel"], chips=4, rank=1,
                                          routed_experts=8)
    cell.traffic["optimizer"]["spectral_rank"] = 4
    return cell


@pytest.mark.parametrize("cell_name", [V2, ADAMW])
def test_cells_run_at_test_size(drv, cell_name):
    cell = small(cell_name)
    ctx = Ctx(cell, seed=2 ** 33 + 11, seconds=0.3)
    out = drv.run(ctx)
    line = result_line(cell, out, 0.0, False, None, "cpu")
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(line["checks"]) == set(cell.limits["limits"])
    assert line["metrics"]["train_tokens_per_s"]["value"] > 0
    if cell_name == ADAMW:
        assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell_name", [V2, ADAMW])
def test_control_is_not_correct(drv, cell_name):
    """The reference with float8 products in the program's place fails one of
    the cell's limits."""
    cell = small(cell_name)
    cfg, traffic = cell.config, cell.traffic
    api, opt = drv.program(cfg, traffic)
    for seed in (5, 6):
        _, prog = drv.program_readings(cfg, traffic, seed, "cpu", api, opt)
        want = drv.reference(cfg, traffic, seed, "cpu", align=prog["align"])
        ctl = drv.reference(cfg, traffic, seed, "cpu", fmt="float8", align=prog["align"])
        assert not passes(checks_of(drv.compare(ctl, want, traffic), cell.limits)), seed
        assert torch.isfinite(torch.tensor(prog["losses"])).all()
