"""The plain references against NumPy's SVD and hand-written steps, the
program against the references at a test size (``correct`` true), and each
cell's control (the reference one precision down, in the program's place)
coming out as not correct."""

import math

import numpy as np
import pytest
import torch

import _cells
from _cells import GRANITE, SVD, small

from perfbench.harness import manifest
from perfbench.inputs import granite as gin
from perfbench.reference import granite as gref
from perfbench.reference import svd_stream as sref
from perfbench.run import checks_of, passes


def _state(rng, m, n, r, spread=(10.0, 1.0)):
    u, _ = np.linalg.qr(rng.standard_normal((m, r)))
    v, _ = np.linalg.qr(rng.standard_normal((n, r)))
    return u, np.geomspace(*spread, r), v


def test_truncated_update_is_the_best_rank_r_of_the_sum():
    rng = np.random.default_rng(0)
    m, n, r = 12, 20, 4
    u, s, v = _state(rng, m, n, r)
    a, b = rng.standard_normal(m), rng.standard_normal(n)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))[None]  # noqa: E731
    nu, ns, nv = (x[0].numpy() for x in sref.truncated_update(t(u), t(s), t(v), t(a), t(b)))
    w_u, w_s, w_vt = np.linalg.svd(u @ np.diag(s) @ v.T + np.outer(a, b))
    np.testing.assert_allclose(ns, w_s[:r], rtol=1e-12)
    np.testing.assert_allclose(nu @ np.diag(ns) @ nv.T, w_u[:, :r] @ np.diag(w_s[:r]) @ w_vt[:r],
                               atol=1e-12 * w_s[0])
    np.testing.assert_allclose(nu.T @ nu, np.eye(r), atol=1e-12)


def test_replay_applies_each_streams_events_in_order():
    rng = np.random.default_rng(1)
    m, n, r = 10, 14, 3
    states = [_state(rng, m, n, r) for _ in range(2)]
    pool_a, pool_b = rng.standard_normal((6, m)), rng.standard_normal((6, n))
    order = [[0, 3, 5, 1], [2, 4]]
    got = sref.replay(*(torch.from_numpy(np.stack([st[k] for st in states])) for k in range(3)),
                      torch.from_numpy(pool_a), torch.from_numpy(pool_b), order)
    for i, (u, s, v) in enumerate(states):
        x = u @ np.diag(s) @ v.T
        for j in order[i]:       # the exact rank-r truncation after each event
            wu, ws, wvt = np.linalg.svd(x + np.outer(pool_a[j], pool_b[j]))
            x = wu[:, :r] @ np.diag(ws[:r]) @ wvt[:r]
        recon = got[0][i].numpy() @ np.diag(got[1][i].numpy()) @ got[2][i].numpy().T
        np.testing.assert_allclose(recon, x, atol=1e-12 * ws[0])
    assert sref.gaps(got, got) == {"recon": 0.0, "sigma": 0.0}


def _hand_loss(params, batch, cfg):
    """The decoder's loss written out head by head (LayerNorm, Q/K/V biases,
    a tanh-GELU MLP), with bf16-rounded product operands."""
    q = lambda x: x.to(torch.bfloat16).to(torch.float32)  # noqa: E731

    def ln(x, p):
        mu = x.mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-5) * p["w"] + p["b"]

    d, h, dh = cfg["d_model"], cfg["n_heads"], cfg["d_head"]
    toks, labels = batch["tokens"][0].long(), batch["labels"][0].long()
    s = toks.shape[0]
    x = params["embed"]["table"][toks]
    half = dh // 2
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(half, dtype=torch.float32) / half))
    ang = torch.arange(s, dtype=torch.float32)[:, None] * inv[None]

    def rope(t):
        return torch.cat([t[:, :half] * ang.cos() - t[:, half:] * ang.sin(),
                          t[:, half:] * ang.cos() + t[:, :half] * ang.sin()], dim=1)

    L = params["layers"]
    for li in range(cfg["n_layers"]):
        at = {k: w[li] for k, w in L["attn"].items()}
        xn = ln(x, {k: w[li] for k, w in L["ln1"].items()})
        qa = q(xn) @ q(at["wq"]) + at["bq"]
        ka = rope(q(xn) @ q(at["wk"]) + at["bk"])          # one KV head
        va = q(xn) @ q(at["wv"]) + at["bv"]
        heads = []
        for hh in range(h):
            qh = rope(qa[:, hh * dh:(hh + 1) * dh])
            sc = (q(qh) @ q(ka).T) / math.sqrt(dh)
            sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), -1e30)
            heads.append(q(torch.softmax(sc, -1)) @ q(va))
        x = x + q(torch.cat(heads, 1)) @ q(at["wo"])
        xn = ln(x, {k: w[li] for k, w in L["ln2"].items()})
        z = q(xn) @ q(L["mlp"]["wi"][li])
        g = 0.5 * z * (1 + torch.tanh(math.sqrt(2 / math.pi) * (z + 0.044715 * z ** 3)))
        x = x + q(g) @ q(L["mlp"]["wd"][li])
    logits = q(ln(x, params["final_norm"])) @ q(params["head"])
    return torch.mean(torch.logsumexp(logits, -1) - logits[torch.arange(s), labels])


def test_granite_reference_loss_is_the_hand_written_one():
    cell = small(GRANITE)
    cfg = cell.config
    assert (cfg["mlp_type"], cfg["norm_type"], cfg["qkv_bias"]) == ("gelu", "layernorm", True)
    params = gin.make_weights(cfg, 3, "cpu")
    gen = torch.Generator().manual_seed(3)
    for path, shape, scale in gin.leaf_specs(cfg):   # biases and norm weights off their init
        if scale in (gin.ONES, gin.ZEROS):
            leaf = params
            for k in path[:-1]:
                leaf = leaf[k]
            leaf[path[-1]] = leaf[path[-1]] + 0.1 * torch.randn(shape, generator=gen)
    batch = gin.Batches(cfg, 3, "cpu").next()
    want = _hand_loss(params, batch, cfg)
    got = gref.loss(params, batch, cfg)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert abs(float(got) - math.log(cfg["vocab_size"])) < 1.0


def test_granite_reference_first_step_is_hand_written_adamw():
    """A leaf without a tracker after one step at a learning rate of lr:
    p - lr (g / (|g| + eps) + wd p) in float32 (Adam's first step is the
    gradient's sign to within eps, with both bias corrections)."""
    cell = small(GRANITE)
    cfg, traffic = cell.config, cell.traffic
    traffic["optimizer"].update(warmup_steps=0, total_steps=10 ** 9)
    o = traffic["optimizer"]
    params = gin.make_weights(cfg, 4, "cpu")
    _, grads = gref.loss_and_grads(params, gin.Batches(cfg, 4, "cpu").next(), cfg)
    out = gref.run_steps(cfg, traffic, 4, "cpu", 1)
    for i, (path, _, _) in enumerate(gin.leaf_specs(cfg)):
        if path in out["trackers"]:
            continue
        p0, g = gin.make_leaf(cfg, 4, i, "cpu"), grads[path]
        p1 = p0 - o["lr"] * (g / (g.abs() + o["eps"]) + o["weight_decay"] * p0)
        assert out["change_norm"][path] == pytest.approx(float((p1 - p0).double().norm()),
                                                         rel=1e-5)
        assert out["seen_grad_norm"][path] == pytest.approx(float(g.double().norm()), rel=1e-5)


def test_program_matches_the_references_at_test_size():
    for name in (GRANITE, SVD):
        _, line = _cells.run(small(name))
        assert line["correct"], (name, line["checks"])


def test_granite_control_is_not_correct():
    """float8 products in the program's place fail one of the numbers."""
    drv = manifest.driver("train_step")
    cell = small(GRANITE)
    cfg, traffic = cell.config, cell.traffic
    api, opt = drv.program(cfg, traffic)
    for seed in (5, 6, 7):
        _, _, _, prog = drv.program_readings(cfg, traffic, seed, "cpu", api, opt)
        want = gref.run_steps(cfg, traffic, seed, "cpu", drv.COMPARED, align=prog["align"])
        ctl = gref.run_steps(cfg, traffic, seed, "cpu", drv.COMPARED, fmt="float8",
                             align=prog["align"])
        assert not passes(checks_of(drv.compare(ctl, want), cell.limits)), seed


def test_svd_control_is_not_correct():
    """The float64 service's replay in float32 in the program's place fails."""
    from perfbench.inputs import svd_stream as sin

    cell = small(SVD)
    cfg, traffic = cell.config, cell.traffic
    for seed in (5, 6, 7):
        u0, s0, v0 = sin.make_states(cfg, traffic, seed, "cpu")
        pa, pb = (torch.from_numpy(x) for x in sin.make_pool(cfg, traffic, seed, "cpu"))
        idx = [sin.event_indices(cfg, traffic, i, 200) for i in range(cfg["streams"])]
        want = sref.replay(u0, s0, v0, pa, pb, idx)
        ctl = sref.replay(u0, s0, v0, pa, pb, idx, dtype=torch.float32)
        nums = dict(sref.gaps(ctl, want), never_visible=0.0, bad_tokens=0.0)
        assert not passes(checks_of(nums, cell.limits)), seed
