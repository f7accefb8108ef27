"""The port's launch tier (``repro_torch.launch``) against the reference's
arithmetic, and its dry-run on the meta device.

* ``model_flops`` / ``_active_param_count`` equal the reference's for every
  config and shape, and ``svd_update_flops``, ``sketch_flops`` and
  ``sparse_lowering_flops`` at a grid of sizes, exactly.
* ``collective_bytes`` on a tree of three leaves against a count by hand;
  ``HW`` takes the H100's data-sheet peaks.
* The dry-run's counts on the meta device equal the same step's counts on
  real CPU tensors; its depth-affine extrapolation equals the full count on
  a dense decoder at smoke depth; its JSON keeps the reference's schema and
  ``report.markdown_table`` reads two of them.
* ``perf_iter --svd``'s cells run on the CPU (``device="cpu"``), counted
  and timed; every variant's knob exists in the port's config.
"""

import json

import numpy as np
import pytest
import torch

from _torch_helpers import ref
from repro_torch import configs as PCFG
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.data.synthetic import batch_for_step
from repro_torch.dist import param_pspecs
from repro_torch.launch import dryrun, perf_iter, report, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw_init

RCFG = ref("configs")
RBASE = ref("configs.base")
RROOF = ref("launch.roofline")

# the keys of the reference's dry-run JSON (src/repro/launch/dryrun.py)
SCHEMA = {"arch", "shape", "mesh", "devices", "method", "compile_s", "memory", "cost",
          "collectives", "roofline", "model_flops_global", "model_flops_per_device",
          "useful_flops_ratio", "extrapolation"}


def test_production_mesh_is_meta():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16} and two.size == 512
    assert {d.type for d in two.devices.flat} == {"meta"}


@pytest.mark.parametrize("arch", PCFG.ARCH_IDS)
def test_model_flops_equal_reference(arch):
    for get_p, get_r in ((PCFG.get, RCFG.get), (PCFG.get_smoke, RCFG.get_smoke)):
        p_cfg, r_cfg = get_p(arch), get_r(arch)
        assert roofline._active_param_count(p_cfg) == RROOF._active_param_count(r_cfg)
        for name in SHAPES:
            got = roofline.model_flops(p_cfg, SHAPES[name])
            assert got == RROOF.model_flops(r_cfg, RBASE.SHAPES[name]), name
            assert got > 0


def test_svd_sketch_and_sparse_flops_equal_reference():
    for m, n, r, b in [(1, 1, 1, 1), (64, 96, 8, 8), (256, 512, 8, 64), (512, 768, 16, 16),
                       (1024, 4096, 32, 8), (4096, 1024, 255, 3)]:
        assert roofline.svd_update_flops(m, n, r, b) == RROOF.svd_update_flops(m, n, r, b)
        for k, over, power in [(1, 0, 0), (8, 8, 1), (32, 4, 2), (600, 8, 1)]:
            assert roofline.sketch_flops(m, n, k, oversample=over, power_iters=power, batch=b) \
                == RROOF.sketch_flops(m, n, k, oversample=over, power_iters=power, batch=b)
            for nnz in (0, 17, m * n // 3):
                assert roofline.sparse_lowering_flops(m, n, k, nnz, oversample=over, batch=b) \
                    == RROOF.sparse_lowering_flops(m, n, k, nnz, oversample=over, batch=b)


def test_hw_peaks_and_terms():
    assert roofline.HW(8).link_bw == roofline.NVLINK_BW == 450e9
    assert roofline.HW(9).link_bw == roofline.NET_BW == 50e9
    hw = roofline.HW(256)
    assert (hw.peak_flops, hw.hbm_bw) == (989e12, 3.35e12)
    terms = roofline.roofline_terms({"flops": 989e12, "bytes accessed": 6.7e12},
                                    {"all-gather": 25e9, "all-reduce": 25e9, "count": 3}, hw)
    assert terms["t_compute_s"] == 1.0 and terms["t_memory_s"] == 2.0
    assert terms["t_collective_s"] == 1.0 and terms["collective_bytes_per_device"] == 50e9


def test_collective_bytes_by_hand():
    """Three leaves on a (data 4, model 2) mesh, 64 tokens, a train step with
    the ZeRO-3 gather in bf16:

    * ``layers.w`` (2, 32, 48) f32, spec (None, data, model): 3072 entries cut
      in 8.  Gather 3072 * 2 B * 7/8 = 5376; reduce-scatter of the gradient
      over data, 12288 B / 2 model pieces * 3/4 = 4608; two applications of a
      model-split product, 16 tokens a device x 48/2 columns x 4 B, all-reduced
      over model (2 * 1/2) in the forward and backward: 2 * 2 * 2 * 16 * 24 *
      4 / 2 = 6144; 1 + 1 + 4 collectives.
    * ``head`` (32, 48) f32, spec (data, model): gather 2688, reduce-scatter
      2304, all-reduce 3072, 1 + 1 + 2 collectives.
    * ``g`` (48,) f32, replicated: its gradient all-reduced over data,
      2 * 192 * 3/4 = 288, one collective.
    """
    params = {"layers": {"w": torch.empty(2, 32, 48, device="meta")},
              "head": torch.empty(32, 48, device="meta"), "g": torch.empty(48, device="meta")}
    specs = param_pspecs(params)
    assert specs == {"layers": {"w": (None, "data", "model")}, "head": ("data", "model"),
                     "g": ()}
    got = roofline.collective_bytes(params, specs, tokens=64, train=True, gather=True,
                                    compute_dtype="bfloat16",
                                    sizes={"pod": 2, "data": 4, "model": 2})
    assert got == {"all-gather": 5376 + 2688, "reduce-scatter": 4608 + 2304,
                   "all-reduce": 6144 + 3072 + 288, "all-to-all": 0.0,
                   "collective-permute": 0.0, "count": 11}
    # inference: no gather, no gradients, the products' all-reduce once
    got = roofline.collective_bytes(params, specs, tokens=64, train=False, gather=False,
                                    sizes={"pod": 2, "data": 4, "model": 2})
    assert got["all-reduce"] == (6144 + 3072) / 2 and got["count"] == 3
    assert got["all-gather"] == got["reduce-scatter"] == 0.0


def test_meta_counts_equal_a_cpu_run():
    """The dry-run's step on meta tensors counts what it counts on real ones."""
    cfg = PCFG.get_smoke("deepseek-v2-lite-16b")
    api = build_model(cfg)
    counts = []
    for dev in ("meta", "cpu"):
        if dev == "meta":
            params = api.init(None, device="meta")
            batch = {k: torch.zeros(2, 32, dtype=torch.int32, device="meta")
                     for k in ("tokens", "labels")}
        else:
            params = api.init(torch.Generator().manual_seed(0), device="cpu")
            batch = batch_for_step(0, 0, batch=2, seq=32, vocab=cfg.vocab_size, device="cpu")
        state = adamw_init(params)
        counts.append(dryrun.count_ops(lambda p=params, s=state, b=batch:
                                       dryrun._train_step(api, p, s, b)))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][1] > 0


def test_affine_extrapolation_equals_the_full_count(tmp_path):
    cfg = PCFG.get_smoke("granite-34b")
    full = dryrun.run_cell("granite-34b", "train_4k", multi_pod=False, out_dir=tmp_path,
                           cfg_override=cfg)
    fast = dryrun.run_cell("granite-34b", "train_4k", multi_pod=False, out_dir=tmp_path,
                           cfg_override=cfg, extrapolate=True, method_tag="affine")
    assert cfg.n_layers == 3 and fast["extrapolation"]["depth_units"] == 3
    for key in ("flops", "bytes accessed"):
        assert fast["cost"][key] == full["cost"][key] > 0
    assert fast["collectives"] == full["collectives"]
    assert fast["memory"] == full["memory"]


def test_dryrun_json_and_report(tmp_path):
    cfg = PCFG.get_smoke("qwen1.5-32b")
    rows = [dryrun.run_cell("qwen1.5-32b", shape, multi_pod=False, out_dir=tmp_path,
                            cfg_override=cfg) for shape in ("train_4k", "decode_32k")]
    files = sorted(tmp_path.glob("*.json"))
    assert [f.name for f in files] == ["qwen1.5-32b__decode_32k__16x16.json",
                                       "qwen1.5-32b__train_4k__16x16.json"]
    loaded = report.load(tmp_path)
    assert SCHEMA <= set(loaded[0]) and loaded[1] == json.loads(json.dumps(rows[0]))
    for r in loaded:
        assert r["devices"] == 256 and r["memory"]["peak_bytes"] is None
        assert r["roofline"]["flops_per_device"] * 256 == r["cost"]["flops_global"]
        assert 0 < r["useful_flops_ratio"] < 1.5
    table = report.markdown_table(loaded, mesh="16x16").splitlines()
    assert table[0].startswith("| arch | shape | t_comp (ms)") and len(table) == 4
    for line, r in zip(table[2:], loaded):
        fr = report.fmt_row(r)
        cells = [c.strip() for c in line.strip("|").split("|")]
        assert cells[:2] == [r["arch"], r["shape"]]
        assert cells[2] == f"{fr['t_compute_ms']:.2f}" and cells[5] == fr["bottleneck"]
        assert cells[7] == "-"
    assert report.markdown_table(loaded, mesh="2x16x16").count("\n") == 1


def test_dryrun_cli(tmp_path, capsys):
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "OK   whisper-base__decode_32k__16x16" in out
    rec = json.loads((tmp_path / "whisper-base__decode_32k__16x16.json").read_text())
    assert SCHEMA <= set(rec) and rec["counted"] == dryrun.COUNTED
    assert rec["memory"]["argument_bytes"] > 0


def test_perf_iter_svd_cells_on_cpu(tmp_path):
    recs = perf_iter.run_svd_cells(tmp_path, device="cpu",
                                   cells=[(16, 24, 4, 2, None), (16, 24, 4, 2, 3)])
    assert [r["shape"] for r in recs] == ["B2_m16_n24_r4", "B2_m16_n24_r4_k3"]
    for r, k in zip(recs, (1, 3)):
        assert r["model_flops"] == RROOF.svd_update_flops(16, 24, 4, 2) * k
        assert r["roofline"]["flops_per_device"] > 0 and r["seconds"] > 0
        assert r["useful_flops_ratio"] == r["model_flops"] / r["roofline"]["flops_per_device"]
        assert (tmp_path / f"svd_{r['shape']}.json").exists()
    assert recs[1]["roofline"]["flops_per_device"] > recs[0]["roofline"]["flops_per_device"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            perf_iter.run_svd_cell(16, 24, 4, 2, out_dir=tmp_path)


def test_perf_iter_variants_set_the_ports_knobs():
    for (arch, shape), variants in perf_iter.VARIANTS.items():
        assert (arch, shape) in PCFG.cells()
        base = PCFG.get(arch)
        for tag, mutate, kw in variants:
            cfg = mutate(base)
            assert cfg.name == base.name, tag
            assert set(kw) <= {"cache_seq_fallback"}, tag
    assert perf_iter.SVD_CELLS and perf_iter.FLEET_CELLS


def test_the_t1_check_counts_products_once_a_pass():
    """The compute term chip_smoke (m3) holds to (t1)'s measured step: at a
    smoke config its FLOPs exceed 6 N D (forward, backward and remat's second
    forward), and no cell counts more than 4x that (no product counted twice
    over)."""
    cfg = PCFG.get_smoke("granite-34b")
    shape = ShapeConfig("t1", 64, 1, "train")
    c = dryrun.lower_cell(cfg, shape, make_production_mesh(), multi_pod=False, shape_name="t1")
    assert roofline.model_flops(cfg, shape) < c.flops < 4 * roofline.model_flops(cfg, shape)
