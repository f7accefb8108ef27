"""The frozen counts against hand counts."""

import pytest

from _cells import ROOT  # noqa: F401

from perfbench.counts import granite, kernel_b, peaks

GRANITE = dict(n_layers=2, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128, d_ff=24576,
               vocab_size=49152, mlp_type="swiglu", tie_embeddings=False)


def test_granite_matrix_params_by_hand():
    # per layer: wq 6144^2, wk and wv 6144 x 128, wo 6144^2, three MLP 6144 x 24576
    layer = 6144 * 6144 * 2 + 6144 * 128 * 2 + 3 * 6144 * 24576
    assert granite.matrix_params(GRANITE) == 2 * layer + 6144 * 49152 == 1_362_100_224


def test_granite_step_flops_by_hand():
    dense = 6 * 1_362_100_224 * 4096
    attn = 2 * 12 * 4096 * 4096 * 48 * 128      # 2 layers, 12 s^2 h d_head
    assert granite.step_flops(GRANITE, 1, 4096) == pytest.approx(dense + attn, rel=0, abs=0.5)
    assert granite.step_flops(GRANITE, 1, 4096) == pytest.approx(3.5949e13, rel=1e-4)


def test_granite_config_as_run_by_hand():
    """The configuration file the cell runs: three layers of the GELU block."""
    import json

    cfg = json.loads((ROOT / "perfbench/configs/granite-34b-3L.json").read_text())
    # per layer: wq 6144^2, wk and wv 6144 x 128, wo 6144^2, wi and wd 6144 x 24576
    layer = 6144 * 6144 * 2 + 6144 * 128 * 2 + 2 * 6144 * 24576
    assert granite.matrix_params(cfg) == 3 * layer + 6144 * 49152 == 1_439_170_560
    dense = 6 * 1_439_170_560 * 4096
    attn = 3 * 12 * 4096 * 4096 * 48 * 128
    assert granite.step_flops(cfg, 1, 4096) == pytest.approx(dense + attn, rel=0, abs=0.5)


def test_kernel_b_by_hand():
    m, n, r = 1024, 4096, 32
    # projections and residuals 4 (m + n) r, norms 2 (m + n), core 22 (r+1)^3,
    # rotations 2 (m + n)(r + 1) r
    assert kernel_b.ops(m, n, r) == 4 * 5120 * 32 + 2 * 5120 + 22 * 33 ** 3 + 2 * 5120 * 33 * 32
    # U (1024 x 32), s (32), V (4096 x 32) read and written, a and b read, 8 bytes each
    assert kernel_b.bytes_moved(m, n, r, 8) == (2 * (32768 + 32 + 131072) + 5120) * 8
    t, bound = kernel_b.least_seconds(m, n, r, 8, peaks.F64_FLOPS, peaks.HBM_BYTES_PER_S)
    assert bound == "bytes" and t == pytest.approx(2_662_912 / 3.35e12)


def test_peaks_are_the_data_sheet():
    assert (peaks.BF16_FLOPS, peaks.F32_FLOPS, peaks.F64_FLOPS, peaks.HBM_BYTES_PER_S) == \
        (989e12, 67e12, 67e12, 3.35e12)
