"""The benchmark's own counts against hand counts from published shapes."""
import json
import pathlib

import pytest

from portbench.core import counts, peaks

CONFIGS = pathlib.Path(__file__).resolve().parent / "configs"


def port(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["port"]


def test_moonlight_four_layers_active_params_and_step_flops():
    p = port("moonlight-16b-a3b-l4")
    # per layer: q, k, v, o 4·2048², router 2048·64, 6 experts of 3·2048·1408
    per_layer = 4 * 2048 * 2048 + 2048 * 64 + 6 * 3 * 2048 * 1408
    assert per_layer == 68_812_800
    assert counts.active_matmul_params(p) == 4 * per_layer + 2048 * 163_840
    assert counts.active_matmul_params(p) == 610_795_520
    pairs = 4096 * 4097 // 2
    scores = 4 * 128 * pairs * 2 * 16 * 4           # QKᵀ + PV, 4 layers
    want = 6 * 610_795_520 * 8192 + 3 * scores
    assert counts.model_flops(p, 2, 4096, "train") == want
    assert counts.model_flops(p, 2, 4096, "train") / 1e12 == pytest.approx(
        31.67, abs=0.005)


def test_flash_forward_bound_at_moonlight_training_shape():
    flops, nbytes = counts.flash_call("flash_fwd", 2, 4096, 16, 16, 128)
    assert flops == 4 * 128 * (4096 * 4097 // 2) * 2 * 16
    assert flops / 1e9 == pytest.approx(137.47, abs=0.005)
    # q, k, v and out bf16, one f32 row statistic
    assert nbytes == 4 * 2 * 4096 * 16 * 128 * 2 + 2 * 16 * 4096 * 4
    assert counts.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.139, abs=5e-4)
    p = port("moonlight-16b-a3b-l4")
    fwd = counts.flash_bound_s("flash_fwd", p, 2, 4096)
    assert counts.flash_bound_s("flash_bwd_dkv", p, 2, 4096) == \
        pytest.approx(2 * fwd)
    assert counts.flash_bound_s("flash_bwd_dq", p, 2, 4096) == \
        pytest.approx(1.5 * fwd)


def test_zamba2_counts():
    p = port("zamba2-1.2b")
    mixer = 2048 * (2 * 4096 + 2 * 64 + 64) + 4096 * 2048
    # the shared block's 32 heads of 128 span 4096 columns
    shared = 4 * 2048 * 4096 + 3 * 2048 * 8192
    assert counts.attn_calls(p) == 6
    assert counts.active_matmul_params(p) == \
        38 * mixer + 6 * shared + 2048 * 32_000
    score = 4 * 128 * (4096 * 4097 // 2) * 2 * 32 * 6
    assert counts.model_flops(p, 2, 4096, "train") == \
        6 * counts.active_matmul_params(p) * 8192 + 3 * score
    # a prefill runs the head on the last position only
    assert counts.model_flops(p, 4, 1024, "prefill") == (
        2 * counts.block_matmul_params(p) * 4096 + 2 * 2048 * 32_000 * 4
        + 4 * 128 * (1024 * 1025 // 2) * 4 * 32 * 6)


def test_sliding_window_pairs_and_peaks():
    assert counts.causal_pairs(8) == 36
    assert counts.causal_pairs(8, 3) == 6 + 5 * 3
    assert counts.causal_pairs(8, 8) == 36
    assert peaks.PEAK_FLOPS["bfloat16"] == 989.4e12
    assert counts.flash_kind("void flash_bwd_dkv_wgmma<128>(...)") == \
        "flash_bwd_dkv"
    assert counts.flash_kind("flash_fwd_wgmma") == "flash_fwd"
    assert counts.flash_kind("nvjet_tst_64x8") is None
