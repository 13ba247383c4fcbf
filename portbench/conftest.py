"""Small cells for the benchmark's own CPU tests: the harness's drivers
run the program's plain path (the flash route's plain version on the CPU)
at sizes a test run holds, with the cells' own settings and limits."""
import json
import pathlib

import pytest

from portbench.core import spec

ROOT = pathlib.Path(__file__).resolve().parent

TINY = {
    "moe": {"name": "tiny-moe", "family": "moe", "n_layers": 2, "d_model": 64,
            "n_heads": 4, "n_kv_heads": 4, "d_head": 16, "d_ff": 32,
            "vocab": 256, "act": "swiglu", "rope_theta": 50000.0,
            "moe_experts": 4, "moe_top_k": 2, "moe_capacity_factor": 1.25,
            "moe_shard_experts": True, "norm_eps": 1e-5,
            "dtype": "float32", "remat": True},
    "hybrid": {"name": "tiny-hybrid", "family": "hybrid", "n_layers": 4,
               "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_head": 16,
               "d_ff": 128, "vocab": 256, "act": "swiglu",
               "rope_theta": 1e4, "swa_window": 32, "ssm_state": 16,
               "ssm_head_dim": 16, "ssm_expand": 2, "ssm_conv": 4,
               "ssm_chunk": 8, "hybrid_attn_every": 2, "norm_eps": 1e-5,
               "dtype": "float32", "remat": True},
}
TRAFFIC = {
    "train": {"kind": "train", "batch": 2, "seq": 32, "zipf_a": 1.0,
              "zipf_q": 2.7, "pool": 4, "first_steps": 3, "trace_steps": 1},
    "prefill": {"kind": "prefill", "batch_tokens": 128,
                "lengths": [16, 16, 32, 16, 64, 16, 32, 16], "n_new": 1,
                "pool": 8},
}
CELL_OF = {("moe", "train"): "moonlight.train.b2s4k",
           ("hybrid", "train"): "zamba2.train.b2s4k",
           ("moe", "prefill"): "moonlight.prefill.mix",
           ("hybrid", "prefill"): "zamba2.prefill.mix"}


def tiny_cell(family: str, kind: str, dtype: str = "float32", **port):
    """A cell of ``family`` and ``kind`` at a test size, with the settings
    and limits of the benchmark's cell of that family and kind."""
    settings = json.loads((ROOT / "workloads" /
                           f"{CELL_OF[family, kind]}.json").read_text())
    p = dict(TINY[family], dtype=dtype, **port)
    return spec.Cell(f"tiny.{family}.{kind}", {"chips": 1}, {"port": p},
                     dict(TRAFFIC[kind]), settings, [], [])


@pytest.fixture
def cell_factory():
    return tiny_cell
