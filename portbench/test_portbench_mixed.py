"""The mixed family (Nemotron-H) through the harness on the CPU, at a test
size of its own: the adapter gives the port's tree, prefill serves the
plain reference's best token in f32 (the program and the reference
compute the same function, so every gap is 0), and the cell's limit
refuses the planted faults. The reference's per-group SSD and its blocked
attention are held to plain forms of their own."""
import json
import pathlib
import time

import pytest
import torch

from portbench import faults
from portbench.core import spec
from portbench.drivers import prefill
from portbench.drivers.common import Family
from portbench.reference import common as C
from portbench.reference import mixed

SEED = 2**31 + 12345          # more than 32 signed bits hold
ROOT = pathlib.Path(__file__).resolve().parent

PORT = {"name": "tiny-mixed", "family": "mixed", "n_layers": 5,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 1, "d_head": 16,
        "d_ff": 32, "vocab": 256, "act": "relu2", "rope_theta": 1e4,
        "rope_mode": "none", "moe_experts": 8, "moe_top_k": 2,
        "moe_capacity_factor": 1.25, "moe_scoring": "sigmoid",
        "moe_route_scale": 2.5, "moe_shared_ff": 48, "ssm_state": 16,
        "ssm_head_dim": 16, "ssm_n_heads": 8, "ssm_groups": 2, "ssm_conv": 4,
        "ssm_expand": 2, "ssm_chunk": 8, "layer_pattern": "MEM*E",
        "norm_eps": 1e-5, "dtype": "float32", "remat": True}
TRAFFIC = {"kind": "prefill", "batch_tokens": 128,
           "lengths": [16, 32, 16, 64, 16, 32, 16, 128], "n_new": 1,
           "pool": 8}


def tiny_cell(**port):
    """A prefill cell of the mixed family at a test size, with the
    settings and limits of ``nemotron3.prefill.long``."""
    settings = json.loads(
        (ROOT / "workloads" / "nemotron3.prefill.long.json").read_text())
    return spec.Cell("tiny.mixed.prefill", {"chips": 1},
                     {"port": dict(PORT, **port)}, dict(TRAFFIC), settings,
                     [], [])


def test_adapter_gives_the_ports_tree():
    from repro_torch.models import mamba2 as M, transformer as T
    from repro_torch.optim.optimizer import tree_map
    fam = Family(PORT)
    tree = fam.port_params(SEED, "cpu")
    want = T.init_params_shaped(fam.model_config())
    shapes = tree_map(lambda x: (tuple(x.shape), x.dtype), tree)
    assert shapes == tree_map(lambda x: (tuple(x.shape), x.dtype), want)
    get = fam.getter(SEED, "cpu")
    for leaf in fam.leaves:
        assert torch.equal(fam.view(tree, leaf.name), get(leaf.name))
    # every row of the per-layer constants holds the init's values
    consts = M.ssm_constants(fam.model_config(), torch.float32, "cpu", (5,))
    for k in ("a_log", "dt_bias"):
        torch.testing.assert_close(tree["layers"][k], consts[k])


def test_prefill_serves_the_references_best_token_in_f32():
    cell = tiny_cell()
    res = prefill.run(cell, SEED, 0.2, False, "cpu", time.perf_counter())
    assert res["correct"] and res["numbers"]["gap"] == 0.0
    t = cell.traffic
    assert len(res["readings"]["gaps"]) == sum(
        t["batch_tokens"] // t["lengths"][b % 8]
        for b in res["readings"]["batches"])
    assert 128 in [t["lengths"][b % 8] for b in res["readings"]["batches"]]


@pytest.mark.parametrize("fault", sorted(faults.PREFILL_FAULTS))
def test_prefill_faults_are_not_correct(fault):
    cell = tiny_cell()
    res = prefill.run(cell, SEED, 0.1, False, "cpu", time.perf_counter(),
                      wrap_generate=faults.PREFILL_FAULTS[fault])
    assert not res["correct"]
    for name, limit in cell.settings["limits"].items():
        assert res["numbers"][name] > limit


def test_bias_changes_some_choices():
    """The router's drawn bias changes some top-k choices against plain
    sigmoid top-k, at the configuration's widths of the router, on
    unit-rms inputs: about 65 % of the tokens, 13 % of the choices."""
    conf = json.loads((ROOT / "configs" /
                       "nemotron3-nano-30b-a3b-s1.json").read_text())["port"]
    g = torch.Generator().manual_seed(0)
    d, e, k = conf["d_model"], conf["moe_experts"], conf["moe_top_k"]
    x = torch.randn(2048, d, generator=g)
    scores = torch.sigmoid(x @ (torch.randn(d, e, generator=g) * d ** -0.5))
    bias = torch.randn(e, generator=g) * mixed.BIAS_SCALE
    plain = scores.topk(k).indices.sort(-1).values
    steered = (scores + bias).topk(k).indices.sort(-1).values
    tokens = (plain != steered).any(-1).float().mean()
    kept = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(plain, steered)) / plain.numel()
    assert 0.5 < float(tokens) < 0.8 and 0.08 < 1 - kept < 0.2


def test_grouped_ssd_is_each_heads_plain_scan():
    """``mixed.heads_ssd`` against the recurrence h_t = exp(a_t) h_{t-1} +
    x_t B_tᵀ, y_t = h_t C_t, each head with its own B and C."""
    g = torch.Generator().manual_seed(1)
    b, s, h, p, n = 2, 24, 3, 4, 5
    x = torch.randn(b, s, h, p, generator=g, dtype=torch.float64)
    a = -torch.rand(b, s, h, generator=g, dtype=torch.float64)
    bm, cm = (torch.randn(b, s, h, n, generator=g, dtype=torch.float64)
              for _ in range(2))
    got = mixed.heads_ssd(x, a, bm, cm, 8)
    st = torch.zeros(b, h, p, n, dtype=torch.float64)
    for t in range(s):
        st = torch.exp(a[:, t])[..., None, None] * st \
            + x[:, t, ..., None] * bm[:, t, :, None, :]
        torch.testing.assert_close(got[:, t], (st @ cm[:, t, ..., None])[..., 0])


def test_blocked_attention_is_plain_causal_attention():
    p = dict(PORT, n_layers=1, layer_pattern="*")
    g = torch.Generator().manual_seed(2)
    leaves = {leaf.name: torch.randn(leaf.shape, generator=g) * 0.3
              for leaf in mixed.layout(p) if leaf.name.startswith("attn.")}
    x = torch.randn(2, 40, 64, generator=g)
    old, mixed.Q_BLOCK = mixed.Q_BLOCK, 16
    try:
        got = mixed.attention(leaves.__getitem__, 0, x, p, C.Prec())
    finally:
        mixed.Q_BLOCK = old
    q = (x @ leaves["attn.wq"][0]).view(2, 40, 4, 16).transpose(1, 2)
    kk = (x @ leaves["attn.wk"][0]).view(2, 40, 1, 16).transpose(1, 2)
    vv = (x @ leaves["attn.wv"][0]).view(2, 40, 1, 16).transpose(1, 2)
    want = torch.nn.functional.scaled_dot_product_attention(
        q, kk.expand(-1, 4, -1, -1), vv.expand(-1, 4, -1, -1),
        is_causal=True).transpose(1, 2).reshape(2, 40, 64) \
        @ leaves["attn.wo"][0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
