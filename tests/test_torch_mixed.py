"""The port's ``mixed`` family (Nemotron-H: Mamba2, MoE and attention
layers in a given order) inside the port, with no JAX reference: that
package has no such family. ``portbench/test_portbench_mixed.py`` holds it
against the benchmark's plain reference.

Decode after prefill against the full forward within ``1e-5`` (f32, a
handful of layers: the chunked SSD and the recurrence sum in other
orders, as ``tests/test_torch_mamba2.py``'s own bound at this depth); the
capacity is set so that no choice is dropped, where a decode step and the
forward would route alike. Groups of B and C repeated across groups, and
the sigmoid router's choices and gates, exactly.
"""
import dataclasses

import pytest
import torch

import repro_torch.configs as C
from repro_torch.launch import serve, sharding, train
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import mamba2 as M, moe as MOE, transformer as T

torch.set_num_threads(1)


def _cfg(**kw):
    cfg = C.get_reduced("nemotron3_nano_30b_a3b")
    # every expert may take every token: nothing is dropped
    kw.setdefault("moe_capacity_factor", cfg.moe_experts / cfg.moe_top_k)
    return dataclasses.replace(cfg, **kw)


def _params(cfg, seed=0):
    params = T.init_params(torch.Generator().manual_seed(seed), cfg, "cpu")
    # a bias that changes choices (the init's is zero)
    g = torch.Generator().manual_seed(seed + 1)
    params["moe"]["bias"] = torch.randn(params["moe"]["bias"].shape,
                                        generator=g) * 0.1
    return params


def test_reduced_config_holds_every_kind():
    cfg = C.get_reduced("nemotron3_nano_30b_a3b")
    assert cfg.family == "mixed" and cfg.kind_counts() == \
        {"M": 2, "E": 2, "*": 1}
    assert cfg.ssm_groups == 2 and cfg.d_inner == 64 and cfg.ssm_heads == 4
    assert "nemotron3_nano_30b_a3b" not in C.ARCH_IDS


def test_full_config_parameter_counts():
    cfg = C.get_config("nemotron3_nano_30b_a3b")
    assert cfg.kind_counts() == {"M": 23, "E": 23, "*": 6}
    assert (cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups) == (4096, 64, 8)
    assert abs(cfg.param_count() - 31_577_000_000) <= 10_000_000
    # 6 of 128 routed experts a token
    assert abs(cfg.active_param_count() - 3_580_000_000) <= 10_000_000
    stage = dataclasses.replace(cfg, n_layers=13,
                                layer_pattern=cfg.layer_pattern[:13])
    assert stage.kind_counts() == {"M": 6, "E": 5, "*": 2}
    assert abs(stage.param_count() - 7_471_000_000) <= 1_000_000


def test_tree_is_stacked_per_kind():
    cfg = _cfg()
    p = T.init_params_shaped(cfg)
    n, h = cfg.n_layers, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    assert p["layers"]["norm"].shape == (n, cfg.d_model)
    assert p["layers"]["a_log"].shape == p["layers"]["dt_bias"].shape == (n, h)
    assert p["mamba"]["in_proj"]["w"].shape == \
        (2, cfg.d_model, 2 * cfg.d_inner + 2 * gn + h)
    assert p["mamba"]["conv_w"].shape == (2, cfg.ssm_conv, cfg.d_inner + 2 * gn)
    assert p["moe"]["w1"]["w"].shape == (2, 4, cfg.d_model, cfg.d_ff)
    assert p["moe"]["bias"].shape == (2, 4)
    assert p["moe"]["shared"]["w1"]["w"].shape == (2, cfg.d_model, 64)
    assert "w3" not in p["moe"] and p["attn"]["wq"]["w"].shape[0] == 1
    cache = T.init_cache(cfg, 3, 20, "cpu")
    assert set(cache) == {"pos", "conv", "ssm", "k", "v"}
    assert cache["ssm"].shape == (2, 3, h, cfg.ssm_head_dim, cfg.ssm_state)
    assert cache["conv"].shape[-1] == cfg.d_inner + 2 * gn
    assert cache["k"].shape == (1, 3, 20, cfg.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("prompt", [5, 11])
def test_prefill_then_decode_match_the_full_forward(prompt):
    cfg = _cfg()
    params = _params(cfg)
    s = 16
    toks = torch.randint(0, cfg.vocab, (2, s),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        full, _ = T.forward(params, cfg, toks)
        last, cache = T.prefill(params, cfg, toks[:, :prompt], max_seq=s)
        torch.testing.assert_close(last, full[:, prompt - 1], atol=1e-5,
                                   rtol=1e-5)
        for t in range(prompt, s):
            logits, cache = T.decode_step(params, cache, toks[:, t], cfg)
            torch.testing.assert_close(logits, full[:, t], atol=1e-5,
                                       rtol=1e-5)
    assert cache["pos"] == s


def test_generate_serves_the_forwards_greedy_tokens():
    cfg = _cfg()
    params = _params(cfg)
    prompt = torch.randint(0, cfg.vocab, (2, 13),
                           generator=torch.Generator().manual_seed(4))
    out = serve.generate(params, cfg, prompt, 4)
    with torch.no_grad():
        full, _ = T.forward(params, cfg, out[:, :-1])      # 16: whole chunks
    assert torch.equal(out[:, 13:], full[:, 12:].argmax(-1))


def _repeat_groups(t, x_end, n, g):
    """``.. x | B | C | ..`` (x ending at column ``x_end`` of the last
    dim) with one group's B and C repeated ``g`` times."""
    head, bm, cm, rest = t.split([x_end, n, n, t.shape[-1] - x_end - 2 * n],
                                 -1)
    return torch.cat([head, *[bm] * g, *[cm] * g, rest], -1)


def test_groups_repeating_one_group_give_its_ssd_exactly():
    """B and C repeated across G groups: the SSD, its final state and the
    decode recurrence are the one group's, bit for bit (the gated norm,
    per group, is another function and is left out)."""
    one = _cfg(ssm_groups=1)
    two = dataclasses.replace(one, ssm_groups=2)
    rng = torch.Generator().manual_seed(5)
    b, s, h, p, n, q = 2, 24, one.ssm_heads, one.ssm_head_dim, one.ssm_state, 8
    xdt = torch.randn(b, s, h, p, generator=rng)
    da = -torch.rand(b, s, h, generator=rng) * 3
    bm, cm = (torch.randn(b, s, n, generator=rng) for _ in range(2))
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            y1, st1 = M._ssd(xdt, da, bm, cm, q)
            y2, st2 = M._ssd(xdt, da, *(t[:, :, None].expand(b, s, 2, n)
                                        for t in (bm, cm)), q)
        assert torch.equal(y1, y2) and torch.equal(st1, st2)

    p1 = M.mamba2_init(torch.Generator().manual_seed(6), one, torch.float32)
    di = one.d_inner
    p2 = dict(p1, in_proj={"w": _repeat_groups(p1["in_proj"]["w"], 2 * di,
                                               n, 2)},            # z | x | ..
              conv_w=_repeat_groups(p1["conv_w"], di, n, 2),
              conv_b=_repeat_groups(p1["conv_b"], di, n, 2))
    x = torch.randn(b, 11, one.d_model, generator=rng)
    with torch.no_grad():
        _, st1, tail1 = M.mamba2_prefill(p1, x, one)
        _, st2, tail2 = M.mamba2_prefill(p2, x, two)
        assert torch.equal(st1, st2)
        c1 = {"conv": tail1, "ssm": st1.clone()}
        c2 = {"conv": tail2, "ssm": st2.clone()}
        for _ in range(3):
            xt = torch.randn(b, 1, one.d_model, generator=rng)
            M.mamba2_decode(p1, xt, c1, one)
            M.mamba2_decode(p2, xt, c2, two)
            assert torch.equal(c1["ssm"], c2["ssm"])


def test_gated_norm_runs_per_group():
    g = torch.rand(8) + 0.5
    y, z = torch.randn(3, 8), torch.randn(3, 8)
    got = M._gated_norm(g, y, z, 1e-5, None, groups=2)
    x = y * torch.nn.functional.silu(z)
    for k in range(2):
        part = x[:, 4 * k:4 * k + 4]
        want = part * torch.rsqrt(part.square().mean(-1, keepdim=True)
                                  + 1e-5) * g[4 * k:4 * k + 4]
        torch.testing.assert_close(got[:, 4 * k:4 * k + 4], want)


def test_sigmoid_bias_chooses_and_does_not_weigh():
    cfg = _cfg()
    rng = torch.Generator().manual_seed(7)
    flat = torch.randn(6, cfg.d_model, generator=rng)
    router = torch.randn(cfg.d_model, cfg.moe_experts, generator=rng) * 0.2
    c = MOE.capacity(6, cfg)
    scores = torch.sigmoid(flat @ router)
    slot0, gate0, _ = MOE._dispatch(flat, router, cfg, c,
                                    bias=torch.zeros(cfg.moe_experts))
    e0 = slot0.view(6, -1) // c
    # push token 0's least-scored expert past the others
    least = int(scores[0].argmin())
    bias = torch.zeros(cfg.moe_experts)
    bias[least] = 10.0
    slot1, gate1, aux = MOE._dispatch(flat, router, cfg, c, bias=bias)
    e1 = slot1.view(6, -1) // c
    assert least not in e0[0].tolist() and least in e1[0].tolist()
    for eids, gate in ((e0, gate0), (e1, gate1)):
        chosen = scores.gather(-1, eids)
        torch.testing.assert_close(
            gate, chosen / chosen.sum(-1, keepdim=True) * cfg.moe_route_scale)
    assert float(aux["moe_dropped"]) == 0.0


def test_softmax_routing_is_untouched_by_the_new_fields():
    cfg = C.get_reduced("moonshot_v1_16b_a3b")
    assert (cfg.moe_scoring, cfg.moe_route_scale, cfg.moe_shared_ff) == \
        ("softmax", 1.0, 0)
    p = MOE.moe_init(torch.Generator().manual_seed(8), cfg, torch.float32)
    assert set(p) == {"router", "w1", "w2", "w3"}


def test_shared_expert_is_added_to_the_routed_output():
    cfg = _cfg()
    p = T.layer_view(_params(cfg)["moe"], 0)
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        out, _ = MOE.moe_apply(p, x, cfg)
        routed, _ = MOE.moe_apply({k: v for k, v in p.items() if k != "shared"},
                                  x, cfg)
        torch.testing.assert_close(
            out, routed + T.L.mlp_apply(p["shared"], x, cfg))


def test_training_and_sharding_refuse_the_family():
    cfg = _cfg()
    with pytest.raises(NotImplementedError):
        train.make_train_step(cfg, train.TrainHParams())
    with pytest.raises(NotImplementedError):
        sharding.tree_shardings(T.init_params_shaped(cfg), cfg,
                                AbstractMesh((1, 1), ("data", "model")))
    with pytest.raises(ValueError):
        T.init_cache(dataclasses.replace(cfg, layer_pattern="ME"), 1, 4, "cpu")
    # tensor parallelism splits one group of B and C only
    with pytest.raises(NotImplementedError):
        M._one_group(cfg)
