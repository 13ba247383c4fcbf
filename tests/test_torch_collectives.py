"""The dry run's collectives and per-device peak on fake process groups
(``launch/spmd.count_collectives``, ``launch/dryrun.tensor_parallel_cell``
and the CLI), and the MoE dispatch over the global batch on ``meta``
(``models/moe._own_runs``).

* The count against a hand count: a reduced dense cell (train on
  ``(data 2, model 2)`` with ZeRO-1, prefill, decode), the MoE (EP and TP
  inside the experts), Mamba2 and Zamba2 training on ``(data 1, model 2)``,
  each step run on ``meta`` as rank 0 of a fake group: the calls and
  payload bytes by op equal a count written here from the config's
  shapes, exactly. The count, per layer: the Megatron enter / leave pair
  and its backward (the K/V projection's column blocks gathered where the
  axis cuts inside a KV head, summed in the backward); the vocab-parallel
  loss's three sums; the head's and the embedding's collectives; the DP
  gradient bucket and statistics; ZeRO-1's gather of every leaf; the
  clip's sum of squares; the mixer's gather of ``in_proj``'s, ``conv_w``'s
  and ``conv_b``'s columns, its ``all_to_all`` and the gated norm's sum,
  each with its backward; the MoE's gate and token cotangents summed.
* The counter refuses a collective that it does not count.
* The ring model: wire bytes by op from payload and group size.
* ``_own_runs`` on real tensors bit for bit the formula it had; on
  ``meta`` its static bound, and a reduced MoE cell dispatching over the
  global batch runs on ``meta`` over a fake ``(data 2, model 2)`` group.
* The CLI at full size for one arch on both production meshes: every
  record holds ``collectives_by_mesh`` and the per-device peak. Its cells
  shared among worker processes: the tallies summed, and a worker that
  crashes without its tally counted as a failed cell.
"""
import json
import os

import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import spmd
from repro_torch.launch.mesh import init_fake_group, make_host_mesh
from repro_torch.launch.train import TrainHParams
from repro_torch.models import moe as MOE

F32 = 4
B, S = 4, 16


@pytest.fixture
def fake_group():
    """A fake process group of ``n`` ranks (destroyed after the test)."""
    made = []

    def make(n):
        init_fake_group(n)
        made.append(n)
    yield make
    if made and dist.is_initialized():
        dist.destroy_process_group()


def _meta_record(cfg, kind, world, hp=None):
    mesh = make_host_mesh(model=2, device="cpu")
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
        {"data": world // 2, "model": 2}
    return D.tensor_parallel_cell(cfg, ShapeConfig("h", S, B, kind),
                                  hp or TrainHParams(), "flash", None, mesh,
                                  {"seq_shard": False})["collectives"]


def _by_op(calls):
    """[(op, payload bytes)] -> {op: (count, payload bytes)}."""
    out = {}
    for op, n in calls:
        c, p = out.get(op, (0, 0))
        out[op] = (c + 1, p + n)
    return out


def _check(rec, calls, g=2):
    want = _by_op(calls)
    got = {op: (d["count"], d["payload_bytes"])
           for op, d in rec["per_op"].items()}
    assert got == want
    ring = {"all_reduce": 2 * (g - 1) / g, "all_gather": (g - 1) / g,
            "all_to_all_single": (g - 1) / g}
    for op, d in rec["per_op"].items():
        assert d["wire_bytes"] == pytest.approx(ring[op] * d["payload_bytes"],
                                                rel=1e-12)


def ag(n):
    return ("all_gather", n * F32)


def ar(n):
    return ("all_reduce", n * F32)


def a2a(n):
    return ("all_to_all_single", n * F32)


def _attn_fwd(cfg, b, s, t):
    """A block's attention half in the forward: the K and V projections'
    column blocks gathered where the axis cuts inside a KV head, then the
    row-parallel output summed."""
    kvw = cfg.n_kv_heads * cfg.head_dim
    cut = [ag(b * s * kvw)] * 2 if cfg.n_kv_heads % t else []
    return cut + [ar(b * s * cfg.d_model)]


def _attn_bwd(cfg, b, s, t):
    """Its backward: the K/V gathers' partial cotangents summed, then the
    stream's (Megatron's enter)."""
    kvw = cfg.n_kv_heads * cfg.head_dim
    cut = [ar(b * s * kvw)] * 2 if cfg.n_kv_heads % t else []
    return cut + [ar(b * s * cfg.d_model)]


def _mixer_fwd(cfg, b, s, t):
    di, ns, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj, conv = 2 * di + 2 * ns + h, di + 2 * ns
    return [ag(b * s * proj), ag(cfg.ssm_conv * conv), ag(conv),
            a2a(b * s * di // t), ar(b * s), ar(b * s * cfg.d_model)]


def _mixer_bwd(cfg, b, s, t):
    di, ns, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj, conv = 2 * di + 2 * ns + h, di + 2 * ns
    return [ar(b * s), a2a(b * s * di // t), ar(h), ar(h), ar(h), ar(conv),
            ar(cfg.ssm_conv * conv), ar(b * s * proj),
            ar(b * s * cfg.d_model)]


def _loss(b, s):
    return [ar(b * s)] * 3          # the row max, the sum of exp, the gold


def _dense_leaves(cfg, t):
    """Each float parameter's elements on one rank (the rules' blocks)."""
    d, l, v, f = cfg.d_model, cfg.n_layers, cfg.vocab, cfg.d_ff
    hw, kvw = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return [v * d // t, d * v // t, l * d, l * d, d,
            l * d * hw // t, l * d * kvw // t, l * d * kvw // t,
            l * hw * d // t, l * d * f // t, l * f * d // t, l * d * f // t]


def test_dense_train_count_equals_the_hand_count(fake_group):
    cfg = C.get_reduced("stablelm_12b")
    assert cfg.n_kv_heads % 2 and not cfg.n_heads % 2
    fake_group(4)
    rec = _meta_record(cfg, "train", 4, TrainHParams(zero1=True))
    t, dp = 2, 2
    b, d, l = B // dp, cfg.d_model, cfg.n_layers
    calls = [ag(b * S * d)]                                  # the embedding
    for _ in range(l):
        calls += _attn_fwd(cfg, b, S, t) + [ar(b * S * d)]   # + the MLP's
    calls += _loss(b, S) + [ar(b * S * d)]                   # the head's enter
    for _ in range(l):
        calls += [ar(b * S * d)] + _attn_bwd(cfg, b, S, t)
    leaves = _dense_leaves(cfg, t)
    calls += [ar(sum(leaves)),                               # the DP bucket
              ar(3 + l + l * d),                             # loss, ce, ia, ..
              ar(1)]                                         # the clip
    calls += [ag(n) for n in leaves]                         # ZeRO-1
    _check(rec, calls)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dense_serving_count_equals_the_hand_count(fake_group, kind):
    cfg = C.get_reduced("stablelm_12b")
    fake_group(4)
    rec = _meta_record(cfg, kind, 4)
    t, b, d = 2, B // 2, cfg.d_model
    h, dh, kvw = cfg.n_heads, cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    if kind == "prefill":
        calls = [ag(b * S * d)]
        for _ in range(cfg.n_layers):
            calls += _attn_fwd(cfg, b, S, t) + [ar(b * S * d)]
    else:
        # one token: the query heads and K/V gathered, the slot-split
        # cache's max and its merged sums and outputs, the two sums
        calls = [ag(b * d)]
        for _ in range(cfg.n_layers):
            calls += [ag(b * h * dh), ag(b * kvw), ag(b * kvw), ar(b * h),
                      ar(b * h * (dh + 1)), ar(b * d), ar(b * d)]
    _check(rec, calls)


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "mixtral_8x7b"])
def test_moe_train_count_equals_the_hand_count(fake_group, arch):
    cfg = C.get_reduced(arch)
    fake_group(2)
    rec = _meta_record(cfg, "train", 2)
    t, d, n = 2, cfg.d_model, B * S
    calls = [ag(B * S * d)]
    for _ in range(cfg.n_layers):
        calls += _attn_fwd(cfg, B, S, t) + [ar(B * S * d)]   # + the experts'
    calls += _loss(B, S) + [ar(B * S * d)]
    for _ in range(cfg.n_layers):
        # the gates' and the tokens' partial cotangents summed
        calls += [ar(n * cfg.moe_top_k), ar(n * d)] + _attn_bwd(cfg, B, S, t)
    calls += [ar(1)]
    _check(rec, calls)


def test_mamba2_train_count_equals_the_hand_count(fake_group):
    cfg = C.get_reduced("mamba2_2p7b")
    fake_group(2)
    rec = _meta_record(cfg, "train", 2)
    t, d = 2, cfg.d_model
    calls = [ag(B * S * d)]
    for _ in range(cfg.n_layers):
        calls += _mixer_fwd(cfg, B, S, t)
    calls += _loss(B, S) + [ar(B * S * d)]
    for _ in range(cfg.n_layers):
        calls += _mixer_bwd(cfg, B, S, t)
    calls += [ar(1)]
    _check(rec, calls)


def test_zamba2_train_count_equals_the_hand_count(fake_group):
    cfg = C.get_reduced("zamba2_1p2b")
    fake_group(2)
    rec = _meta_record(cfg, "train", 2)
    t, d, every = 2, cfg.d_model, cfg.hybrid_attn_every
    shared = [i for i in range(cfg.n_layers) if (i + 1) % every == 0]
    assert shared
    calls = [ag(B * S * d)]
    for i in range(cfg.n_layers):
        calls += _mixer_fwd(cfg, B, S, t)
        if i in shared:                  # the shared attention and MLP
            calls += _attn_fwd(cfg, B, S, t) + [ar(B * S * d)]
    calls += _loss(B, S) + [ar(B * S * d)]
    for i in reversed(range(cfg.n_layers)):
        if i in shared:
            calls += [ar(B * S * d)] + _attn_bwd(cfg, B, S, t)
        calls += _mixer_bwd(cfg, B, S, t)
    calls += [ar(1)]
    _check(rec, calls)


def test_a_collective_it_does_not_count_raises(fake_group):
    """Inside the counter every collective but the three the port issues
    raises (eager and functional); outside it they are torch's own."""
    import torch.distributed._functional_collectives as funcol
    fake_group(2)
    x = torch.ones(4)
    before = (dist.broadcast, funcol.all_gather_tensor, dist.all_reduce)
    with spmd.count_collectives() as c:
        with pytest.raises(RuntimeError, match="reduce_scatter_tensor"):
            dist.reduce_scatter_tensor(torch.empty(2), x)
        with pytest.raises(RuntimeError, match="broadcast"):
            dist.broadcast(x, 0)
        with pytest.raises(RuntimeError, match="functional all_gather_tensor"):
            funcol.all_gather_tensor(x, 0, dist.group.WORLD)
        dist.all_reduce(x)
        with spmd.count_collectives() as inner:      # counters nest
            out = [torch.empty(4) for _ in range(2)]
            dist.all_gather(out, x)
    assert (dist.broadcast, funcol.all_gather_tensor, dist.all_reduce) == \
        before
    assert c.record() == {
        "per_op": {"all_reduce": {"count": 1, "payload_bytes": 16,
                                  "wire_bytes": 16.0},
                   "all_gather": {"count": 1, "payload_bytes": 32,
                                  "wire_bytes": 16.0}},
        "payload_bytes": 48, "wire_bytes_per_device": 32.0}
    assert inner.record()["per_op"].keys() == {"all_gather"}
    assert c.inputs["all_gather"] == {"elems": 4, "bytes": 16}


def _old_own_runs(slot, e, c):
    """``_own_runs`` as it was before its ``meta`` branch."""
    nk = slot.shape[0]
    kept = slot < e * c
    ex = torch.where(kept, slot // c, e)
    run = torch.zeros(e + 1, dtype=torch.int64, device=slot.device
                      ).scatter_add_(0, ex, kept.long())
    c_buf = max(8, -(-int(run[:e].max()) // 8) * 8)
    srt = torch.sort(slot).values
    head = srt[(torch.cumsum(run, 0) - run).clamp(max=nk - 1)]
    return torch.where(kept, ex * c_buf + slot - head[ex], e * c_buf), c_buf


def test_own_runs_on_real_tensors_unchanged_and_bounded_on_meta():
    gen = torch.Generator().manual_seed(3)
    for e, c, nk in ((4, 10, 24), (8, 32, 96), (3, 5, 30)):
        for _ in range(5):
            # a run of kept slots an expert from a random start, the rest
            # dropped (e * c)
            starts = torch.randint(0, c, (e,), generator=gen)
            lens = torch.randint(0, c + 1, (e,), generator=gen)
            slots = [x * c + s + i for x in range(e)
                     for i in range(int(min(lens[x], c - starts[x])))
                     for s in [int(starts[x])]][:nk]
            slot = torch.tensor(slots + [e * c] * (nk - len(slots)))
            slot = slot[torch.randperm(nk, generator=gen)]
            got, cb = MOE._own_runs(slot, e, c)
            want, wb = _old_own_runs(slot, e, c)
            assert cb == wb and torch.equal(got, want)
    meta = torch.empty(40, dtype=torch.int64, device="meta")
    got, cb = MOE._own_runs(meta, 4, 13)
    assert cb == 16 and got.device.type == "meta" and got.shape == (40,)


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "mixtral_8x7b"])
def test_moe_global_dispatch_cell_runs_on_meta(fake_group, arch):
    """The MoE over the global batch (DP 2, no ``shardmap_moe``) on
    ``meta``: its expert ids gathered over the DP axis once a layer (the
    forward) and its peak counted."""
    cfg = C.get_reduced(arch)
    fake_group(4)
    mesh = make_host_mesh(model=2, device="cpu")
    rec = D.lower_cell(cfg, ShapeConfig("g", S, B, "train"),
                       hp=TrainHParams(), mesh=mesh)
    ids = [n for op, n, g in _calls(cfg, mesh) if op == "all_gather"
           and n == B * S * cfg.moe_top_k * 8]
    assert len(ids) == cfg.n_layers
    mem = rec["memory"]
    assert mem["peak_estimate_bytes_per_device"] == \
        mem["argument_bytes_per_device"] + mem["temp_bytes_per_device"]
    assert 0 < mem["temp_bytes_per_device"]
    assert rec["collective_payload_bytes"] == rec["collectives"][
        "payload_bytes"] > 0


def _calls(cfg, mesh):
    parts = D.placed_arguments(cfg, ShapeConfig("g", S, B, "train"),
                               TrainHParams(), mesh)
    run = D.cell_step(cfg, ShapeConfig("g", S, B, "train"), TrainHParams(),
                      "flash", None, parts, mesh=mesh)
    with spmd.activate(mesh), spmd.count_collectives() as c:
        run()
    return c.calls


def test_cli_on_both_fake_production_meshes(tmp_path, capsys):
    """The CLI at full size for one arch and shape on 16 x 16 and 2 x 16 x
    16 (one cell: one worker, this process): each mesh's collectives
    (nonzero, wire bytes by the ring model) and peak a device, the
    argument bytes a device beside them; no group left in this process."""
    out = str(tmp_path)
    assert D.main(["--arch", "stablelm_12b", "--shape", "train_4k",
                   "--mesh", "both", "--out", out]) == 0
    assert "done: ok=1 skip=0 fail=0" in capsys.readouterr().out
    assert not dist.is_initialized()
    with open(os.path.join(out, "stablelm_12b__train_4k__1.json")) as f:
        rec = json.load(f)
    mem = rec["memory"]
    assert list(rec["collectives_by_mesh"]) == ["16x16", "2x16x16"]
    for name, coll in rec["collectives_by_mesh"].items():
        assert coll["per_op"]["all_reduce"]["count"] > 0
        assert coll["per_op"]["all_gather"]["count"] > 0
        assert coll["wire_bytes_per_device"] > 0
        peak = mem["peak_estimate_bytes_per_device_by_mesh"][name]
        assert peak == mem["argument_bytes_per_device_by_mesh"][name] + \
            mem["temp_bytes_per_device_by_mesh"][name]
        assert 0 < peak < mem["peak_estimate_bytes"]
    assert rec["collectives"] == rec["collectives_by_mesh"]["16x16"]
    assert rec["collective_wire_bytes_per_device"] == \
        rec["collectives"]["wire_bytes_per_device"]
    # the pod axis adds the gradients' all-reduce over it
    assert rec["collectives_by_mesh"]["2x16x16"]["per_op"]["all_reduce"][
        "count"] > rec["collectives_by_mesh"]["16x16"]["per_op"][
        "all_reduce"]["count"]


@pytest.mark.parametrize("crash", [False, True], ids=["tallies", "crash"])
def test_cli_workers_sum_their_tallies_and_a_crash_fails(tmp_path, capsys,
                                                         crash):
    """The cells of one arch shared among 2 worker processes: their
    tallies summed (every cell cached, so no step runs); and a worker that
    crashes before its tally (``--out`` is a file, so it cannot make the
    directory) counts as a failed cell, and the CLI fails."""
    out = tmp_path / "out"
    if crash:
        out.write_text("")
    else:
        out.mkdir()
        for shape in C.SHAPES:
            cid = D.cell_id("stablelm_12b", shape, D.MESH_NAME, "")
            (out / (cid + ".json")).write_text("{}")
    rc = D._run_jobs(["--arch", "stablelm_12b", "--shape", "all",
                      "--mesh", "both", "--out", str(out)], 2)
    text = capsys.readouterr().out
    if crash:
        assert rc == 1
        assert "done: ok=0 skip=0 fail=2" in text
        assert text.count("without its tally") == 2
    else:
        assert rc == 0
        assert f"done: ok={len(C.SHAPES)} skip=0 fail=0" in text
        assert text.count("[cached]") == len(C.SHAPES)


# the reference's lower_cell (XLA's HLO collectives, probe-corrected over
# the layers) in a process of its own: repro.launch.dryrun forces 512 host
# devices on import; one reduced train cell a family on (data 2, model 4)
REFERENCE = r"""
import json, os, sys
os.environ.pop("JAX_PLATFORMS", None)
sys.path.insert(0, {src!r})
from repro.launch import dryrun as RD
import jax, numpy as np
from jax.sharding import Mesh
import repro.configs as JC
from repro.configs.base import ShapeConfig
from repro.launch import spmd
from repro.launch.train import TrainHParams
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = {{}}
for arch in sys.argv[1].split(","):
    with spmd.activate(mesh):
        rec = RD.lower_cell(JC.get_reduced(arch),
                            ShapeConfig("c", {s}, {b}, "train"), mesh,
                            hp=TrainHParams())
    out[arch] = {{"payload_bytes": rec["collective_payload_bytes"],
                 "wire_bytes_per_device":
                     rec["collective_wire_bytes_per_device"],
                 "per_op_2g": rec["collectives_probe_2g"]}}
print(json.dumps(out))
"""
FAMILY_ARCHS = ("stablelm_12b", "qwen2_vl_2b", "musicgen_large",
                "moonshot_v1_16b_a3b", "mamba2_2p7b", "zamba2_1p2b")


def test_reference_hlo_collectives_beside_the_count(fake_group):
    """The port's count beside the reference's HLO-parsed figures, one
    reduced train cell a family on (data 2, model 4), printed (``-s``),
    not gated on: XLA's partitioner picks its own collectives (a
    reduce-scatter where the port all-reduces and slices, permutes and
    all-to-alls of its own resharding), and the step's numbers are held
    against the reference elsewhere. Both sides move bytes in every
    cell."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    code = REFERENCE.format(src=os.path.join(root, "src"), s=S, b=2 * B)
    ref = subprocess.run([sys.executable, "-c", code, ",".join(FAMILY_ARCHS)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert ref.returncode == 0, ref.stderr[-4000:]
    ref = json.loads(ref.stdout.strip().splitlines()[-1])
    fake_group(8)
    mesh = make_host_mesh(model=4, device="cpu")
    for arch in FAMILY_ARCHS:
        port = D.tensor_parallel_cell(
            C.get_reduced(arch), ShapeConfig("c", S, 2 * B, "train"),
            TrainHParams(), "flash", None, mesh, {})["collectives"]
        r = ref[arch]
        print(f"{arch}: port payload {port['payload_bytes']:.0f} wire/dev "
              f"{port['wire_bytes_per_device']:.0f} "
              + json.dumps({op: [d["count"], d["payload_bytes"]]
                            for op, d in port["per_op"].items()})
              + f" | reference payload {r['payload_bytes']:.0f} wire/dev "
              f"{r['wire_bytes_per_device']:.0f} (2g probe: "
              + json.dumps({op: [d["count"], d["payload_bytes"]]
                            for op, d in r["per_op_2g"].items()}) + ")")
        assert port["payload_bytes"] > 0 and r["payload_bytes"] > 0
