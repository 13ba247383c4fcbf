"""The port's dry run on ``meta`` tensors (``repro_torch.launch.dryrun``)
and ``transformer.init_params_shaped`` against the JAX reference's shapes.

Shapes, dtypes and byte counts are compared exactly. Where the packages
differ by design, the test says so and counts it: the port's token and
label ids are int64 (the width its steps index with; the reference's are
int32), and its AdamW step and cache position are host ints (no device
bytes; the reference's are int32 scalars).

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices in its first
lines, which would leak into this worker's later tests; the reference's
``input_specs`` and state trees come from a subprocess, and this process
calls only ``repro.models.transformer.init_params_shaped``.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

import repro.configs as JC
from repro.models import transformer as JT
import repro_torch.configs as C
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.train import TrainHParams
from repro_torch.models import transformer as T

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jkey(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _jleaves(tree):
    return {_jkey(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tleaves(tree):
    return {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for k, x in _flatten(tree) if isinstance(x, torch.Tensor)}


# ---------------------------------------------------------------------------
# init_params_shaped
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("local_heads", [False, True])
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_init_params_shaped_matches_reference(arch, local_heads):
    """Every leaf path, shape and dtype at full size; every leaf on meta."""
    got = T.init_params_shaped(C.get_config(arch), local_heads=local_heads)
    want = JT.init_params_shaped(jax.random.PRNGKey(0), JC.get_config(arch),
                                 local_heads=local_heads)
    assert _tleaves(got) == _jleaves(want)
    assert all(x.device.type == "meta" for _, x in _flatten(got))


def test_init_params_shaped_equals_init_params_tree():
    """The meta tree is init_params's (a reduced config with every sparse
    form: masked and compact N:M, dense where the fan-in does not tile), and
    init_params at a real device is unchanged by the meta route."""
    for mode in ("masked", "compact"):
        for arch in ("phi3_medium_14b", "mixtral_8x7b", "mamba2_2p7b"):
            cfg = C.get_reduced(arch)
            cfg = dataclasses.replace(cfg, sparsity=C.SparsityConfig(
                n=1, m=2, block=8, targets=("mlp", "attn", "expert"),
                mode=mode))
            real = T.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu", local_heads=True)
            meta = T.init_params_shaped(cfg, local_heads=True)
            assert _tleaves(meta) == _tleaves(real), (mode, arch)
            again = T.init_params(torch.Generator().manual_seed(0), cfg,
                                  device="cpu", local_heads=True)
            assert all(torch.equal(a, b) for (_, a), (_, b) in
                       zip(_flatten(real), _flatten(again)))


# ---------------------------------------------------------------------------
# input specs and argument bytes, against the reference's in a subprocess
# ---------------------------------------------------------------------------

_REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax
    from repro.launch.dryrun import input_specs
    import repro.configs as C
    from repro.models import transformer as T
    from repro.optim import adamw_init
    from repro.optim.sparse import SparseTrainState

    def key(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)

    def leaves(tree):
        return {key(p): [list(x.shape), str(x.dtype)]
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def nbytes(tree):
        return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))

    out = {}
    for arch in C.ARCH_IDS:
        cfg = C.get_config(arch)
        params = T.init_params_shaped(jax.random.PRNGKey(0), cfg)
        for name, shape in C.SHAPES.items():
            ok, why = C.shape_applicable(cfg, shape)
            rec = {"ok": ok, "why": why}
            if ok:
                spec = input_specs(cfg, shape)
                rec["specs"] = leaves(spec)
                rec["bytes"] = {"params": nbytes(params)}
                if shape.kind == "train":
                    opt = jax.eval_shape(adamw_init, params)
                    rec["bytes"]["opt_step"] = nbytes(opt.step)
                    rec["bytes"]["opt_state"] = nbytes(opt)
                    rec["bytes"]["sparse_state"] = nbytes(jax.eval_shape(
                        lambda: SparseTrainState.init(cfg.n_layers,
                                                      cfg.d_model)))
                    rec["bytes"]["batch"] = nbytes(spec)
                elif shape.kind == "prefill":
                    rec["bytes"]["batch"] = nbytes(
                        {k: v for k, v in spec.items() if k != "labels"})
                else:
                    rec["bytes"]["cache"] = nbytes(spec["cache"])
                    rec["bytes"]["tokens"] = nbytes(spec["tokens"])
            out[arch + "__" + name] = rec
    json.dump(out, sys.stdout)
""")


@functools.lru_cache(maxsize=None)
def _reference_cells():
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def _ids_as_reference(leaves):
    """The port's leaves with its int64 ids at the reference's int32."""
    return {k: (s, "int32" if d == "int64" else d) for k, (s, d) in leaves.items()}


@pytest.mark.parametrize("shape_name", list(C.SHAPES))
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_input_specs_match_reference(arch, shape_name):
    ref = _reference_cells()[f"{arch}__{shape_name}"]
    cfg, shape = C.get_config(arch), C.SHAPES[shape_name]
    ok, why = C.shape_applicable(cfg, shape)
    assert ok == ref["ok"] and why.startswith(ref["why"][:60])
    if not ok:
        return
    spec = D.input_specs(cfg, shape)
    got = _tleaves(spec)
    want = {k: (tuple(s), d) for k, (s, d) in ref["specs"].items()}
    # the cache position: a host int here, an int32 scalar there
    if shape.kind == "decode":
        assert spec["cache"]["pos"] == 0
        assert want.pop("cache/pos") == ((), "int32")
    assert _ids_as_reference(got) == want
    assert all(d in ("int64", cfg.dtype, "float32") for _, d in got.values())


@pytest.mark.parametrize("shape_name", list(C.SHAPES))
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_argument_bytes_match_reference(arch, shape_name):
    """Params, moments and gating state bytes equal the reference's trees
    (less AdamW's int32 step, a host int here); the batch's ids take twice
    the bytes (int64), its embeddings the same."""
    ref = _reference_cells()[f"{arch}__{shape_name}"]
    if not ref["ok"]:
        return
    cfg, shape = C.get_config(arch), C.SHAPES[shape_name]
    parts = D.cell_arguments(cfg, shape, TrainHParams())
    got = {k: D.tree_bytes(v) for k, v in parts.items()}
    want = dict(ref["bytes"])
    assert got["params"] == want["params"]
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        assert parts["opt_state"].step == 0 and want["opt_step"] == 4
        assert got["opt_state"] == want["opt_state"] - want["opt_step"]
        assert got["sparse_state"] == want["sparse_state"]
        ids = b * s * (1 if cfg.frontend else 2)        # labels (+ tokens)
        assert got["batch"] == want["batch"] + 4 * ids
    elif shape.kind == "prefill":
        assert got["batch"] == want["batch"] + (0 if cfg.frontend else 4 * b * s)
    else:
        assert got["cache"] == want["cache"] - 4          # the int32 pos
        assert got["tokens"] == 2 * want["tokens"]
    assert all(x.device.type == "meta"
               for p in parts.values() for x in D.tensors(p))


# ---------------------------------------------------------------------------
# flops and live bytes on meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi3_medium_14b", "nemotron_4_15b",
                                  "qwen2_vl_2b"])
@pytest.mark.parametrize("remat", [False, True])
def test_flops_equal_the_hand_count(arch, remat):
    """A reduced dense train cell: forward, backward (two products a
    product) and, under remat, the recomputed forward. Non-reentrant
    checkpointing stops recomputing once every tensor the backward saved is
    back, so the block's last product (``w2``, whose output nothing saves)
    is not recomputed. The flash op's plain route counts its full ``S×S``
    products in the forward and again in its backward's recompute."""
    cfg = dataclasses.replace(C.get_reduced(arch), remat=remat)
    b, s = 2, 16
    rec = D.lower_cell(cfg, ShapeConfig("t", s, b, "train"), hp=TrainHParams())
    tok, d, f, v = b * s, cfg.d_model, cfg.d_ff, cfg.vocab
    h, kv, dh, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    n_in = 2 if cfg.act == "swiglu" else 1              # w1 (and w3)
    qkvo = 2 * tok * (2 * d * h * dh + 2 * d * kv * dh)
    mlp_in, w2 = 2 * tok * n_in * d * f, 2 * tok * f * d
    attn = 2 * 2 * b * h * s * s * dh                   # QKᵀ and PV, full S×S
    head = 2 * tok * d * v
    front = 2 * tok * cfg.frontend_dim * d if cfg.frontend else 0
    fwd = L * (qkvo + mlp_in + w2 + attn) + head
    want = 3 * fwd + L * attn + 2 * front               # + the flash recompute
    flash = L * 4 * attn
    if remat:
        want += L * (qkvo + mlp_in + attn)
        flash += L * attn
    assert rec["flops_per_device"] == want
    assert rec["flash_flops"] == flash


def test_flops_of_prefill_and_decode():
    cfg = C.get_reduced("phi3_medium_14b")
    b, s = 3, 8
    tok, d, f, v = b * s, cfg.d_model, cfg.d_ff, cfg.vocab
    h, kv, dh, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    proj = 2 * (2 * d * h * dh + 2 * d * kv * dh + 3 * d * f)
    pre = D.lower_cell(cfg, ShapeConfig("p", s, b, "prefill"))
    attn = 2 * 2 * b * h * s * s * dh
    assert pre["flops_per_device"] == tok * (L * proj + 2 * d * v) + L * attn
    assert pre["flash_flops"] == L * attn
    dec = D.lower_cell(cfg, ShapeConfig("d", s, b, "decode"))
    # one token against the whole cache (C = s slots)
    assert dec["flops_per_device"] == b * (L * proj + 2 * d * v) \
        + L * 2 * 2 * b * h * s * dh
    assert dec["flash_flops"] == 0
    assert dec["memory"]["argument_bytes_by_part"]["cache"] == \
        2 * L * b * s * kv * dh * 4


def test_live_bytes_counts_new_storages_until_freed():
    a = torch.empty((100,), device="meta")
    with D.LiveBytes([a]) as live:
        b = a * 2                     # +400
        c = b[:10]                    # a view: nothing new
        a.mul_(3)                     # in place on an argument: nothing
        d = torch.cat([b, b])         # +800 -> 1200 live
        del b, c                      # -400
        # +400 for the empty tensor, +400 for the sum (1600 live), then the
        # empty one is freed
        e = torch.empty((50,), dtype=torch.float64, device="meta") + 1
        assert live.live == 800 + 400
    assert live.peak == 1600
    del d, e
    assert live.live == 0


def test_peak_estimate_holds_arguments_and_the_largest_live_set():
    cfg = C.get_reduced("qwen2_vl_2b")
    rec = D.lower_cell(cfg, ShapeConfig("t", 16, 2, "train"), hp=TrainHParams())
    m = rec["memory"]
    parts = D.cell_arguments(cfg, ShapeConfig("t", 16, 2, "train"),
                             TrainHParams())
    assert m["argument_bytes"] == sum(D.tree_bytes(p) for p in parts.values())
    assert m["argument_bytes_by_part"] == {k: D.tree_bytes(p)
                                           for k, p in parts.items()}
    # the gradients alone are live at once before AdamW
    assert m["temp_bytes"] >= D.tree_bytes(parts["params"])
    assert m["peak_estimate_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert rec["collectives"]["wire_bytes_per_device"] == 0.0
    assert rec["n_devices"] == 1 and rec["mesh"] == "1"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_writes_ok_and_skipped_cells(tmp_path, capsys):
    out = str(tmp_path)
    assert D.main(["--arch", "qwen2_vl_2b", "--shape", "decode_32k",
                   "--out", out, "--mesh", "single", "--tag", "t"]) == 0
    assert D.main(["--arch", "qwen2-vl-2b", "--shape", "long_500k",
                   "--out", out]) == 0
    printed = capsys.readouterr().out
    assert "done: ok=1 skip=0 fail=0" in printed
    assert "done: ok=0 skip=1 fail=0" in printed
    with open(os.path.join(out, "qwen2_vl_2b__decode_32k__1__t.json")) as f:
        rec = json.load(f)
    assert rec["kind"] == "decode" and rec["opts"]["mesh_requested"] == "single"
    assert rec["memory"]["argument_bytes"] > 0 and rec["flops_per_device"] > 0
    # --mesh single: the decode cell's bytes a device on the 16 x 16 mesh
    by_mesh = rec["memory"]["argument_bytes_per_device_by_mesh"]
    assert list(by_mesh) == ["16x16"]
    assert 0 < by_mesh["16x16"] < rec["memory"]["argument_bytes"]
    with open(os.path.join(out, "qwen2_vl_2b__long_500k__1.json")) as f:
        assert "skipped" in json.load(f)
    # a second run reads the cached cell
    assert D.main(["--arch", "qwen2_vl_2b", "--shape", "decode_32k",
                   "--out", out, "--tag", "t"]) == 0
    assert "[cached]" in capsys.readouterr().out


def test_parse_opt_as_the_reference():
    opts, hp = D.parse_opt("seq,moe,losschunk:256,zero1,mb:4")
    assert opts == {"seq_shard": True, "shardmap_moe": True, "loss_chunk": 256}
    assert hp == {"zero1": True, "microbatch": 4}
    assert D.parse_opt("losschunk")[0]["loss_chunk"] == 512
    assert D.parse_opt("") == ({"seq_shard": False, "shardmap_moe": False,
                                "loss_chunk": 0}, {})
