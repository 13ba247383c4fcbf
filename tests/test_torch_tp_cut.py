"""Tensor parallelism on the placements where the rules cut inside a query
head or put the head's rows on the model axis (``layers.head_cut``,
``transformer._logits``), and the collectives that a step issues counted
on real ranks against the dry run's count on ``meta`` (``spmd.
count_collectives``, ``launch/dryrun.tensor_parallel_cell``), on the CPU
over gloo: 2 ranks on ``(data 1, model 2)``, 4 on ``(data 2, model 2)`` and
3 on ``(data 1, model 3)``.

The configs are built the same way on both sides with
``dataclasses.replace``:

* a head cut: 3 query heads and 1 KV head of 16 (Qwen2-VL-2B's and
  Phi-3's case at full size, where 12 and 40 heads meet a model axis of 16):
  each rank of a model axis of 2 holds 1.5 heads of ``wq``'s columns and
  half of the KV head; on ``(data 1, model 3)`` 4 heads of 24 over 2 KV
  heads, where rank 1's span (heads 1 and 2) crosses a GQA group;
* the head on its rows: a vocabulary of 255 (Mamba2-2.7B's case, 50,280 on
  16), so the rules put ``lm_head``'s ``d_model`` rows on the model axis:
  one ssm and one attention family.

Each mesh's ranks are spawned once (a module fixture) and run every case
on parameters the reference drew (``convert.lm_params_from_numpy``, placed
by ``launch/train.place_params``), each DP rank on its rows; held to the
bounds of ``tests/test_torch_tp.py`` and ``tests/test_torch_tp_serve.py``,
unchanged: three train steps' losses within ``1e-3`` of the reference's
and the port's 1-process step's, the step-0 gradients within ``1e-4`` of
each leaf's largest element, the params after the steps within ``1e-4``
relative L2; the prefill's and each decode step's logits within ``1e-5``
of the largest logit, the greedy tokens and ``generate``'s equal to the
reference's, on every rank.

The count: one cell of each family (dense, vlm, audio, moe with EP and with
TP inside the experts, ssm, hybrid) and each kind (train, prefill,
decode), run on the ranks under ``spmd.count_collectives`` and on ``meta``
over a fake process group of the same size: the counts, payload and wire
bytes by op equal, exactly, on every rank.

Each spawned process runs under its own timeout.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import repro.configs as JC  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
import repro_torch.configs as C  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.train import TrainHParams  # noqa: E402
from test_torch_tp import (OPT, _close, _flat, _hps, _jflat,  # noqa: E402
                           _np, _port_train, _reference_train, _rel_l2,
                           _spawn, _whole)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, STEPS, PROMPT, NEW = 16, 4, 3, 16, 6
LOSS_REL, GRAD_RTOL, PARAM_REL_L2, LOGIT_RTOL = 1e-3, 1e-4, 1e-4, 1e-5
MESHES = {"1x2": (2, 2), "2x2": (4, 2), "1x3": (3, 3)}   # id: (world, model)

torch.set_num_threads(1)

H3 = {"n_heads": 3, "n_kv_heads": 1}
# (1, 3): 4 heads of 24 over 2 KV heads; every width divides 3
H4_DH24 = {"n_heads": 4, "n_kv_heads": 2, "d_head": 24, "d_model": 96,
           "d_ff": 192, "vocab": 255}
V255 = {"vocab": 255}
# name: (arch, config changes, hparams, seq_shard, remat, meshes)
CASES = {
    "stablelm_h3_gate_zero1": ("stablelm_12b", H3, {"gating": True,
                                                    "zero1": True},
                               False, False, ("1x2", "2x2")),
    "phi3_h3_seq_remat": ("phi3_medium_14b", H3, {"gating": True}, True,
                          True, ("1x2",)),
    "qwen_h3_mrope": ("qwen2_vl_2b", H3, {}, False, False, ("1x2", "2x2")),
    "stablelm_h4_span_crosses_group": ("stablelm_12b", H4_DH24,
                                       {"gating": True}, False, False,
                                       ("1x3",)),
    "mamba2_v255_rows": ("mamba2_2p7b", V255, {"gating": True}, False,
                         False, ("1x2", "2x2")),
    "stablelm_v255_rows_seq": ("stablelm_12b", V255, {"zero1": True}, True,
                               False, ("1x2",)),
}
# the count against meta: one cell a family, each kind
COUNT_ARCHS = ("stablelm_12b", "qwen2_vl_2b", "musicgen_large",
               "moonshot_v1_16b_a3b", "mixtral_8x7b", "mamba2_2p7b",
               "zamba2_1p2b")
COUNT_KINDS = ("train", "prefill", "decode")
COUNT_HP = {"zero1": True}
COUNT_MESHES = ("1x2", "2x2")

WORKER = r"""
import dataclasses, os, sys, torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch import configs as C, convert
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.gating import GatingConfig
from repro_torch.launch import dryrun as D, spmd
from repro_torch.launch.launcher import fleet_init
from repro_torch.launch.mesh import dp_size, make_host_mesh
from repro_torch.launch.serve import generate
from repro_torch.launch.train import (DataParallel, TrainHParams,
                                      make_train_step, place_params)
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, SparseTrainState, adamw_init
from repro_torch.optim.optimizer import tree_leaves, tree_map
torch.set_num_threads(1)
spec = torch.load(sys.argv[1], weights_only=False)
out_dir, model = sys.argv[2], int(sys.argv[3])
rank, world = fleet_init("cpu")
mesh = make_host_mesh(model=model, device="cpu")
dpr, dp = spmd.dp_rank(mesh), world // model
mr = mesh.get_local_rank("model")
def rows(x):
    w = x.shape[0] // dp
    return torch.as_tensor(x[dpr * w:(dpr + 1) * w])
def local(x):
    return x.to_local().clone() if hasattr(x, "to_local") else x
def locals_(tree):
    return tree_map(lambda x: None if x is None else local(x), tree)
def whole_vocab(logits):
    # (this rank's logits, whether they are its vocab block)
    loc = logits.to_local()
    return loc.detach().clone(), loc.shape[-1] != logits.shape[-1]
def pick(logits):
    loc = logits.to_local()
    if loc.shape[-1] == logits.shape[-1]:
        return loc.argmax(-1)
    return spmd.vocab_argmax(loc, spmd.tensor_parallel(logits))
out = {{"rank": rank, "dp_rank": dpr, "model_rank": mr}}
for c in spec["train"]:
    cfg = dataclasses.replace(C.get_reduced(c["arch"]), remat=c["remat"],
                              **c["changes"])
    p0 = convert.lm_params_from_numpy(c["params"], cfg, "cpu")
    batches = [{{k: rows(v) for k, v in b.items()}} for b in c["batches"]]
    kw = dict(c["hp"])
    gated = kw.pop("gating", False)
    hp = TrainHParams(opt=AdamWConfig(**c["opt"]),
                      gating=GatingConfig() if gated else None, **kw)
    with spmd.activate(mesh, seq_shard=c["seq"], flash_attn=True):
        step = make_train_step(cfg, hp, mesh=mesh)
        params = place_params(p0, cfg, mesh)
        opt = adamw_init(params, step.dp.zero1_layout(params))
        sparse = SparseTrainState.init(cfg.n_layers, cfg.d_model, "cpu")
        loss, _, g = step.loss_and_grads(params, batches[0])
        placed = all(x is None or tuple(x.placements) == tuple(y.placements)
                     for x, y in zip(tree_leaves(g), tree_leaves(params)))
        g = step.dp.mean_grads(g)
        losses = []
        for b in batches:
            params, opt, sparse, m = step(params, opt, sparse, b)
            losses.append(float(m["loss"]))
    out[c["name"]] = {{"losses": losses, "grads": locals_(g),
                      "placements_equal": placed, "params": locals_(params),
                      "model_dims": tree_map(spmd.model_dim, params)}}
for c in spec["serve"]:
    cfg = dataclasses.replace(C.get_reduced(c["arch"]), **c["changes"])
    params = place_params(convert.lm_params_from_numpy(c["params"], cfg,
                                                       "cpu"), cfg, mesh)
    prompt = rows(c["prompt"])
    with torch.no_grad(), spmd.activate(mesh, seq_shard=c["seq"]):
        logits, cache = T.prefill(params, cfg, prompt, c["max_seq"],
                                  attn="flash")
        steps, toks = [whole_vocab(logits)], []
        for i in range({new}):
            tok = pick(logits)
            toks.append(tok)
            logits, cache = T.decode_step(params, cache, tok, cfg)
            steps.append(whole_vocab(logits))
        greedy = generate(params, cfg, prompt, {new}, max_seq=c["max_seq"])
        sampled = generate(params, cfg, prompt, {new}, max_seq=c["max_seq"],
                           temperature=0.7,
                           generator=torch.Generator().manual_seed(5))
    out[c["name"] + "/serve"] = {{"logits": steps, "tokens": torch.stack(toks, 1),
                                "greedy": greedy, "sampled": sampled}}
for c in spec["count"]:
    cfg = C.get_reduced(c["arch"])
    hp = TrainHParams(**c["hp"])
    shape = ShapeConfig("count", c["seq"], c["batch"], c["kind"])
    gen = torch.Generator().manual_seed(0)
    parts = {{"params": place_params(T.init_params(gen, cfg, device="cpu"),
                                    cfg, mesh)}}
    w = shape.global_batch // dp_size(mesh)
    ids = lambda *s: torch.randint(0, cfg.vocab, s, generator=gen)
    if shape.kind == "train":
        parts["opt_state"] = adamw_init(parts["params"], DataParallel(
            mesh, cfg, hp).zero1_layout(parts["params"]))
        parts["sparse_state"] = SparseTrainState.init(cfg.n_layers,
                                                      cfg.d_model, "cpu")
    if shape.kind == "decode":
        parts["tokens"] = ids(w)
        parts["cache"] = T.init_cache(cfg, w, shape.seq_len, device="cpu",
                                      mesh=mesh)
    else:
        b = {{"embeds": torch.randn((w, shape.seq_len, cfg.frontend_dim),
                                   generator=gen)}} if cfg.frontend else \
            {{"tokens": ids(w, shape.seq_len)}}
        if shape.kind == "train":
            b["labels"] = ids(w, shape.seq_len)
        parts["batch"] = b
    run = D.cell_step(cfg, shape, hp, "flash", None, parts, mesh=mesh)
    with spmd.activate(mesh), spmd.count_collectives() as counter:
        run()
    out["count/" + c["name"]] = counter.record()
torch.save(out, os.path.join(out_dir, f"rank{{rank}}.pt"))
dist.destroy_process_group()
"""


def _cfgs(name):
    arch, changes, _, _, remat, _ = CASES[name]
    return (dataclasses.replace(JC.get_reduced(arch), remat=remat, **changes),
            dataclasses.replace(C.get_reduced(arch), remat=remat, **changes))


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = ({"embeds": rng.standard_normal((BATCH, SEQ, cfg.frontend_dim))
              .astype(np.float32)} if cfg.frontend else
             {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ))
              .astype(np.int64)})
        b["labels"] = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int64)
        out.append(b)
    return out


def _prompt(cfg):
    return np.random.default_rng(3).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)


_REF: dict = {}          # the one-device runs, shared by the meshes


def _train_ref(name):
    if name not in _REF:
        jc, tc = _cfgs(name)
        jhp, thp = _hps(CASES[name][2])
        jp = jtrain.init_train_state(jax.random.PRNGKey(0), jc, jhp)[0]
        batches = _batches(tc, 7)
        np_params = _np(jp)
        _REF[name] = dict(params=np_params, batches=batches,
                          reference=_reference_train(jc, jhp, jp, batches),
                          port=_port_train(tc, thp, np_params, batches))
    return _REF[name]


def _serve_ref(name):
    """The reference's prefill, greedy decode steps and ``generate`` on one
    device, on the whole batch."""
    key = ("serve", name)
    if key not in _REF:
        jc, tc = _cfgs(name)
        jc = dataclasses.replace(jc, remat=False)
        jp = JT.init_params(jax.random.PRNGKey(1), jc)
        prompt = jnp.asarray(_prompt(tc).astype(np.int32))
        max_seq = PROMPT + NEW
        logits, cache = JT.prefill(jp, jc, prompt, max_seq)
        steps, toks = [logits], []
        for _ in range(NEW):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(tok)
            logits, cache = JT.decode_step(jp, cache, tok, jc)
            steps.append(logits)
        greedy = jserve.generate(jp, jc, prompt, NEW, max_seq=max_seq)
        _REF[key] = dict(
            params=_np(jp), prompt=_prompt(tc),
            steps=[torch.as_tensor(np.array(x)) for x in steps],
            tokens=torch.as_tensor(np.asarray(jnp.stack(toks, 1)),
                                   dtype=torch.long),
            greedy=torch.as_tensor(np.asarray(greedy), dtype=torch.long))
    return _REF[key]


def _count_cells():
    return [dict(name=f"{a}/{k}", arch=a, kind=k, hp=COUNT_HP, seq=SEQ,
                 batch=BATCH) for a in COUNT_ARCHS for k in COUNT_KINDS]


def _meta_counts(world, model):
    """Each count cell on ``meta`` as rank 0 of a fake group of ``world``
    ranks, on the host mesh of the spawned ranks."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_fake_group, make_host_mesh
    init_fake_group(world)
    try:
        mesh = make_host_mesh(model=model, device="cpu")
        out = {}
        for c in _count_cells():
            cfg = C.get_reduced(c["arch"])
            shape = ShapeConfig("count", c["seq"], c["batch"], c["kind"])
            out[c["name"]] = D.tensor_parallel_cell(
                cfg, shape, TrainHParams(**c["hp"]), "flash", None, mesh,
                {"seq_shard": False})["collectives"]
        return out
    finally:
        dist.destroy_process_group()


def _run_mesh(mesh_id, tmp):
    world, model = MESHES[mesh_id]
    spec = {"train": [], "serve": [], "count": []}
    for name, (arch, changes, hp, seq, remat, meshes) in CASES.items():
        if mesh_id not in meshes:
            continue
        r = _train_ref(name)
        spec["train"].append(dict(name=name, arch=arch, changes=changes,
                                  hp=hp, opt=OPT, seq=seq, remat=remat,
                                  params=r["params"], batches=r["batches"]))
        s = _serve_ref(name)
        spec["serve"].append(dict(name=name, arch=arch, changes=changes,
                                  seq=seq, max_seq=PROMPT + NEW,
                                  params=s["params"], prompt=s["prompt"]))
    if mesh_id in COUNT_MESHES:
        spec["count"] = _count_cells()
    path = os.path.join(tmp, "spec.pt")
    torch.save(spec, path)
    code = WORKER.format(src=os.path.join(_ROOT, "src"), new=NEW)
    _spawn(world, ["-c", code, path, tmp, str(model)])
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    meta = _meta_counts(world, model) if spec["count"] else {}
    return world, model, ranks, meta


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's ranks, spawned at most once."""
    done = {}

    def get(mesh_id):
        if mesh_id not in done:
            done[mesh_id] = _run_mesh(
                mesh_id, str(tmp_path_factory.mktemp("cut" + mesh_id)))
        return done[mesh_id]
    return get


RUNS = [pytest.param(m, n, id=f"{m}-{n}")
        for n, c in CASES.items() for m in c[5]]


@pytest.mark.parametrize("mesh_id,name", RUNS)
def test_train_losses_match_one_process_and_reference(runs, mesh_id, name):
    _, _, ranks, _ = runs(mesh_id)
    r0 = ranks[0][name]
    loss0, _, jlosses, _ = _train_ref(name)["reference"]
    _, plosses, _ = _train_ref(name)["port"]
    for got, want in ((r0["losses"], jlosses), (r0["losses"], plosses)):
        assert np.allclose(got, want, rtol=LOSS_REL, atol=0), (got, want)
    assert abs(jlosses[0] - loss0) <= LOSS_REL * abs(loss0)
    for r in ranks:
        assert r[name]["losses"] == r0["losses"]


@pytest.mark.parametrize("mesh_id,name", RUNS)
def test_train_grads_match_and_keep_their_placements(runs, mesh_id, name):
    _, _, ranks, _ = runs(mesh_id)
    r0 = ranks[0][name]
    dims = _flat(r0["model_dims"])
    got = {k: _whole(ranks, lambda r, k=k: _flat(r[name]["grads"])[k],
                         dims[k]) for k, g in _flat(r0["grads"]).items()
           if g is not None}
    ref = _train_ref(name)
    pgrads = _flat(ref["port"][0])
    jgrads = _jflat(ref["reference"][1])
    assert got.keys() == {k for k, g in pgrads.items() if g is not None}
    for k, g in got.items():
        _close(g, pgrads[k].detach(), GRAD_RTOL)
        _close(g, jgrads[k], GRAD_RTOL)
    assert all(r[name]["placements_equal"] for r in ranks)


@pytest.mark.parametrize("mesh_id,name", RUNS)
def test_train_params_match_and_the_placements_are_the_cut(runs, mesh_id,
                                                            name):
    """The params after the steps against the 1-process ones and the
    reference's; the cut leaves placed as the rules place them: ``wq`` on
    its columns (heads cut), ``lm_head`` on its rows where the vocabulary
    does not split."""
    _, model, ranks, _ = runs(mesh_id)
    r0 = ranks[0][name]
    dims = _flat(r0["model_dims"])
    ref = _train_ref(name)
    want, jwant = _flat(ref["port"][2]), _jflat(ref["reference"][3])
    for k, d in dims.items():
        got = _whole(ranks, lambda r, k=k: _flat(r[name]["params"])[k], d)
        if not got.is_floating_point():
            assert torch.equal(got, want[k])
            continue
        assert _rel_l2(got, want[k]) <= PARAM_REL_L2, k
        assert _rel_l2(got, torch.as_tensor(np.array(jwant[k], np.float32))
                       ) <= PARAM_REL_L2, k
    _, tc = _cfgs(name)
    if tc.vocab % model:
        assert dims[("lm_head",)] == 0
    else:
        assert dims[("lm_head",)] == 1
        assert tc.n_heads % model and dims[("layers", "attn", "wq", "w")] == 2


@pytest.mark.parametrize("mesh_id,name", RUNS)
def test_prefill_decode_and_generate_match_reference(runs, mesh_id, name):
    """The prefill's and each greedy decode step's logits (each rank's
    vocab block gathered, or whole on every rank where the head is on its
    rows) against the reference's on its DP rows; the greedy tokens and
    ``generate``'s equal to the reference's on every rank; the sampled
    tokens equal on every rank of a DP row."""
    world, model, ranks, _ = runs(mesh_id)
    ref = _serve_ref(name)
    dp = world // model
    w = BATCH // dp
    key = name + "/serve"
    for d in range(dp):
        mine = sorted((r for r in ranks if r["dp_rank"] == d),
                      key=lambda r: r["model_rank"])
        rows = slice(d * w, (d + 1) * w)
        for i, want in enumerate(ref["steps"]):
            parts = [r[key]["logits"][i] for r in mine]
            split = parts[0][1]
            got = torch.cat([p for p, _ in parts], -1) if split \
                else parts[0][0]
            if not split:
                assert all(torch.equal(p, got) for p, _ in parts)
            want = want[rows]
            assert got.shape == want.shape
            assert float((got - want).abs().max()) <= \
                LOGIT_RTOL * float(want.abs().max()), (name, i)
        for r in mine:
            assert torch.equal(r[key]["tokens"], ref["tokens"][rows])
            assert torch.equal(r[key]["greedy"], ref["greedy"][rows])
            assert torch.equal(r[key]["sampled"], mine[0][key]["sampled"])
            assert r[key]["sampled"].shape == (w, PROMPT + NEW)


COUNT_RUNS = [pytest.param(m, f"{a}/{k}", id=f"{m}-{a}-{k}")
              for m in COUNT_MESHES for a in COUNT_ARCHS for k in COUNT_KINDS]


@pytest.mark.parametrize("mesh_id,cell", COUNT_RUNS)
def test_counted_collectives_equal_the_meta_count(runs, mesh_id, cell):
    """The collectives of the real step on every gloo rank, counted by
    ``spmd.count_collectives``, equal the dry run's count of the same cell
    on ``meta`` over a fake group of the same size: calls, payload and
    wire bytes by op, exactly."""
    _, _, ranks, meta = runs(mesh_id)
    want = meta[cell]
    assert want["per_op"] and want["payload_bytes"] > 0
    for r in ranks:
        assert r["count/" + cell] == want, (r["rank"], r["count/" + cell],
                                            want)
