"""The port's fault tolerance (``repro_torch.runtime.fault_tolerance``)
against the JAX reference's (``repro.runtime.fault_tolerance``).

Recovery is compared bit for bit (no tolerance): a restart moves stored
numbers and replays step-indexed ones. The step functions of both packages
compute the same f32 products and sums on numpy data drawn per step, so
their states are equal bit for bit too. The port's steps update the state
in place, as its AdamW does, so every run starts from its own clone of the
initial state (``run_with_recovery`` takes the initial state over).

The reference saves its initial state as step -1 under a name its
``latest_step`` never matches, so a failure before the first periodic save
raises ``FileNotFoundError`` there; the port restores step -1 by name.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import fault_tolerance as jft
import repro_torch.configs as C
from repro_torch.data.pipeline import PipelineConfig, synthetic_lm_batch
from repro_torch.launch.train import TrainHParams, init_train_state, make_train_step
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 StragglerPolicy,
                                                 elastic_remesh,
                                                 run_with_recovery)

torch.set_num_threads(1)


def _step_fn():
    """A state-dependent, data-indexed step (mimics train: state + step),
    the reference test's, with the data drawn by torch from the step."""
    def step_fn(state, step):
        data = torch.randn(4, generator=torch.Generator().manual_seed(step))
        return state * 0.99 + data.sum(), {}
    return step_fn


# ---------------------------------------------------------------------------
# the reference's five tests, mirrored
# ---------------------------------------------------------------------------

def test_recovery_bitwise_identical(tmp_path):
    fn = _step_fn()
    ref, _ = run_with_recovery(fn, torch.tensor(1.0), 25, str(tmp_path / "a"),
                               ckpt_every=5)
    out, log = run_with_recovery(fn, torch.tensor(1.0), 25, str(tmp_path / "b"),
                                 ckpt_every=5, fail_at={7: 1, 18: 2})
    assert log["restarts"] == 3
    assert torch.equal(ref, out)


def test_recovery_resumes_from_latest(tmp_path):
    fn = _step_fn()
    _, log = run_with_recovery(fn, torch.tensor(0.0), 22, str(tmp_path),
                               ckpt_every=10, fail_at={15: 1})
    assert log["restored_from"] == [9]


def _timings(n, slow, seed=0):
    rng = np.random.default_rng(seed)
    return [[(2.5 if r == slow else 1.0) + rng.normal() * 0.02
             for r in range(n)] for _ in range(10)]


def _feed(monitors, rows):
    for row in rows:
        for r, t in enumerate(row):
            for mon in monitors:
                mon.record(r, t)


def test_straggler_detection():
    mon = HeartbeatMonitor(8, StragglerPolicy(threshold=1.5, min_steps=3))
    ref = jft.HeartbeatMonitor(8, jft.StragglerPolicy(threshold=1.5,
                                                      min_steps=3))
    _feed([mon, ref], _timings(8, slow=5))
    assert mon.stragglers() == [5]
    assert 5 not in mon.healthy_replicas()
    # the same timings give the reference's EMAs, counts and verdicts
    assert np.array_equal(mon.ema, ref.ema) and np.array_equal(mon.count,
                                                               ref.count)
    assert mon.stragglers() == ref.stragglers()
    assert mon.healthy_replicas() == ref.healthy_replicas()


def test_no_false_positives_uniform():
    mon, ref = HeartbeatMonitor(4), jft.HeartbeatMonitor(4)
    _feed([mon, ref], [[1.0] * 4] * 10)
    assert mon.stragglers() == [] == ref.stragglers()


@pytest.mark.parametrize("rows,policy", [
    (_timings(6, slow=2, seed=3)[:2], (1.5, 0.3, 3)),    # inside the grace period
    (_timings(6, slow=0, seed=4), (1.2, 0.5, 2)),
    (_timings(5, slow=4, seed=5), (3.0, 0.3, 3)),         # not slow enough
])
def test_monitor_matches_reference(rows, policy):
    th, ema, mins = policy
    mon = HeartbeatMonitor(len(rows[0]), StragglerPolicy(th, ema, mins))
    ref = jft.HeartbeatMonitor(len(rows[0]), jft.StragglerPolicy(th, ema, mins))
    _feed([mon, ref], rows)
    assert np.array_equal(mon.ema, ref.ema)
    assert np.array_equal(mon.count, ref.count)
    assert mon.stragglers() == ref.stragglers()
    assert mon.healthy_replicas() == ref.healthy_replicas()


def test_elastic_remesh_changes_sharding():
    tree = {"w": torch.ones((8, 8)), "opt": (torch.arange(3), 7)}
    for target in (torch.device("cpu"), [torch.device("cpu")], "cpu"):
        for spec in (None, ()):
            out = elastic_remesh(tree, target, lambda path, s=spec: s)
            assert out["w"].device == torch.device("cpu")
            assert torch.equal(out["w"], tree["w"])
            assert torch.equal(out["opt"][0], tree["opt"][0])
            assert out["opt"][1] == 7 and isinstance(out["opt"], tuple)


def test_elastic_remesh_refuses_what_needs_a_mesh():
    """A model or data axis is refused on a slot mesh (two devices listed
    make one), which has neither; on one device every leaf moves whole
    whatever its spec. Placement onto slot meshes is held in
    tests/test_torch_sharding.py, onto LM meshes in
    tests/test_torch_elastic_lm.py."""
    tree = {"w": torch.ones((8, 8))}
    for axis in ("model", "data"):
        with pytest.raises(ValueError, match="slot mesh"):
            elastic_remesh(tree, [torch.device("cpu")] * 2,
                           lambda path, a=axis: (a,))
    out = elastic_remesh(tree, torch.device("cpu"), lambda path: ("data",))
    assert torch.equal(out["w"], tree["w"])
    paths = []
    elastic_remesh({"a": {"b": torch.ones(1)}, "c": [torch.ones(1)]}, "cpu",
                   lambda path: paths.append(path))
    assert sorted(paths) == [("a", "b"), ("c", "0")]


# ---------------------------------------------------------------------------
# both packages on one step function
# ---------------------------------------------------------------------------

def _data(step):
    d = np.random.default_rng(step).standard_normal((3, 4)).astype(np.float32)
    return d, d.sum(0)


def _jax_step(state, step):
    d, s = _data(step)
    return {"w": state["w"] * np.float32(0.99) + d, "b": state["b"] + s}, {}


def _torch_step(state, step):
    """In place, as the port's AdamW updates its state."""
    d, s = _data(step)
    state["w"].mul_(0.99).add_(torch.from_numpy(d))
    state["b"].add_(torch.from_numpy(s))
    return state, {}


def _init():
    rng = np.random.default_rng(123)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}


@pytest.mark.parametrize("n,every,fail_at", [
    (25, 5, {7: 1, 18: 2}),
    (22, 10, {15: 1}),
    (12, 3, {3: 1, 4: 1, 11: 2}),
    (10, 4, {}),
])
def test_recovery_matches_reference(tmp_path, n, every, fail_at):
    init = _init()
    jout, jlog = jft.run_with_recovery(
        _jax_step, jax.tree.map(jnp.asarray, init), n, str(tmp_path / "j"),
        ckpt_every=every, fail_at=fail_at)
    tout, tlog = run_with_recovery(
        _torch_step, {k: torch.tensor(v) for k, v in init.items()}, n,
        str(tmp_path / "t"), ckpt_every=every, fail_at=fail_at)
    assert tlog == jlog
    for k in init:
        assert np.array_equal(tout[k].numpy(), np.asarray(jout[k])), k
    # and the uninterrupted run of the same steps
    straight = {k: torch.tensor(v) for k, v in init.items()}
    for step in range(n):
        straight, _ = _torch_step(straight, step)
    for k in init:
        assert torch.equal(tout[k], straight[k]), k


def test_failure_before_the_first_save(tmp_path):
    """The reference cannot restart before its first periodic save (step -1
    is saved under a name ``latest_step`` skips); the port restores it."""
    init = _init()
    with pytest.raises(FileNotFoundError):
        jft.run_with_recovery(_jax_step, jax.tree.map(jnp.asarray, init), 8,
                              str(tmp_path / "j"), ckpt_every=5,
                              fail_at={2: 1})
    out, log = run_with_recovery(
        _torch_step, {k: torch.tensor(v) for k, v in init.items()}, 8,
        str(tmp_path / "t"), ckpt_every=5, fail_at={2: 1, 0: 1, 6: 1})
    assert log == {"restarts": 3, "restored_from": [-1, -1, 4]}
    straight = {k: torch.tensor(v) for k, v in init.items()}
    for step in range(8):
        straight, _ = _torch_step(straight, step)
    for k in init:
        assert torch.equal(out[k], straight[k]), k
    # the layout is the reference's: it reads the port's step -1 back
    _, back, _ = jft.ckpt.restore(str(tmp_path / "t"),
                                  jax.tree.map(jnp.asarray, init), step=-1)
    for k in init:
        assert np.array_equal(np.asarray(back[k]), init[k]), k


def test_resume_from_an_existing_directory(tmp_path):
    """A directory that holds a valid step resumes after it (into the
    initial state's structure), as the reference does; its log is empty."""
    init = _init()
    first, _ = run_with_recovery(
        _torch_step, {k: torch.tensor(v) for k, v in init.items()}, 6,
        str(tmp_path), ckpt_every=3)
    fresh = {k: torch.zeros_like(torch.tensor(v)) for k, v in init.items()}
    out, log = run_with_recovery(_torch_step, fresh, 9, str(tmp_path),
                                 ckpt_every=3)
    assert log == {"restarts": 0, "restored_from": []}
    straight = {k: torch.tensor(v) for k, v in init.items()}
    for step in range(9):
        straight, _ = _torch_step(straight, step)
    for k in init:
        assert torch.equal(out[k], straight[k]), k
    # past max_restarts the failure propagates
    with pytest.raises(ft.SimulatedFailure):
        run_with_recovery(_torch_step, {k: torch.tensor(v)
                                        for k, v in init.items()},
                          4, str(tmp_path / "x"), fail_at={1: 3},
                          max_restarts=2)


def test_restore_reads_nothing_a_failed_step_wrote(tmp_path):
    """A step that writes garbage into the state and then fails: the restart
    restores the checkpoint, never the written tensors."""
    init = _init()
    armed = {5: True}

    def poisoned(state, step):
        state, m = _torch_step(state, step)
        if armed.pop(step, False):
            state["w"].fill_(float("nan"))
            raise ft.SimulatedFailure("lost mid-step")
        return state, m
    out, log = run_with_recovery(
        poisoned, {k: torch.tensor(v) for k, v in init.items()}, 8,
        str(tmp_path), ckpt_every=2)
    assert log == {"restarts": 1, "restored_from": [3]}
    straight = {k: torch.tensor(v) for k, v in init.items()}
    for step in range(8):
        straight, _ = _torch_step(straight, step)
    for k in init:
        assert torch.equal(out[k], straight[k]), k


# ---------------------------------------------------------------------------
# the port's LM training step, as examples/elastic_recovery_demo.py runs it
# ---------------------------------------------------------------------------

def test_lm_training_recovers_bit_for_bit(tmp_path):
    cfg = C.get_reduced("phi3_medium_14b")
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100))
    pcfg = PipelineConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    step = make_train_step(cfg, hp)
    losses = {}

    def step_fn(state, i):
        params, opt, ss = state
        batch = {k: torch.from_numpy(v).long()
                 for k, v in synthetic_lm_batch(pcfg, i).items()}
        params, opt, ss, m = step(params, opt, ss, batch)
        losses[i] = float(m["loss"])
        return (params, opt, ss), {"loss": losses[i]}

    init = init_train_state(torch.Generator().manual_seed(0), cfg, hp, "cpu")
    ref, rlog = run_with_recovery(step_fn, copy.deepcopy(init), 14,
                                  str(tmp_path / "a"), ckpt_every=5)
    out, log = run_with_recovery(step_fn, copy.deepcopy(init), 14,
                                 str(tmp_path / "b"), ckpt_every=5,
                                 fail_at={2: 1, 12: 1})
    assert rlog == {"restarts": 0, "restored_from": []}
    assert log == {"restarts": 2, "restored_from": [-1, 9]}
    assert out[1].step == ref[1].step == 14
    flat_o = ft._flatten(out)
    flat_r = ft._flatten(ref)
    assert [k for k, _ in flat_o] == [k for k, _ in flat_r]
    for (k, a), (_, b) in zip(flat_o, flat_r):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        else:
            assert a == b, k
    # the initial state, cloned for each run, was never written
    fresh = init_train_state(torch.Generator().manual_seed(0), cfg, hp, "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(ft._flatten(init), ft._flatten(fresh))
               if isinstance(a, torch.Tensor))
