"""The port's slot-sharded serving fleet under live DSST epochs, its
checkpoints, ``elastic_remesh`` onto slot meshes and the registry's
``serving.chunk_fn[sharded]`` entry (the chunk step and the scheduler are in
tests/test_torch_sharding.py).

The reference's own sharded topology test fails, so the port's 8-shard
fleet (a mesh listing the CPU eight times) is held bit for bit against the
port's 1-device fleet: epochs, params, masks, deltas, predictions; and the
1-device fleet against the reference's 1-device fleet, from the same params
and events: equal epochs and masks, logits and deltas within ``atol =
1e-4`` (tests/test_torch_topology_service.py). A sharded fleet's
checkpoint holds the arrays a 1-device fleet's holds, bit for bit. The
registry's sharded entry passes its contracts per shard and catches a
planted cross-shard reduction and a planted collective.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import dsst as jdsst, snn as jsnn
from repro.serving import ReplaySource as JReplaySource
from repro.serving import StreamScheduler as JStreamScheduler
from repro.serving import StreamSession as JStreamSession
from repro.serving import TopologyService as JTopologyService
from repro.serving import TopologyServiceConfig as JServiceConfig
from repro_torch import convert
from repro_torch.analysis import dispatch_contracts as dc
from repro_torch.analysis import registry
from repro_torch.core import snn, topology
from repro_torch.core.dsst import DSSTConfig
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.runtime import elastic_remesh
from repro_torch.serving import (ReplaySource, StreamScheduler, StreamSession,
                                 TopologyService, TopologyServiceConfig,
                                 restore_fleet, save_fleet)

torch.set_num_threads(1)

N_DEV = 8


def _mesh(n=N_DEV):
    return make_serving_mesh(devices=["cpu"] * n)


def _same_sessions(a, b):
    assert sorted(a) == sorted(b)
    for sid in a:
        assert a[sid].timesteps_fed == b[sid].timesteps_fed
        assert len(a[sid].predictions) == len(b[sid].predictions) > 0
        for pa, pb in zip(a[sid].predictions, b[sid].predictions):
            np.testing.assert_array_equal(pa.logits, pb.logits)
        np.testing.assert_array_equal(a[sid].final_deltas,
                                      b[sid].final_deltas)


def _close_sessions(got, want):
    assert sorted(got) == sorted(want)
    for sid in want:
        assert len(got[sid].predictions) == len(want[sid].predictions) > 0
        for pa, pb in zip(got[sid].predictions, want[sid].predictions):
            assert pa.label == pb.label
            np.testing.assert_allclose(pa.logits, pb.logits, atol=1e-4)
        np.testing.assert_allclose(got[sid].final_deltas,
                                   want[sid].final_deltas, atol=1e-4)


TKW = dict(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=12)
TCFG = snn.SNNConfig(**TKW, dsst=DSSTConfig(period=4, prune_frac=0.5))
JTCFG = jsnn.SNNConfig(**TKW, dsst=jdsst.DSSTConfig(period=4,
                                                    prune_frac=0.5))


@pytest.fixture(scope="module")
def topo_runs():
    """The reference's sharded topology scenario: the port on 8 shards and
    on 1 device, and the reference on 1 device."""
    jparams = jax.device_get(jsnn.init_params(jax.random.PRNGKey(0), JTCFG))
    params = convert.params_from_numpy(jparams, TCFG, "cpu")
    svc_kw = dict(epoch_every=3, merge_top=1)

    def events(seed):
        r = np.random.default_rng(seed)
        return (r.random((54, TCFG.n_in)) < 0.3).astype(np.float32)

    def drive(mesh):
        svc = TopologyService(TCFG, TopologyServiceConfig(**svc_kw))
        sched = StreamScheduler(params, TCFG, n_slots=16, chunk_len=6,
                                mesh=mesh, topology=svc, device="cpu")
        for sid in range(6):
            sched.submit(StreamSession(sid=sid, source=ReplaySource(
                events(sid), chunk_len=6), adapt=(sid % 2 == 0)))
        return sched, svc, {s.sid: s for s in sched.run_until_drained()}

    jsvc = JTopologyService(JTCFG, JServiceConfig(**svc_kw))
    jsched = JStreamScheduler(jparams, JTCFG, n_slots=16, chunk_len=6,
                              topology=jsvc)
    for sid in range(6):
        jsched.submit(JStreamSession(sid=sid, source=JReplaySource(
            events(sid), chunk_len=6), adapt=(sid % 2 == 0)))
    jdone = {s.sid: s for s in jsched.run_until_drained()}
    return drive(None), drive(_mesh()), (jsched, jsvc, jdone)


def _epochs(svc):
    return [(e.epoch, e.grid_step, e.pruned, e.regrown, e.mask_change,
             e.merged_slots) for e in svc.events]


def test_sharded_topology_evolution_equals_one_device(topo_runs):
    (s1, v1, d1), (s8, v8, d8), _ = topo_runs
    assert v1.epoch_idx >= 2 and _epochs(v8) == _epochs(v1)
    assert sum(e.pruned for e in v1.events) > 0
    assert any(e.merged_slots for e in v1.events)
    assert s1.n_compiles == 1 and s8.n_compiles == 1
    assert isinstance(s8._tiers[0].deltas, SH.SlotSharded)
    assert topology.check(s8.params["hidden"]["mask"], TCFG)
    for a, b in zip(torch.utils._pytree.tree_leaves(s1.params),
                    torch.utils._pytree.tree_leaves(s8.params)):
        assert torch.equal(a, b)
    assert torch.equal(s1.deltas, s8.deltas)
    _same_sessions(d1, d8)


def test_one_device_topology_fleet_matches_reference(topo_runs):
    (s1, v1, d1), _, (jsched, jsvc, jdone) = topo_runs
    assert v1.epoch_idx == jsvc.epoch_idx >= 2
    assert [(e.pruned, e.regrown, e.merged_slots) for e in v1.events] == \
        [(e.pruned, e.regrown, e.merged_slots) for e in jsvc.events]
    np.testing.assert_array_equal(s1.params["hidden"]["mask"].numpy(),
                                  np.asarray(jsched.params["hidden"]["mask"]))
    _close_sessions(d1, jdone)


def test_sharded_fleet_checkpoint_round_trip(topo_runs, tmp_path):
    """A sharded fleet writes the files the 1-device fleet writes (arrays
    bit for bit); restored onto a mesh it comes back sharded and equal."""
    (s1, _, _), (s8, _, _), _ = topo_runs
    step = s1.grid.stats["steps"]
    p1 = save_fleet(str(tmp_path / "one"), step, s1.params, s1.deltas,
                    s1.state)
    p8 = save_fleet(str(tmp_path / "eight"), step, s8.params,
                    s8._tiers[0].deltas, s8._tiers[0].state)
    assert sorted(p.name for p in (tmp_path / "one").rglob("*")) == \
        sorted(p.name for p in (tmp_path / "eight").rglob("*"))
    assert open(f"{p1}/manifest.json").read() == \
        open(f"{p8}/manifest.json").read()
    with np.load(f"{p1}/arrays.npz") as a, np.load(f"{p8}/arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    mesh = _mesh(4)
    rstep, rp, rd, rs, extra = restore_fleet(str(tmp_path / "eight"), TCFG,
                                             mesh=mesh)
    assert rstep == step and extra["n_slots"] == 16
    assert isinstance(rd, SH.SlotSharded) and rd.mesh == mesh
    assert torch.equal(rd.full(), s8.deltas)
    for a, b in zip(torch.utils._pytree.tree_leaves(s8.state),
                    torch.utils._pytree.tree_leaves(SH.gather(rs))):
        assert torch.equal(a, b)


def test_elastic_remesh_onto_slot_meshes(topo_runs):
    """A fleet tree from 8 shards to 2 and back, and onto one device: bit
    for bit; replicated leaves one copy an entry."""
    _, (s8, _, _), _ = topo_runs

    def spec_fn(path):
        return None if path[0] == "params" else SH.slot_spec(0)
    tree = {"params": s8.params, "deltas": s8._tiers[0].deltas,
            "state": s8._tiers[0].state}
    on2 = elastic_remesh(tree, _mesh(2), spec_fn)
    assert on2["deltas"].width == 8 and on2["state"].x_tr.mesh.size == 2
    w = on2["params"]["hidden"]["w"]
    assert isinstance(w, SH.Replicated) and \
        w.replicas[0].data_ptr() != w.replicas[1].data_ptr()
    back = elastic_remesh(on2, [torch.device("cpu")] * N_DEV, spec_fn)
    assert back["deltas"].width == 2
    one = elastic_remesh(back, "cpu", spec_fn)
    want = SH.gather(tree)
    for t in (SH.gather(on2), SH.gather(back), one):
        for a, b in zip(torch.utils._pytree.tree_leaves(want),
                        torch.utils._pytree.tree_leaves(t)):
            assert torch.equal(a, b)


# ------------------------------------------------------------ the registry

def test_registry_sharded_entry_passes_and_is_per_shard():
    fn, args, contracts, _ = registry.build("serving.chunk_fn[sharded]",
                                            "cpu")
    assert fn.mesh.size == 2
    rep = dc.check(fn, args, contracts)
    assert rep.ok, str(rep)
    leaves = torch.utils._pytree.tree_leaves(dc.record(fn, args).result)
    assert {t.shape[0] for t in leaves if t.dim() == 1} == {3}   # a shard


@pytest.fixture
def gloo():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.new_group([0], group_desc="slots")
    finally:
        dist.destroy_process_group()


def test_registry_sharded_entry_catches_a_cross_shard_reduction():
    fn, args, contracts, _ = registry.build("serving.chunk_fn[sharded]",
                                            "cpu")

    def leaky(*a):
        d, s, m = fn(*a)
        total = sum(x.sum() for x in m.sop_forward.shards)
        return d, s, m._replace(sop_forward=total)
    rep = dc.check(leaky, args, [dc.slot_separable(
        3, exempt=(".pre_mag", ".post_mag"))])
    assert [v.contract for v in rep.violations] == ["slot_separable"]
    assert "sop_forward" in str(rep)


def test_registry_sharded_entry_catches_a_collective(gloo):
    fn, args, contracts, _ = registry.build("serving.chunk_fn[sharded]",
                                            "cpu")

    def chatty(*a):
        d, s, m = fn(*a)
        dist.all_reduce(m.sop_forward.shards[0], group=gloo)
        return d, s, m
    rep = dc.check(chatty, args, [dc.no_collectives()])
    assert [v.contract for v in rep.violations] == ["no_collectives"]
