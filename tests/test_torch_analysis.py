"""The port's dispatch-trace contract checker (``repro_torch.analysis``)
against the reference's jaxpr contract checker (``repro.analysis``).

Each contract must catch its planted violation on a toy function and pass
its clean twin, one test per case of ``tests/test_analysis.py`` (the
``no_collectives`` cases plant ``dist.all_reduce`` on a one-rank gloo group
where the reference plants a ``psum`` under ``shard_map``); where a toy
runs through both packages, both checkers give the same verdict. The
engine's per-chunk slot-separability assert accepts and rejects the same
carry trees as the reference's, with the same message; the port's
``scan_chunk`` runs it on every call, and a reduction over slots planted
into it fails. The registry passes every entry on the CPU, with the
reference's entry names (``serving.chunk_fn[sharded]`` included, on a
two-entry CPU slot mesh) and contract sets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import analysis as janalysis
from repro_torch import analysis
from repro_torch.analysis import dispatch_contracts as dc
from repro_torch.analysis import registry
from repro_torch.core import engine, snn
from repro_torch.serving.adapt import make_chunk_fn

S = 4     # toy slot count, distinct from every other extent used below


class _Cfg:
    """Duck-typed stand-in for SNNConfig (what the contract factories
    read)."""
    n_layers = 2
    n_hidden = 8
    layer_fanins = (16, 8)     # k_max = 16 != n_hidden


def _both(fn_np, contracts_of, args):
    """``fn_np(xp, *args)`` checked by both packages: (port, reference)."""
    port = analysis.check(lambda *a: fn_np(torch, *a),
                          [torch.as_tensor(a) for a in args],
                          contracts_of(analysis))
    ref = janalysis.check(lambda *a: fn_np(jnp, *a),
                          [jnp.asarray(a) for a in args],
                          contracts_of(janalysis))
    return port, ref


# ------------------------------------------------------- no_collectives

@pytest.fixture
def gloo():
    """A one-rank gloo world plus a group described as "slots" (the
    counterpart of the reference's one-device mesh axis)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.new_group([0], group_desc="slots")
    finally:
        dist.destroy_process_group()


def test_no_collectives_catches_planted_all_reduce(gloo):
    def planted(x):
        y = x * 2.0
        dist.all_reduce(y, group=gloo)
        return y

    r = analysis.check(planted, (torch.zeros((S, 3)),),
                       [analysis.no_collectives()])
    assert not r.ok
    assert any("allreduce" in v.message and "communication-free" in v.message
               for v in r.violations)
    with pytest.raises(analysis.ContractViolationError, match="allreduce"):
        r.raise_if_violations()


def test_no_collectives_passes_clean_twin(gloo):
    def clean(x):
        return x * 2.0

    analysis.check(clean, (torch.zeros((S, 3)),),
                   [analysis.no_collectives()]).raise_if_violations()


def test_no_collectives_axis_filter(gloo):
    def planted(x):
        dist.all_reduce(x, group=gloo)
        return x

    args = (torch.zeros((S, 3)),)
    assert not analysis.check(planted, args,
                              [analysis.no_collectives(axis="slots")]).ok
    # a collective over a *different* named group is out of scope
    assert analysis.check(planted, args,
                          [analysis.no_collectives(axis="model")]).ok


# ------------------------------------------------------- slot_separable

def test_slot_separable_catches_planted_slot_sum():
    def planted(xp, x):                  # x: [S, N]
        return {"kept": x * 2.0, "mean": x.sum(0)}

    port, ref = _both(planted, lambda a: [a.slot_separable(S)],
                      [np.zeros((S, 8), np.float32)])
    assert not port.ok and not ref.ok
    assert len(port.violations) == len(ref.violations) == 1
    assert "mean" in port.violations[0].message
    assert "lost the slot axis" in port.violations[0].message


def test_slot_separable_exempt_and_second_dim():
    def fn(xp, x):                       # slot axis allowed at dim 0 or 1
        return {"a": x, "b": xp.moveaxis(x, 0, 1), "mean": x.sum(0)}

    args = [np.zeros((S, 8), np.float32)]
    port, ref = _both(fn, lambda a: [a.slot_separable(S)], args)
    assert not port.ok and not ref.ok
    port, ref = _both(fn, lambda a: [a.slot_separable(S, exempt=("mean",))],
                      args)
    port.raise_if_violations()
    assert ref.ok


def test_slot_separable_reads_named_tuples_and_skips_absent_leaves():
    """The serving chunk fn's metrics are a NamedTuple whose factor fields
    are None with ``want_factors=False``: keystr paths read ``.pre_mag`` and
    a None is an absent leaf, as in a JAX tree."""
    from repro_torch.core.snn import ChunkMetrics

    def fn(x):
        fields = {f: None for f in ChunkMetrics._fields}
        fields.update(logits=x, pre_mag=x.sum(0))
        return ChunkMetrics(**fields)

    args = (torch.zeros((S, 3)),)
    r = analysis.check(fn, args, [analysis.slot_separable(S)])
    assert [v.message.split()[1] for v in r.violations] == [".pre_mag"]
    analysis.check(fn, args, [analysis.slot_separable(
        S, exempt=(".pre_mag",))]).raise_if_violations()


# ----------------------------------------------- mask_free / dense leaves

def test_mask_free_catches_planted_dense_mask():
    cfg = _Cfg()
    k_max = max(cfg.layer_fanins)
    mask = np.ones((cfg.n_layers, k_max, cfg.n_hidden), np.float32)

    def planted(xp, x):
        return (xp.asarray(mask) * x).sum()

    def clean(xp, x):
        return x * 2.0

    args = [np.zeros((), np.float32)]
    port, ref = _both(planted, lambda a: [a.mask_free(cfg)], args)
    assert not port.ok and not ref.ok
    assert any("dense layout" in v.message for v in port.violations)
    port, ref = _both(clean, lambda a: [a.mask_free(cfg)], args)
    port.raise_if_violations()
    assert ref.ok


def test_no_dense_deltas_catches_both_layouts():
    cfg = _Cfg()
    k_max = max(cfg.layer_fanins)

    def slot_leading(xp, x):
        return x + xp.zeros((S, cfg.n_layers, k_max, cfg.n_hidden))

    def layer_leading(xp, x):
        return x + xp.zeros((cfg.n_layers, S, k_max, cfg.n_hidden))

    args = [np.zeros((), np.float32)]
    for fn in (slot_leading, layer_leading):
        port, ref = _both(fn, lambda a: [a.no_dense_deltas(cfg, S)], args)
        assert not port.ok and not ref.ok


def test_no_dense_leaves_sees_inputs_and_results():
    """Every role counts: a forbidden tensor handed in, or returned
    untouched (no op ever sees it), still fails."""
    cfg = _Cfg()
    dense = torch.zeros((cfg.n_layers, 16, cfg.n_hidden))
    r = analysis.check(lambda m: m, (dense,), [analysis.mask_free(cfg)])
    assert {v.message.split()[0] for v in r.violations} == {"input",
                                                           "output"}


# ------------------------------------------------------ no_factor_carries

def _chunk_with_carries(n_lsn, n_lsk, cfg, C):
    """A toy chunk step that hands the engine hook a carry of ``n_lsn``
    [L,S,N] and ``n_lsk`` [L,S,Kmax] f32 tensors (as layer leaves)."""
    L, N, k_max = cfg.n_layers, cfg.n_hidden, max(cfg.layer_fanins)

    def fn(x):
        layers = ([torch.zeros((L, S, N)) + x for _ in range(n_lsn)]
                  + [torch.zeros((L, S, k_max)) + x for _ in range(n_lsk)])
        carry = (layers, torch.zeros((S, 3)), torch.zeros((L, S)),
                 torch.zeros((S,), dtype=torch.int32),
                 torch.zeros((S,), dtype=torch.int32),
                 torch.zeros((L, S, 2, N)))
        outs = {"logits": torch.zeros((C, S, 2))}
        dc.assert_chunk_carry_slot_separable(carry, outs, C=C, S=S,
                                             n_layers=L, want_factors=False)
        return carry, outs
    return fn


def test_no_factor_carries_catches_planted_accumulators():
    cfg, C = _Cfg(), 5
    contracts = [analysis.no_factor_carries(cfg, S, chunk_len=C)]
    args = (torch.zeros(()),)

    # 4 [L,S,N] carries = the LayerState leaves: allowed
    analysis.check(_chunk_with_carries(4, 0, cfg, C), args,
                   contracts).raise_if_violations()
    # a 5th [L,S,N] (the post_mag accumulator): caught
    assert not analysis.check(_chunk_with_carries(5, 0, cfg, C), args,
                              contracts).ok
    # any [L,S,Kmax] (the pre_mag accumulator; k_max != N here): caught
    assert not analysis.check(_chunk_with_carries(0, 1, cfg, C), args,
                              contracts).ok


def test_no_factor_carries_chunk_len_scoping():
    cfg, C = _Cfg(), 5
    # a chunk step of a DIFFERENT length may carry what it likes
    r = analysis.check(
        _chunk_with_carries(5, 1, cfg, C), (torch.zeros(()),),
        [analysis.no_factor_carries(cfg, S, chunk_len=C + 1)])
    assert r.ok


def _registry_chunk_args(compact=True):
    cfg = registry.snn_cfg()
    params, deltas, state, events, valid, amask = registry._snn_inputs(
        cfg, "cpu", compact=compact)
    return cfg, (snn.serving_params(params, cfg, compact=compact), deltas,
                 state, events, valid, amask)


def test_no_factor_carries_catches_zeroed_factors_at_uniform_geometry():
    """The registry's geometry has k_max == n_hidden, where shapes alone
    cannot tell an accumulator from a LayerState leaf: a chunk fn that
    computes the factors and multiplies them by 0 is caught by the count,
    the frozen chunk fn passes, and a target that never reaches the engine
    fails explicitly."""
    cfg, args = _registry_chunk_args()
    assert max(cfg.layer_fanins) == cfg.n_hidden
    contracts = [analysis.no_factor_carries(cfg, registry._S,
                                            chunk_len=registry._C)]
    with_factors = make_chunk_fn(cfg, want_factors=True)

    def zeroed(*a):
        d, s, m = with_factors(*a)
        return d, s, m._replace(pre_mag=m.pre_mag * 0, post_mag=m.post_mag * 0)

    r = analysis.check(zeroed, args, contracts)
    assert not r.ok and "6 f32 tensors" in r.violations[0].message
    analysis.check(make_chunk_fn(cfg, want_factors=False), args,
                   contracts).raise_if_violations()
    r = analysis.check(lambda *a: a[1] * 1.0, args, contracts)
    assert not r.ok and "bypasses scan_chunk" in r.violations[0].message


# ------------------------------------------------------ dtype_discipline

def test_dtype_discipline_catches_f64():
    def planted(x):
        return x.to(torch.float64) + 1.0

    r = analysis.check(planted, (torch.zeros((3,)),),
                       [analysis.dtype_discipline()])
    assert not r.ok
    assert any("float64" in v.message for v in r.violations)

    def clean(x):
        return x + 1.0

    analysis.check(clean, (torch.zeros((3,)),),
                   [analysis.dtype_discipline()]).raise_if_violations()


# -------------------------------------------------------- compile_count

def test_compile_count_passes_stable_entrypoint():
    cfg, args = _registry_chunk_args()
    fn = registry.counted(make_chunk_fn(cfg))
    r = analysis.check(fn, args, [analysis.compile_count()])
    r.raise_if_violations()
    assert r.calls == 3                  # the recorded run and two more


def test_compile_count_catches_retracing():
    """A target that builds its chunk fn anew on every call: the port's
    counterpart of a retrace."""
    cfg, args = _registry_chunk_args()
    fn = registry.counted(lambda *a: make_chunk_fn(cfg)(*a))
    r = analysis.check(fn, args, [analysis.compile_count()])
    assert not r.ok
    assert "retracing" in r.violations[0].message


def test_compile_count_requires_trace_counter():
    r = analysis.check(lambda x: x, (torch.zeros((2,)),),
                       [analysis.compile_count()])
    assert not r.ok and "n_traces" in r.violations[0].message


def test_compile_events_count_chunk_fns_built():
    from repro_torch.serving import adapt

    before, built = analysis.compile_events(), adapt.chunk_fns_built()
    make_chunk_fn(registry.snn_cfg())
    assert adapt.chunk_fns_built() == built + 1
    assert analysis.compile_events() == before + 1


# --------------------------------------------- the shared per-chunk assert

_L, _N, _C6 = 2, 8, 6
# leaf -> (good shape, the same leaf with its slot axis reduced away)
_LEAVES = {
    "v": ((_L, S, _N), (_L, _N)),
    "tr": ((_L, S, _N), (_L, _N)),
    "x_tr": ((S, 6), (6,)),
    "ss_mean": ((_L, S), (_L,)),
    "t_w": ((S,), ()),
    "samp": ((S,), ()),
    "dls": ((_L, S, 3, _N), (_L, 3, _N)),
    "acc_pre": ((_L, S, 5), (_L, 5)),
    "acc_post": ((_L, S, _N), (_L, _N)),
    "spk": ((_C6, S, _N), (_C6, _N)),
}
_CARRY_CASES = ([(wf, None) for wf in (False, True)]
                + [(False, k) for k in _LEAVES if not k.startswith("acc")]
                + [(True, k) for k in _LEAVES] + [(True, "no_acc")])


def _chunk_trees(zeros, want_factors, broken):
    """The carry and outs trees of a chunk step from numpy shapes, with
    leaf ``broken`` (if any) reduced over slots; ``"no_acc"`` drops the
    accumulators a factor-carrying step must have."""
    def leaf(k):
        return zeros(_LEAVES[k][1 if k == broken else 0])
    layers = {"v": leaf("v"), "tr": leaf("tr")}
    acc = ((leaf("acc_pre"), leaf("acc_post"))
           if want_factors and broken != "no_acc" else ())
    return ((layers, leaf("x_tr"), leaf("ss_mean"), leaf("t_w"),
             leaf("samp"), leaf("dls"), *acc), {"spk": leaf("spk")})


def _verdict(assert_fn, zeros, want_factors, broken):
    carry, outs = _chunk_trees(zeros, want_factors, broken)
    try:
        assert_fn(carry, outs, C=_C6, S=S, n_layers=_L,
                  want_factors=want_factors)
    except AssertionError as e:
        return str(e)
    return None


@pytest.mark.parametrize("want_factors,broken", _CARRY_CASES)
def test_chunk_carry_assert_matches_the_reference(want_factors, broken):
    """Both packages accept the separable trees and reject each broken leaf
    in turn, with the same message (the offending shape)."""
    port = _verdict(analysis.assert_chunk_carry_slot_separable,
                    lambda s: torch.zeros(s), want_factors, broken)
    ref = _verdict(janalysis.assert_chunk_carry_slot_separable,
                   lambda s: jnp.zeros(s), want_factors, broken)
    assert port == ref
    assert (port is None) == (broken is None)


def test_engine_assert_is_the_shared_one(monkeypatch):
    """engine._assert_slot_separable wraps the analysis module's assert:
    same AssertionError, same shape-bearing message, and a spy put in the
    analysis module's place is what the engine calls."""
    cfg = snn.SNNConfig(n_in=16, n_hidden=8, n_layers=2, n_out=4, t_steps=4)
    carry, outs = _chunk_trees(lambda s: torch.zeros(s), False, "spk")
    with pytest.raises(AssertionError) as ei:
        engine._assert_slot_separable(carry, outs, _C6, S, cfg, False)
    assert str((_C6, _N)) in str(ei.value)          # the offending shape

    seen = []
    monkeypatch.setattr(dc, "assert_chunk_carry_slot_separable",
                        lambda *a, **k: seen.append(k))
    engine._assert_slot_separable(carry, outs, _C6, S, cfg, False)
    assert seen == [dict(C=_C6, S=S, n_layers=2, want_factors=False)]


def test_scan_chunk_runs_the_assert_on_every_call(monkeypatch):
    cfg, args = _registry_chunk_args()
    seen = []
    real = dc.assert_chunk_carry_slot_separable

    def spy(carry, outs, **k):
        seen.append((len(carry), k["C"], k["S"], k["want_factors"]))
        real(carry, outs, **k)
    monkeypatch.setattr(dc, "assert_chunk_carry_slot_separable", spy)
    for want_factors in (True, False):
        make_chunk_fn(cfg, want_factors=want_factors)(*args)
    assert seen == [(8, registry._C, registry._S, True),
                    (6, registry._C, registry._S, False)]


def test_planted_slot_reduction_in_scan_chunk_fails(monkeypatch):
    """A scan_chunk that sums a carry leaf (ss_mean) over slots trips the
    assert on the CPU."""
    cfg, args = _registry_chunk_args()
    real = engine._stack_layers

    def planted(per_layer):
        out = real(per_layer)
        return out.sum(1) if out.dim() == 2 else out     # [L, S] -> [L]
    monkeypatch.setattr(engine, "_stack_layers", planted)
    with pytest.raises(AssertionError, match=r"\(2,\)"):
        make_chunk_fn(cfg)(*args)


def test_layer_arrays_are_built_once_and_shared():
    """The chunk step's per-layer fan-in and density come from a cache, so
    a step makes no host-to-device copy for them (the copy that built them
    on the card was a sync in dispatch); the values are the config's."""
    cfg = registry.snn_cfg()
    fan, dens = engine._layer_arrays(cfg, "cpu")
    again = engine._layer_arrays(cfg, torch.device("cpu"))
    assert again[0] is fan and again[1] is dens
    assert torch.equal(fan, torch.tensor([float(f) for f in cfg.layer_fanins]))
    assert torch.equal(dens, torch.tensor(
        [cfg.spec(f).density for f in cfg.layer_fanins]))


# --------------------------------------------------------- report / walkers

def test_report_formatting_and_walkers():
    def fn(xs):
        c = torch.zeros(())
        for x in xs:
            c = c + x
        return c

    r = analysis.check(fn, (torch.zeros((3,)),), [analysis.no_collectives()],
                       name="toy.loop")
    assert r.ok and "toy.loop" in str(r) and "OK" in str(r) and r.calls == 1

    trace = analysis.record(fn, (torch.zeros((3,)),))
    names = [op.name for op in analysis.iter_ops(trace)]
    assert "aten.add.Tensor" in names
    roles = {role for _, _, role in analysis.all_tensors(trace)}
    assert {"input", "op-in", "op-out", "output"} <= roles


# ------------------------------------------------------------ the registry

def _reference_entries():
    from repro.analysis import registry as jregistry

    out = {}
    for name in jregistry.names():
        _, _, contracts, _ = jregistry._REG[name]()
        out[name] = [c.name for c in contracts]
    return out


def test_registry_every_entrypoint_passes_on_cpu():
    """Every entry point passes its contract set on the CPU, under the
    reference's names and with its contract lists, the slot-sharded chunk
    step's among them."""
    reports = registry.check_all(device="cpu")
    assert set(reports) == set(registry.names())
    for name, r in reports.items():
        assert r.ok, f"{name}:\n{r}"
    assert {n: list(r.contracts) for n, r in reports.items()} == \
        _reference_entries()

    s = registry.summary(reports)
    assert s["ok"] and s["violations"] == 0
    assert s["contracts"] >= 20
    assert s["entrypoints"] == sorted(reports)


def test_registry_cli_lists_and_runs_on_cpu(capsys):
    assert registry.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == registry.names()
    assert registry.main(["--device", "cpu", "snn.run_chunk[dense]"]) == 0
    assert "PASS snn.run_chunk[dense]" in capsys.readouterr().out
