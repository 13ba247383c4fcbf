"""Dispatch-trace contract checker (``repro.analysis.jaxpr_contracts``).

The port's headline claims rest on structural properties of the hot path,
as the reference's do: the serving chunk step stays free of collectives
(what makes a slot-sharded fleet equal to one card), the compact layout
never materializes a dense ``[L, Kmax, N]`` mask or ``[S, L, Kmax, N]``
delta tensor, ``want_factors=False`` leaves the DSST factor accumulators
out of the chunk step, and every per-stream quantity keeps its slot axis.

Where the reference traces a jaxpr, the port records a run: :func:`check`
executes the target once under a recording ``TorchDispatchMode`` that
keeps every aten (or ``c10d``) op's name and the shape and dtype of its
tensor inputs and outputs, plus the result tree, and evaluates named
:class:`Contract` objects against that record. An eager run has no
trace-only mode, so the registry feeds the checks small inputs on the CPU
and full ones on the card. A hand-written kernel launched through
``ctypes`` or Triton is not an aten op, but every tensor it reads or writes
is allocated or viewed by one, so the shape contracts still see it.

The contract factories mirror the reference's one for one
(:func:`no_collectives`, :func:`slot_separable`, :func:`mask_free`,
:func:`no_dense_deltas`, :func:`no_factor_carries`,
:func:`dtype_discipline`, :func:`compile_count`). The engine's per-chunk
tree assert (:func:`assert_chunk_carry_slot_separable`) lives here too, so
the engine and the checker share one definition of slot separability, and
it hands each carry it sees to the checks running, which is how
:func:`no_factor_carries` counts the chunk step's carries.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

# Op namespaces of cross-process communication: ``dist.all_reduce`` and the
# other eager collectives dispatch as ``c10d.*`` ops, the traceable
# functional collectives as ``_c10d_functional*``. Any of them in the
# serving chunk step would make a slot-sharded fleet depend on the number
# of cards.
COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional",
                                   "_c10d_functional_autograd"})


# --------------------------------------------------------------------------
# the recorded run
# --------------------------------------------------------------------------

class OpRecord(NamedTuple):
    """One dispatched op: ``name`` as ``aten.mm.default``, its namespace,
    ``(shape, dtype)`` of every tensor among its inputs and its outputs, and
    the names and descriptions of any process group it was handed."""
    name: str
    namespace: str
    inputs: Tuple[Tuple[Tuple[int, ...], str], ...]
    outputs: Tuple[Tuple[Tuple[int, ...], str], ...]
    groups: Tuple[str, ...]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tensor_specs(tree) -> Tuple[Tuple[Tuple[int, ...], str], ...]:
    """``(shape, dtype)`` of every tensor in a tree of lists, tuples (named
    ones included), dicts and other registered pytree nodes (a slot-sharded
    tensor's shards), in order; a plain walk, since it runs on every
    dispatched op."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append((tuple(x.shape), _dtype_name(x.dtype)))
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif type(x) in pytree.SUPPORTED_NODES:
            kids, _ = pytree.SUPPORTED_NODES[type(x)].flatten_fn(x)
            stack.extend(reversed(kids))
    return tuple(out)


def _group_names(tree) -> Tuple[str, ...]:
    """Names and descriptions (``new_group(group_desc=...)``) of the process
    groups among an op's arguments; inside dispatch a group arrives boxed
    as a ``ScriptObject``."""
    out: List[str] = []
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, str):
            out.append(leaf)       # the functional collectives' group_name
        elif type(leaf).__name__ == "ScriptObject":
            try:
                pg = torch._C._distributed_c10d.ProcessGroup.unbox(leaf)
            except (AttributeError, RuntimeError, TypeError):
                continue
            out += [str(getattr(pg, a)) for a in ("group_name", "group_desc")
                    if getattr(pg, a, None)]
    return tuple(out)


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = getattr(func, "namespace", "")
        self.ops.append(OpRecord(
            str(func), ns, _tensor_specs((args, kwargs)), _tensor_specs(out),
            _group_names((args, kwargs)) if ns in COLLECTIVE_NAMESPACES
            else ()))
        return out


# every chunk-step carry handed to assert_chunk_carry_slot_separable while a
# check is recording: one list per running check
_CARRY_OBSERVERS: List[list] = []


class ChunkCarry(NamedTuple):
    """What the engine hook saw of one chunk step: its length ``C``, slot
    count ``S`` and the ``(shape, dtype)`` of every carry leaf."""
    C: int
    S: int
    leaves: Tuple[Tuple[Tuple[int, ...], str], ...]


@dataclasses.dataclass
class Trace:
    """One recorded run: its tensor inputs, every op, the result and the
    chunk-step carries the engine hook saw."""
    inputs: Tuple[Tuple[Tuple[int, ...], str], ...]
    ops: List[OpRecord]
    result: Any
    carries: List[ChunkCarry]


def record(fn, args: Sequence[Any] = (), kwargs: Optional[dict] = None
           ) -> Trace:
    """Run ``fn(*args, **kwargs)`` once under the recorder."""
    kwargs = dict(kwargs or {})
    rec, carries = _Recorder(), []
    _CARRY_OBSERVERS.append(carries)
    try:
        with rec:
            result = fn(*args, **kwargs)
    finally:
        _CARRY_OBSERVERS[:] = [o for o in _CARRY_OBSERVERS if o is not carries]
    return Trace(_tensor_specs((tuple(args), kwargs)), rec.ops, result,
                 carries)


def iter_ops(trace: Trace) -> Iterator[OpRecord]:
    """Every recorded op, in dispatch order (the ``iter_eqns`` of a run)."""
    yield from trace.ops


def all_tensors(trace: Trace) -> Iterator[Tuple[Tuple[int, ...], str, str]]:
    """``(shape, dtype, role)`` of every tensor the run touched: the
    target's inputs (``input``), each op's inputs and outputs (``op-in``,
    ``op-out``) and the result's leaves (``output``)."""
    for shape, dt in trace.inputs:
        yield shape, dt, "input"
    for op in trace.ops:
        for shape, dt in op.inputs:
            yield shape, dt, "op-in"
        for shape, dt in op.outputs:
            yield shape, dt, "op-out"
    for shape, dt in _tensor_specs(trace.result):
        yield shape, dt, "output"


# --------------------------------------------------------------------------
# report plumbing
# --------------------------------------------------------------------------

class ContractViolationError(AssertionError):
    """Raised by :meth:`Report.raise_if_violations`."""


@dataclasses.dataclass(frozen=True)
class Violation:
    contract: str
    message: str

    def __str__(self) -> str:
        return f"[{self.contract}] {self.message}"


@dataclasses.dataclass
class Report:
    """Outcome of :func:`check`: which contracts ran, what they found, and
    how many times the target ran (the recorded run plus
    :func:`compile_count`'s)."""
    target: str
    contracts: Tuple[str, ...]
    violations: List[Violation]
    calls: int = 1

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_if_violations(self) -> "Report":
        if self.violations:
            lines = "\n".join(f"  {v}" for v in self.violations)
            raise ContractViolationError(
                f"{self.target}: {len(self.violations)} contract "
                f"violation(s)\n{lines}")
        return self

    def __str__(self) -> str:
        status = ("OK" if self.ok
                  else f"{len(self.violations)} violation(s)")
        head = f"{self.target}: {status} ({', '.join(self.contracts)})"
        if self.ok:
            return head
        return head + "\n" + "\n".join(f"  {v}" for v in self.violations)


@dataclasses.dataclass(frozen=True)
class Contract:
    """A named check over a recorded run. ``run`` receives the :class:`_Ctx`
    and returns violations; an empty list means the contract holds."""
    name: str
    run: Callable[["_Ctx"], List[Violation]]


class _Ctx:
    """``(fn, args, kwargs)`` and its one recorded run, shared by the
    contracts of one ``check`` call; ``calls`` counts the target's runs."""

    def __init__(self, fn, args: tuple, kwargs: dict):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self._trace: Optional[Trace] = None
        self.calls = 0

    @property
    def trace(self) -> Trace:
        if self._trace is None:
            self._trace = record(self.fn, self.args, self.kwargs)
            self.calls += 1
        return self._trace

    def call(self):
        self.calls += 1
        return self.fn(*self.args, **self.kwargs)


def check(fn, args: Sequence[Any], contracts: Sequence[Contract], *,
          kwargs: Optional[dict] = None, name: Optional[str] = None) -> Report:
    """Verify ``contracts`` against one recorded run of ``fn`` on ``args``.

    Returns a :class:`Report`; ``.raise_if_violations()`` turns findings
    into a :class:`ContractViolationError`.
    """
    ctx = _Ctx(fn, tuple(args), dict(kwargs or {}))
    violations: List[Violation] = []
    for c in contracts:
        violations.extend(c.run(ctx))
    return Report(
        target=name or getattr(fn, "__name__", None) or repr(fn),
        contracts=tuple(c.name for c in contracts),
        violations=violations, calls=ctx.calls)


# --------------------------------------------------------------------------
# contract factories
# --------------------------------------------------------------------------

def no_collectives(axis: Optional[str] = None) -> Contract:
    """No op of a collective namespace anywhere in the run. With ``axis``
    given, only collectives over a process group of that name or
    description (``new_group(..., group_desc=axis)``) count, as the
    reference scopes its check to a named mesh axis."""
    def run(ctx: _Ctx) -> List[Violation]:
        out = []
        for op in iter_ops(ctx.trace):
            if op.namespace not in COLLECTIVE_NAMESPACES:
                continue
            if axis is not None and op.groups and axis not in op.groups:
                continue
            out.append(Violation(
                "no_collectives",
                f"collective `{op.name}` over groups {op.groups} — the "
                f"slot-sharded step must be communication-free"))
        return out
    return Contract("no_collectives", run)


def slot_separable(n_slots: int, *, exempt: Sequence[str] = ()) -> Contract:
    """Every result leaf keeps an axis of extent ``n_slots`` within its
    first two dims. ``exempt``: keystr substrings of deliberately
    slot-reduced results (the serving chunk fn's ``.pre_mag`` /
    ``.post_mag``, a decode cache's host ``pos``). ``None`` leaves are
    absent results, as in a JAX tree. Pick ``n_slots`` distinct from the
    other leading extents or the check passes vacuously."""
    def run(ctx: _Ctx) -> List[Violation]:
        out = []
        leaves, _ = pytree.tree_flatten_with_path(ctx.trace.result)
        for path, leaf in leaves:
            if leaf is None:
                continue
            key = pytree.keystr(path) or "<result>"
            if any(e in key for e in exempt):
                continue
            shape = tuple(getattr(leaf, "shape", ()))
            if n_slots not in shape[:2]:
                out.append(Violation(
                    "slot_separable",
                    f"output {key} shape {shape} lost the slot axis "
                    f"(extent {n_slots} not within the first two dims)"))
        return out
    return Contract("slot_separable", run)


def no_dense_leaves(shapes: Sequence[Sequence[int]], *,
                    dtypes: Sequence[str] = ("float32",),
                    contract_name: str = "no_dense_leaves") -> Contract:
    """No tensor of any forbidden ``(shape, dtype)`` anywhere in the run:
    not an input, not any op's input or output, not a result. (The
    reference also scans the printed jaxpr for what its walker might miss;
    a dispatch record has no such blind spot: every op is recorded.)"""
    forbidden = {tuple(int(d) for d in s) for s in shapes}
    want = tuple(dtypes)

    def run(ctx: _Ctx) -> List[Violation]:
        out, seen = [], set()
        for shape, dt, role in all_tensors(ctx.trace):
            if shape in forbidden and dt in want and (role, dt, shape) \
                    not in seen:
                seen.add((role, dt, shape))
                out.append(Violation(
                    contract_name,
                    f"{role} tensor {dt}{list(shape)} — dense layout "
                    f"leaked into the compact hot path"))
        return out
    return Contract(contract_name, run)


def mask_free(cfg) -> Contract:
    """Compact serving never materializes the dense connection mask
    ``[L, Kmax, N]`` (``cfg`` needs ``n_layers``, ``n_hidden`` and
    ``layer_fanins``)."""
    k_max = max(cfg.layer_fanins)
    return no_dense_leaves([(cfg.n_layers, k_max, cfg.n_hidden)],
                           contract_name="mask_free")


def no_dense_deltas(cfg, n_slots: int) -> Contract:
    """Compact serving never materializes the dense per-stream deltas,
    slot-leading ``[S, L, Kmax, N]`` (the public layout) or layer-leading
    ``[L, S, Kmax, N]`` (the engine's)."""
    k_max = max(cfg.layer_fanins)
    return no_dense_leaves(
        [(n_slots, cfg.n_layers, k_max, cfg.n_hidden),
         (cfg.n_layers, n_slots, k_max, cfg.n_hidden)],
        contract_name="no_dense_deltas")


def no_factor_carries(cfg, n_slots: int, *, chunk_len: Optional[int] = None,
                      max_state_carries: int = 4) -> Contract:
    """With ``want_factors=False`` the DSST ``pre_mag`` / ``post_mag``
    accumulators are absent from the chunk step, not zeroed.

    The port's chunk step is a Python loop, so its carry is what
    ``engine.scan_chunk`` hands the engine hook at the end of every chunk
    (recorded by :func:`assert_chunk_carry_slot_separable`). It legitimately
    holds ``max_state_carries`` ``[L, S, n_hidden]`` f32 tensors (the
    ``LayerState`` leaves v, tr, tr_pc, tr_cc); the accumulators would add
    a ``[L, S, k_max]`` and one more ``[L, S, n_hidden]``. Counting works
    where shapes cannot tell state from accumulator (``k_max ==
    n_hidden``), so a twin that computes the factors and multiplies them by
    zero is caught. ``chunk_len`` narrows the count to chunk steps of that
    length. A run in which no chunk step reached the hook fails: its
    carries could not be counted."""
    L, N = cfg.n_layers, cfg.n_hidden
    k_max = max(cfg.layer_fanins)
    allowed: Dict[Tuple[int, ...], int] = {(L, n_slots, N): max_state_carries}
    if k_max != N:
        allowed[(L, n_slots, k_max)] = 0

    def run(ctx: _Ctx) -> List[Violation]:
        carries = ctx.trace.carries
        if not carries:
            return [Violation(
                "no_factor_carries",
                "no chunk-step carry reached engine._assert_slot_separable "
                "— the target bypasses scan_chunk, so its carries cannot "
                "be counted")]
        out = []
        for carry in carries:
            if chunk_len is not None and carry.C != chunk_len:
                continue
            got = Counter(shape for shape, dt in carry.leaves
                          if dt == "float32")
            for shape, max_n in allowed.items():
                if got.get(shape, 0) > max_n:
                    out.append(Violation(
                        "no_factor_carries",
                        f"chunk step (C={carry.C}) carries {got[shape]} f32 "
                        f"tensors of shape {list(shape)} (expected <= "
                        f"{max_n} LayerState leaves) — the DSST factor "
                        f"accumulators were not left out"))
        return out
    return Contract("no_factor_carries", run)


def dtype_discipline(forbid: Sequence[str] = ("float64", "complex128")
                     ) -> Contract:
    """No wide dtype on any tensor of the run: an f64 means a host constant
    or a numpy array leaked through unconverted."""
    forbid = tuple(forbid)

    def run(ctx: _Ctx) -> List[Violation]:
        out, seen = [], set()
        for shape, dt, role in all_tensors(ctx.trace):
            if dt in forbid and (dt, shape) not in seen:
                seen.add((dt, shape))
                out.append(Violation(
                    "dtype_discipline",
                    f"{role} tensor {dt}{list(shape)} — silent wide-dtype "
                    f"promotion"))
        return out
    return Contract("dtype_discipline", run)


def compile_events() -> int:
    """What the port has compiled in this process, counted: chunk fns built
    (``serving.adapt.chunk_fns_built``), CUDA libraries built and loaded
    (``kernels._build.load_library``'s cache misses) and Triton
    specialisations of the LIF kernel. The registry's ``n_traces`` hook."""
    from ..kernels import _build
    from ..kernels.lif import kernel as lif_kernel
    from ..serving import adapt
    return (adapt.chunk_fns_built() + _build.load_library.cache_info().misses
            + lif_kernel.n_specializations())


def compile_count(max_traces: int = 1, runs: int = 2) -> Contract:
    """DYNAMIC contract: across ``runs`` more identical calls after the
    recorded one, the target's ``n_traces()`` counter (the registry binds
    :func:`compile_events`) grows by at most ``max_traces``. A target
    without a counter fails explicitly rather than passing vacuously."""
    def run(ctx: _Ctx) -> List[Violation]:
        counter = getattr(ctx.fn, "n_traces", None)
        if counter is None:
            return [Violation(
                "compile_count",
                "target exposes no n_traces() compile counter — cannot "
                "verify the single-compilation guarantee")]
        ctx.trace                     # the recorded run comes first
        before = counter()
        for _ in range(runs):
            ctx.call()
        grew = counter() - before
        if grew > max_traces:
            return [Violation(
                "compile_count",
                f"entrypoint compiled {grew}x across {runs} identical calls "
                f"(max {max_traces}) — it is retracing inside the hot "
                f"loop")]
        return []
    return Contract("compile_count", run)


# --------------------------------------------------------------------------
# the engine's per-chunk tree assert (shared definition)
# --------------------------------------------------------------------------

def assert_chunk_carry_slot_separable(carry, outs, *, C: int, S: int,
                                      n_layers: int,
                                      want_factors: bool) -> None:
    """The chunk step's slot-separability contract, checked on the carry
    ``(layers, x_tr, ss_mean, t_win, samp, deltas[, acc_pre, acc_post])``
    and the per-timestep outs at the end of every ``scan_chunk``: every
    per-stream quantity keeps its slot axis. A reduction over slots shows
    up as a dropped ``S`` dimension. Shapes only: no op, no device sync.
    ``engine._assert_slot_separable`` is a thin wrapper over this."""
    if _CARRY_OBSERVERS:
        seen = ChunkCarry(int(C), int(S), _tensor_specs(carry))
        for obs in _CARRY_OBSERVERS:
            obs.append(seen)
    layers, x_tr, ss_mean, t_w, samp, dls, *acc = carry
    for leaf in pytree.tree_leaves(layers):
        assert leaf.shape[:2] == (n_layers, S), tuple(leaf.shape)
    assert x_tr.shape[0] == S, tuple(x_tr.shape)
    assert ss_mean.shape == (n_layers, S), tuple(ss_mean.shape)
    assert t_w.shape == (S,) and samp.shape == (S,), (tuple(t_w.shape),
                                                      tuple(samp.shape))
    assert dls.shape[:2] == (n_layers, S), tuple(dls.shape)
    assert len(acc) == (2 if want_factors else 0), len(acc)
    for a in acc:
        assert a.shape[:2] == (n_layers, S), tuple(a.shape)
    for name, leaf in outs.items():
        assert leaf.shape[:2] == (C, S), (name, tuple(leaf.shape))
