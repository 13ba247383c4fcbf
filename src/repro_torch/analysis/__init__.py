"""Static checks of the port (``repro.analysis``): a dispatch-trace
contract checker and a host-path lint.

* ``repro_torch.analysis.dispatch_contracts``: ``check(fn, args,
  contracts)`` runs a callable once under a recording ``TorchDispatchMode``
  and verifies named structural contracts on the ops it dispatched and the
  result it returned: ``no_collectives``, ``slot_separable``,
  ``mask_free``, ``no_dense_deltas``, ``no_factor_carries``,
  ``dtype_discipline``, ``compile_count``. Where the reference walks a
  jaxpr (``iter_eqns``, ``all_avals``), the port walks the recorded run
  (``iter_ops``, ``all_tensors``; ``record`` makes one).
* ``repro_torch.analysis.lint``: AST rules over the host path
  (``python -m repro_torch.analysis.lint``): hidden device syncs in hot
  phases, unbounded obs/telemetry containers, unlocked shared-state
  mutation, torch imports in host-only modules, untagged docs fences.

``repro_torch.analysis.registry`` binds contract sets to the real entry
points (the serving chunk fn in every layout and tier, the raw engine
chunk step, the LM decode step); import it explicitly: it pulls in the
serving stack, which this package root does not.
"""
from .dispatch_contracts import (COLLECTIVE_NAMESPACES, Contract,
                                 ContractViolationError, OpRecord, Report,
                                 Trace, Violation, all_tensors,
                                 assert_chunk_carry_slot_separable, check,
                                 compile_count, compile_events,
                                 dtype_discipline, iter_ops, mask_free,
                                 no_collectives, no_dense_deltas,
                                 no_dense_leaves, no_factor_carries, record,
                                 slot_separable)

_LINT_EXPORTS = ("RULES", "LintViolation", "lint_paths", "lint_source")


def __getattr__(name):
    # lint symbols resolve lazily so `python -m repro_torch.analysis.lint`
    # does not import the module twice (once via this package root, once as
    # __main__)
    if name in _LINT_EXPORTS:
        from . import lint as _lint
        return getattr(_lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "COLLECTIVE_NAMESPACES", "Contract", "ContractViolationError", "OpRecord",
    "Report", "Trace", "Violation", "all_tensors",
    "assert_chunk_carry_slot_separable", "check", "compile_count",
    "compile_events", "dtype_discipline", "iter_ops", "mask_free",
    "no_collectives", "no_dense_deltas", "no_dense_leaves",
    "no_factor_carries", "record", "slot_separable",
    "RULES", "LintViolation", "lint_paths", "lint_source",
]
