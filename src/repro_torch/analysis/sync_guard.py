"""The card-side counterpart of lint rule ``SYNC01``: run a scheduler's
stage-side phases with CUDA's sync debug mode set to raise.

``guard_syncs(sched)`` wraps ``_poll_sources``, ``_stage``, ``_admit``,
``_dispatch`` and ``_apply_autopilot`` of one ``StreamScheduler`` so each
runs under ``torch.cuda.set_sync_debug_mode("error")``: a device sync inside
(``.item()``, ``.cpu()``, a copy from pageable memory, a
``synchronize()``) raises ``RuntimeError``. Retire, whose fetch is the one
sanctioned wait, runs with the mode off, also where a guarded phase calls
it (the autopilot flushes before it resizes the pipelines). Each call
restores the mode it found.
"""
from __future__ import annotations

GUARDED_PHASES = ("_poll_sources", "_stage", "_admit", "_dispatch",
                  "_apply_autopilot")
UNGUARDED_PHASES = ("_retire",)


def guard_syncs(sched) -> None:
    """Wrap ``sched``'s phases in place (an instance's attributes: other
    schedulers are untouched)."""
    import torch

    def wrap(name, mode):
        orig = getattr(sched, name)

        def wrapped(*args, **kwargs):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(mode)
            try:
                return orig(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        setattr(sched, name, wrapped)
    for name in GUARDED_PHASES:
        wrap(name, "error")
    for name in UNGUARDED_PHASES:
        wrap(name, "default")
