"""Dynamic structured sparse training settings (``repro.core.dsst``).

Only the config that ``SNNConfig`` carries is ported so far; the
prune/regrow epoch itself comes with the training path.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DSSTConfig:
    period: int = 100          # WU cycles between connectivity updates
    prune_frac: float = 0.3    # fraction of each group's n connections recycled
    start_step: int = 0        # no connectivity updates before this
    stop_step: int = 10**9     # freeze connectivity after this
    frac_decay: float = 1.0    # multiplicative decay of prune_frac per event
