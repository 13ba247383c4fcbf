"""The numbers that decide ``correct``, each against its limit.

Training: each step's loss as a relative gap to the reference's; the
norm of each leaf's first gradient and of each leaf's change over the
first steps as the gap between the program's norm and the reference's,
over the reference's norm of that leaf or of the median leaf, whichever
is larger, the worst leaf taken (``grad``, ``change``) and, for the
gradient, the leaves' 90th percentile too (``grad_p90``: a MoE's routers
read widest in sound runs, their bf16 top-k flipping at near-ties, while
a lower precision moves every leaf). A leaf whose reference gradient is
under a thousandth of the median leaf's moves under Adam by round-off
alone, and is left out of the change.

Prefill (``drivers/prefill.py``): for each served token of a sample of
the window's batches, the gap by which its reference logit lies below
the reference's best; the widest gap, and the mean and root mean square
of the gaps over the sample. A cell's settings say which it is held
to."""
from __future__ import annotations

import statistics
from typing import Dict, List

QUIET = 1e-3        # a leaf's gradient under this share of the median's


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              skip=()) -> List[float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger; smallest first."""
    names = [n for n in ref if n not in skip]
    floor = statistics.median(ref[n] for n in names)
    return sorted(abs(prog[n] - ref[n]) / max(ref[n], floor) for n in names)


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             skip=()) -> float:
    """The worst leaf's gap."""
    return leaf_gaps(prog, ref, skip)[-1]


def p90(gaps: List[float]) -> float:
    """The gap at the leaves' 90th percentile (sorted gaps; of 43 leaves
    the 5th widest)."""
    return gaps[min(len(gaps) - 1, int(0.9 * len(gaps)))]


def quiet_leaves(ref_grad: Dict[str, float]) -> List[str]:
    floor = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g < QUIET * floor]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    quiet = quiet_leaves(ref["grad_norm"])
    grad = leaf_gaps(prog["grad_norm"], ref["grad_norm"])
    return {"loss": loss_gap(prog["loss"], ref["loss"]),
            "grad": grad[-1], "grad_p90": p90(grad),
            "change": norm_gap(prog["change_norm"], ref["change_norm"],
                               skip=quiet)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} for every number that has a limit, and
    whether all are within them. A number that is not finite fails, and
    so does a cell with no limit at all."""
    checks = {}
    ok = bool(limits)
    for name, limit in limits.items():
        v = numbers.get(name)
        fine = v is not None and v == v and abs(v) != float("inf") \
            and v <= limit
        ok = ok and fine
        checks[name] = {"value": v, "limit": limit}
    return {"correct": ok, "checks": checks}
