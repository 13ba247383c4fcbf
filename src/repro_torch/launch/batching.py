"""Continuous batching for LM serving (``repro.launch.batching``).

``SlotGrid`` is the fixed-slot occupancy bookkeeping: admit queue,
occupancy, utilization. It knows nothing about what lives in a slot; the
stream scheduler multiplexes stateful SNN sessions through it, and
``ContinuousBatcher`` token-decode requests:

* admit: a free slot is claimed, and the prompt is replayed token by token
  through decode steps into that slot's cache lane;
* step: one decode step advances every slot; empty slots are fed a pad
  token and their logits ignored;
* retire: EOS or ``max_new`` tokens frees the slot.

The cache position is global (one host int for the grid, as in the
reference): a request admitted into a reused slot starts at the grid's
position, above its previous occupant's K/V, which it still attends to
(for ssm and hybrid models it also starts from the occupant's SSM state
and conv window, as in the reference). So only requests admitted at step
0 equal their lone runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Generic, List, Optional, TypeVar

import torch

from ..configs.base import ModelConfig
from ..models import transformer as T
from ..obs.trace import NULL_TRACER

Item = TypeVar("Item")


class SlotGrid(Generic[Item]):
    """Fixed-slot occupancy bookkeeping: admit queue, occupancy, stats."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.occupant: List[Optional[Item]] = [None] * n_slots
        self.queue: List[Item] = []
        self.stats = {"steps": 0, "slot_busy": 0, "admitted": 0, "retired": 0}

    def submit(self, item: Item) -> None:
        self.queue.append(item)

    def free_slots(self) -> List[int]:
        return [i for i, o in enumerate(self.occupant) if o is None]

    def active_slots(self) -> List[int]:
        return [i for i, o in enumerate(self.occupant) if o is not None]

    def admit(self, on_admit: Optional[Callable[[int, Item], None]] = None):
        """Pop queued items into free slots; returns [(slot, item), ...]."""
        admitted = []
        for slot in self.free_slots():
            if not self.queue:
                break
            item = self.queue.pop(0)
            self.occupant[slot] = item
            self.stats["admitted"] += 1
            if on_admit is not None:
                on_admit(slot, item)
            admitted.append((slot, item))
        return admitted

    def retire(self, slot: int) -> Item:
        item = self.occupant[slot]
        self.occupant[slot] = None
        self.stats["retired"] += 1
        return item

    def tick(self) -> None:
        self.stats["steps"] += 1
        self.stats["slot_busy"] += len(self.active_slots())

    @property
    def drained(self) -> bool:
        return not self.queue and not self.active_slots()

    @property
    def utilization(self) -> float:
        denom = self.stats["steps"] * self.n_slots
        return self.stats["slot_busy"] / denom if denom else 0.0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Fixed-slot continuous batching over the one-token decode step.

    ``tracer`` (an ``obs.trace.Tracer``; the no-op ``NULL_TRACER`` by
    default) records ``batch.admit`` and ``batch.decode_step`` spans, the
    latter tagged with how many slots were prefilling and decoding. Spans
    wrap host phases only. The cache lives on ``device``; each step reads
    the next tokens back to the host once (the argmax of the logits), the
    feedback autoregressive decoding needs.
    """

    def __init__(self, params, cfg: ModelConfig, n_slots: int, max_seq: int,
                 eos_id: Optional[int] = None, tracer=None, device="cuda"):
        self.params, self.cfg = params, cfg
        self.n_slots, self.max_seq = n_slots, max_seq
        self.eos_id = eos_id
        self.tracer = tracer or NULL_TRACER
        self.device = torch.device(device)
        self.cache = T.init_cache(cfg, n_slots, max_seq, self.device)
        self.grid: SlotGrid[Request] = SlotGrid(n_slots)
        self.finished: List[Request] = []
        self.stats = {"tokens_out": 0}

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request) -> None:
        self.grid.submit(req)

    def _admit(self) -> None:
        """Slot-local prefill: admitted prompts are replayed through decode
        steps, in lock-step with the other slots (the position is global)."""
        with self.tracer.span("batch.admit",
                              grid_step=self.grid.stats["steps"] + 1) as sp:
            def on_admit(slot, req):
                req._fed = 0          # prompt tokens already fed
            sp.set(admitted=len(self.grid.admit(on_admit)))

    def _feed_tokens(self) -> List[int]:
        toks = [0] * self.n_slots
        for i, req in enumerate(self.grid.occupant):
            if req is None:
                continue
            if req._fed < len(req.prompt):
                toks[i] = req.prompt[req._fed]
            elif req.out:
                toks[i] = req.out[-1]
            else:
                toks[i] = req.prompt[-1]
        return toks

    def _maybe_retire(self, slot: int, req: Request) -> None:
        """Done/EOS check after every emitted token, the first one included
        (a ``max_new=1`` request emits exactly 1 token, and an EOS first
        token retires at once)."""
        if (len(req.out) >= req.max_new
                or (self.eos_id is not None and req.out[-1] == self.eos_id)):
            req.done = True
            self.finished.append(self.grid.retire(slot))

    @torch.no_grad()
    def step(self) -> None:
        """One global decode step across all slots."""
        self._admit()
        prefilling = sum(1 for r in self.grid.occupant
                         if r is not None and r._fed < len(r.prompt))
        decoding = len(self.grid.active_slots()) - prefilling
        with self.tracer.span("batch.decode_step",
                              grid_step=self.grid.stats["steps"] + 1,
                              prefill_slots=prefilling,
                              decode_slots=decoding):
            toks = torch.tensor(self._feed_tokens(), device=self.device)
            logits, self.cache = T.decode_step(self.params, self.cache, toks,
                                               self.cfg)
            # the one read-back per step, the decode loop's retire point;
            # lint: ok SYNC01 — autoregressive feedback is synchronous
            nxt = logits.argmax(-1).tolist()
        self.grid.tick()
        for i, req in enumerate(self.grid.occupant):
            if req is None:
                continue
            if req._fed < len(req.prompt):
                req._fed += 1     # still prefilling: logits discarded
                if req._fed == len(req.prompt):
                    req.out.append(nxt[i])   # first generated token
                    self.stats["tokens_out"] += 1
                    self._maybe_retire(i, req)
                continue
            req.out.append(nxt[i])
            self.stats["tokens_out"] += 1
            self._maybe_retire(i, req)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        while not self.grid.drained:
            self.step()
            if self.grid.stats["steps"] >= max_steps:
                break
        return self.finished

    @property
    def utilization(self) -> float:
        return self.grid.utilization
