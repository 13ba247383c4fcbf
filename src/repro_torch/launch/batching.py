"""Fixed-slot occupancy bookkeeping (``repro.launch.batching.SlotGrid``).

Host-only: the grid knows nothing about what lives in a slot. The stream
scheduler multiplexes stateful SNN sessions through it.
"""
from __future__ import annotations

from typing import Callable, Generic, List, Optional, TypeVar

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
