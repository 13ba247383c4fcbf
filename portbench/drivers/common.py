"""What the entry kinds share: the family's reference and adapter, the
program's parameters from the seed, the device record and freeing the
program's state before the reference runs."""
from __future__ import annotations

import gc
import importlib
from typing import Callable, Dict

import torch

from ..adapters import common as adapt
from ..core.weights import draw


class Family:
    """The reference module, the adapter and the layout of one config."""

    def __init__(self, port: Dict):
        fam = port["family"]
        self.port = port
        self.model = importlib.import_module(f"portbench.reference.{fam}")
        self.adapter = importlib.import_module(f"portbench.adapters.{fam}")
        self.leaves = self.model.layout(port)
        self.by_name = {leaf.name: leaf for leaf in self.leaves}
        self.dtype = getattr(torch, port.get("dtype", "bfloat16"))

    def model_config(self):
        return self.adapter.model_config(self.port)

    def port_params(self, seed: int, device) -> Dict:
        return adapt.port_tree(self.adapter.MAP, self.leaves,
                               lambda leaf: draw(leaf, seed, device, self.dtype),
                               self.port["n_layers"], device)

    def view(self, tree: Dict, name: str) -> torch.Tensor:
        return adapt.view(tree, self.adapter.MAP, name)

    def getter(self, seed: int, device) -> Callable[[str], torch.Tensor]:
        """name -> the leaf drawn again from the seed, in the served type."""
        return lambda name: draw(self.by_name[name], seed, device, self.dtype)


class LayerCache:
    """A getter for the reference's forward pass: each leaf drawn from the
    seed and read in f32 once, the leaves of the layer before dropped when
    a new layer is read, the global ones kept."""

    def __init__(self, get: Callable[[str], torch.Tensor]):
        self.get, self.held, self.layer = get, {}, None

    def __call__(self, name: str) -> torch.Tensor:
        if name not in self.held:
            layer = name.split(".", 1)[0] if name[:1] == "l" and "." in name \
                else None
            if layer is not None and layer != self.layer:
                self.held = {k: v for k, v in self.held.items()
                             if not (k[:1] == "l" and "." in k)}
                self.layer = layer
            self.held[name] = self.get(name).float()
        return self.held[name]


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_record(device, chips: int) -> Dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}

