"""The paper's own network: (512)-512-512-16 SNN at 80 % N:M sparsity,
4 groups per fan-in, OSSL hidden layers + SL readout (core/snn.py)."""
from ..core.dsst import DSSTConfig
from ..core.gating import GatingConfig
from ..core.snn import SNNConfig

CONFIG = SNNConfig(
    n_in=512, n_hidden=512, n_layers=2, n_out=16,
    t_steps=50, sparsity=0.8,
    dsst=DSSTConfig(period=40, prune_frac=0.25),
    gating=GatingConfig(enabled=True),
)


def reduced(t_steps: int = 16) -> SNNConfig:
    import dataclasses
    return dataclasses.replace(CONFIG, n_in=64, n_hidden=64, n_out=4,
                               t_steps=t_steps,
                               dsst=DSSTConfig(period=8, prune_frac=0.25))
