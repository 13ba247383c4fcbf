"""The share of the traced prefill window in which nothing ran on the card:
1 - (union of the device operations' intervals) / (the traced wall)."""
from portbench.core.readers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx, "prefill")
