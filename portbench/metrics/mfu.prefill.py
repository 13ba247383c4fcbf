"""The whole prefill step's share of the card's bf16 peak: the model flops
of the configuration's shapes (core/counts.model_flops) over the window."""
from portbench.core.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "prefill")
