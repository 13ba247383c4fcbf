"""Device time of kernels that are neither cuBLAS GEMMs nor the port's
flash kernels, per token of the traced train steps: the MoE dispatch, the
SSD and conv, norms and elementwise work, and AdamW's kernels."""
from portbench.core.readers import nongemm_us_per_token


def read(ctx):
    return nongemm_us_per_token(ctx, "train")
