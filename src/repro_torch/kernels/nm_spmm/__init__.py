"""Block-N:M sparse matmul: plain torch version, wrapper and CUDA kernel."""
