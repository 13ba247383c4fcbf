"""Gated three-factor sparse weight update: the batch-summed ``wu_outer``
(CUDA kernel for the training path) and the per-slot ``wu_outer_slots``."""
