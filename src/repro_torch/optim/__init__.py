"""Optimizers for LM training (``repro.optim``): AdamW and the ElfCore
gated / N:M-sparse update machinery."""
from .optimizer import AdamWConfig, adamw_init, adamw_update, cosine_schedule  # noqa: F401
from .sparse import SparseTrainState, gated_scale_tree, lm_dsst_event  # noqa: F401
