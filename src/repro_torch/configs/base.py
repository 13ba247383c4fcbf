"""Config schema for every architecture (``repro.configs.base``), field for field.

One ``ModelConfig`` describes any member of the assigned pool (dense / MoE /
SSM / hybrid / VLM / audio LM families) plus the paper's add-ons (block-N:M
sparsity via ``SparsityConfig``, OSSL local-update mode, gated optimizer
updates). The fields after ``tie_embeddings`` are the port's own (the JAX
package's schema has none of them): the ``mixed`` family's layer pattern,
Mamba2's groups of B and C and a head count apart from ``ssm_expand``, and
sigmoid routing with a shared expert; at their defaults every other family
computes what it computes without them. ``src/repro_torch/configs/<arch>.py`` files hold the exact published
numbers; ``configs.make_reduced`` shrinks any config to a CPU-smoke size of the same
family.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Block-N:M sparsity on the big projection matrices.

    ``targets``: which weight families are sparse ("mlp", "attn", "expert").
    ``mode``: "masked" (dense storage + mask — simple, CPU-friendly) or
    "compact" (values+indices storage — the paper's memory cut; what the
    dry-run/roofline sees).
    """
    n: int = 2
    m: int = 8
    block: int = 128
    targets: Tuple[str, ...] = ("mlp",)
    mode: str = "compact"

    @property
    def density(self) -> float:
        return self.n / self.m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio | mixed
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None   # defaults to d_model // n_heads
    act: str = "swiglu"            # swiglu | relu2 | gelu
    rope_theta: float = 1e4
    rope_mode: str = "rope"        # rope | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    swa_window: Optional[int] = None
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_shard_experts: bool = False   # True: EP (experts on model axis); False: TP inside experts
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # --- hybrid (Zamba2-style shared attention block) ---
    hybrid_attn_every: int = 0     # apply the shared attn block after every k-th layer
    # --- modality frontend stubs ---
    frontend: Optional[str] = None     # "vision_stub" | "audio_stub"
    frontend_dim: int = 0              # precomputed patch/frame embedding width
    # --- paper technique ---
    sparsity: Optional[SparsityConfig] = None
    # --- numerics / training ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    tie_embeddings: bool = False
    # --- the port's own fields ---
    layer_pattern: str = ""        # mixed: a layer's kind, M Mamba2 | E MoE | * attention
    ssm_groups: int = 1            # groups of B and C; head h reads group h // (H / G)
    ssm_n_heads: int = 0           # 0: d_inner // ssm_head_dim, d_inner = ssm_expand·d_model
    moe_scoring: str = "softmax"   # softmax | sigmoid (choice by score + bias)
    moe_route_scale: float = 1.0   # the renormalised gates' scale
    moe_shared_ff: int = 0         # a shared expert of this width (0: none)

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        if self.ssm_n_heads:
            return self.ssm_n_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_n_heads or self.d_inner // self.ssm_head_dim

    def kind_counts(self) -> Dict[str, int]:
        """Layers of each kind in ``layer_pattern`` (the mixed family):
        ``M`` Mamba2, ``E`` MoE, ``*`` attention."""
        return {k: self.layer_pattern.count(k) for k in "ME*"}

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode with O(1)-ish state at 500k context?"""
        return self.family in ("ssm", "hybrid") or self.swa_window is not None

    def with_sparsity(self, sp: SparsityConfig) -> "ModelConfig":
        return dataclasses.replace(self, sparsity=sp)

    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        d, dh = self.d_model, self.head_dim
        return d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
            + self.n_heads * dh * d                # qkvo

    def _expert_params(self) -> int:
        """The routed experts of one MoE layer."""
        ff = 3 if self.act == "swiglu" else 2
        return self.moe_experts * ff * self.d_model * self.d_ff

    def _moe_params(self) -> int:
        """Router (and its bias under sigmoid scoring), routed experts and
        the shared expert of one MoE layer."""
        d, e = self.d_model, self.moe_experts
        ff = 3 if self.act == "swiglu" else 2
        n = d * e + self._expert_params() + ff * d * self.moe_shared_ff
        return n + (e if self.moe_scoring == "sigmoid" else 0)

    def _mamba_params(self) -> int:
        d, di, h = self.d_model, self.d_inner, self.ssm_heads
        gn = self.ssm_groups * self.ssm_state
        # in_proj -> (z, x, B, C, dt), conv, A/D/dt_bias, norm, out_proj
        return (d * (2 * di + 2 * gn + h) + self.ssm_conv * (di + 2 * gn)
                + 3 * h + di + di * d)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d = self.d_model
        n = 0
        n += self.vocab * d                      # embed
        if not self.tie_embeddings:
            n += d * self.vocab                  # lm head
        if self.frontend:
            n += self.frontend_dim * d
        per_layer = 0
        if self.family in ("dense", "vlm", "audio", "moe"):
            per_layer += self._attn_params()
            per_layer += 2 * d                   # norms
            if self.family == "moe":
                per_layer += self._moe_params()
            else:
                ff = 3 if self.act == "swiglu" else 2
                per_layer += ff * d * self.d_ff
        elif self.family in ("ssm", "hybrid"):
            per_layer += self._mamba_params()
            per_layer += d                        # norm
        elif self.family == "mixed":
            c = self.kind_counts()
            per_layer += d                        # norm
            n += (c["M"] * self._mamba_params() + c["E"] * self._moe_params()
                  + c["*"] * self._attn_params())
        total = n + self.n_layers * per_layer
        if self.family == "hybrid" and self.hybrid_attn_every:
            total += self._attn_params() + 3 * d * self.d_ff + 2 * d
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts) — for 6·N_active·D."""
        if self.family not in ("moe", "mixed"):
            return self.param_count()
        full = self.param_count()
        e, k = self.moe_experts, self.moe_top_k
        n_moe = self.n_layers if self.family == "moe" \
            else self.kind_counts()["E"]
        expert_p = n_moe * self._expert_params()
        return int(full - expert_p + expert_p * k / e)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch × shape) cell runs; and the reason when it does not."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 512k dense KV decode is the "
                       "quadratic-memory case long_500k excludes")
    return True, ""
