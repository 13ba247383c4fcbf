"""Operations and bytes counted from a configuration's shapes (the
``port`` group of ``configs/<name>.json``: the sizes as run), never from
the program's parameter tree, so that a change of the program's layout
does not move the yardstick.

Model flops (``model_flops``): 2 flops a multiply-add, over the matmul
weights one token's forward touches (a MoE layer's ``top_k`` of its
experts, the router, the hybrid's shared block once a call, the head),
times 6 for a training step (forward, and backward's two products) or 2
for a forward pass, plus each attention call's score products (QKᵀ and
PV, 2·dh flops a visible pair and head each, times 3 for a training
step). Norms, the conv and the SSD's own products (f32 chunk math on the
CUDA cores) are left out. A prefill computes the head on the last
position only, and is counted so.

Flash bounds (``flash_bound_s``): the least time one call of
``kernels/flash_attn`` could take, the larger of its operations over the
bf16 peak and its bytes (each input read once, each output written once)
over the HBM bandwidth."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from .peaks import DTYPE_BYTES, HBM_BYTES_PER_S, PEAK_FLOPS

ATTN_FAMILIES = ("dense", "moe")


def causal_pairs(s: int, window: Optional[int] = None) -> int:
    """Visible (query, key) pairs of one head under the causal mask (and
    a sliding window of ``window`` keys)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def head_dim(p: Dict) -> int:
    return p.get("d_head") or p["d_model"] // p["n_heads"]


def attn_calls(p: Dict) -> int:
    """Attention calls in one forward pass."""
    if p["family"] in ATTN_FAMILIES:
        return p["n_layers"]
    if p["family"] == "hybrid":
        return p["n_layers"] // p["hybrid_attn_every"]
    return 0


def _attn_params(p: Dict) -> int:
    d, dh = p["d_model"], head_dim(p)
    return d * p["n_heads"] * dh * 2 + 2 * d * p["n_kv_heads"] * dh


def _ffn_params(p: Dict, width: int) -> int:
    return (3 if p.get("act", "swiglu") == "swiglu" else 2) * p["d_model"] * width


def block_matmul_params(p: Dict) -> int:
    """Matmul weights one token's forward touches in the blocks (all the
    layers, and the hybrid's shared block once a call)."""
    d, fam, n = p["d_model"], p["family"], p["n_layers"]
    if fam == "moe":
        per = (_attn_params(p) + d * p["moe_experts"]
               + p["moe_top_k"] * _ffn_params(p, p["d_ff"]))
        return n * per
    if fam == "dense":
        return n * (_attn_params(p) + _ffn_params(p, p["d_ff"]))
    di = p["ssm_expand"] * d
    heads = di // p["ssm_head_dim"]
    per = d * (2 * di + 2 * p["ssm_state"] + heads) + di * d
    total = n * per
    if fam == "hybrid":
        total += attn_calls(p) * (_attn_params(p) + _ffn_params(p, p["d_ff"]))
    return total


def head_params(p: Dict) -> int:
    return p["d_model"] * p["vocab"]


def active_matmul_params(p: Dict) -> int:
    return block_matmul_params(p) + head_params(p)


def score_flops(p: Dict, b: int, s: int) -> int:
    """One forward pass's attention score products, summed over calls."""
    pairs = causal_pairs(s, p.get("swa_window"))
    return 4 * head_dim(p) * pairs * b * p["n_heads"] * attn_calls(p)


def model_flops(p: Dict, b: int, s: int, kind: str) -> int:
    """Model flops of one training step (``kind`` "train") or one prefill
    of ``b`` prompts of ``s`` tokens (``kind`` "prefill")."""
    if kind == "train":
        return 6 * active_matmul_params(p) * b * s + 3 * score_flops(p, b, s)
    if kind == "prefill":
        return (2 * block_matmul_params(p) * b * s + 2 * head_params(p) * b
                + score_flops(p, b, s))
    raise ValueError(f"kind must be 'train' or 'prefill', got {kind!r}")


FLASH_KINDS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def flash_call(kind: str, b: int, s: int, h: int, kvh: int, dh: int,
               window: Optional[int] = None, dtype: str = "bfloat16"
               ) -> Tuple[int, int]:
    """(flops, bytes) that one causal call of a flash kernel needs: the
    forward (QKᵀ, PV), dK/dV (QKᵀ again, PᵀdO, dO·Vᵀ, dSᵀQ) or dQ (QKᵀ,
    dO·Vᵀ, dS·K); q, k, v, dO and the f32 row statistics read once, each
    output written once."""
    e = DTYPE_BYTES[dtype]
    pairs = causal_pairs(s, window)
    q = b * s * h * dh * e
    kv = b * s * kvh * dh * e
    row = b * h * s * 4
    per_pair = {"flash_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}[kind]
    flops = per_pair * dh * pairs * b * h
    if kind == "flash_fwd":
        nbytes = q + 2 * kv + q + row
    elif kind == "flash_bwd_dkv":
        nbytes = q + 2 * kv + q + 2 * row + 2 * kv
    else:
        nbytes = q + 2 * kv + q + 2 * row + q
    return flops, nbytes


def bound_s(flops: int, nbytes: int, dtype: str = "bfloat16") -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def flash_bound_s(kind: str, p: Dict, b: int, s: int) -> float:
    """The bound of one flash call of configuration ``p`` on ``b`` rows
    of ``s`` positions."""
    return bound_s(*flash_call(kind, b, s, p["n_heads"], p["n_kv_heads"],
                               head_dim(p), p.get("swa_window"),
                               p.get("dtype", "bfloat16")),
                   p.get("dtype", "bfloat16"))


def flash_kind(kernel_name: str) -> Optional[str]:
    """Which flash kernel a device kernel's name is, or None."""
    for k in ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd"):
        if k in kernel_name:
            return k
    return None
