"""Dense attention, the plain version of the flash-attention kernels.

The port of ``distributed_pytorch_tpu/ops/attention.py`` as far as the
single-device training path runs it: :data:`NEG_INF` and
:func:`dot_product_attention`. Ring and Ulysses attention (the
sequence-parallel entry points) arrive with the parallelism slice.

Shapes follow the JAX package: ``[batch, seq, heads, head_dim]``.
"""

from __future__ import annotations

import torch

#: Masked-logit fill: finite, so a row whose every key is masked never
#: produces ``exp(-inf - -inf)``.
NEG_INF = -1e30


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int = 0,
) -> torch.Tensor:
    """Reference attention. ``q``: [B, Tq, H, D]; ``k``/``v``: [B, Tk, H, D].
    ``window > 0`` (causal only): position q sees keys in ``(q-window, q]``.

    Op for op the JAX function: scores in q's dtype, softmax in float32,
    the weights cast back to q's dtype before the weighted sum."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window requires causal=True")
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)[:, None]
        kv_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        ok = q_pos >= kv_pos
        if window:
            ok = ok & (q_pos - kv_pos < window)
        logits = torch.where(ok, logits, NEG_INF)
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)
