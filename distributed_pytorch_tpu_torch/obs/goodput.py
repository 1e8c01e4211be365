"""Analytic FLOPs of a transformer LM step, for MFU.

A stdlib copy of the FLOPs model in ``distributed_pytorch_tpu/obs/goodput.py``
(:func:`causal_attention_flops`, :func:`transformer_train_flops`). The
goodput tracker itself arrives with the observability slice.
"""

from __future__ import annotations

from typing import Optional


def causal_attention_flops(
    *,
    n_layers: int,
    n_heads: int,
    head_dim: int,
    seq_len: int,
    batch: int,
    window: Optional[int] = None,
) -> float:
    """Forward FLOPs of the attention score+value matmuls, exact for the
    causal mask: query position i attends to ``min(i+1, window)`` keys.
    The factor 4 is 2 matmuls (QK^T and PV) x 2 FLOPs per MAC."""
    if window:
        w = int(window)
        if seq_len <= w:
            per_q = seq_len * (seq_len + 1) / 2
        else:
            per_q = w * (w + 1) / 2 + (seq_len - w) * w
    else:
        per_q = seq_len**2 / 2
    return n_layers * 4.0 * batch * n_heads * per_q * head_dim


def transformer_train_flops(
    *,
    n_params: int,
    embed_params: int,
    n_layers: int,
    n_heads: int,
    head_dim: int,
    seq_len: int,
    batch: int,
    window: Optional[int] = None,
) -> float:
    """Analytic FLOPs for one transformer LM training step: PaLM-style
    ``6 * non-embedding-params * tokens`` (2 per MAC, x3 for fwd+bwd) plus
    the exact causal attention term, also x3."""
    tokens = batch * seq_len
    attn_fwd = causal_attention_flops(
        n_layers=n_layers,
        n_heads=n_heads,
        head_dim=head_dim,
        seq_len=seq_len,
        batch=batch,
        window=window,
    )
    return 3.0 * (2.0 * (n_params - embed_params) * tokens + attn_fwd)
