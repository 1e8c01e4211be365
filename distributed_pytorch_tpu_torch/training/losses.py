"""Loss functions, the port of ``distributed_pytorch_tpu/training/losses.py``.

Both reduce to one mean over every element or position, as the JAX
functions (on optax) do; the per-sample twins for exact evaluation arrive
with the evaluation steps.
"""

import torch
import torch.nn.functional as F


def mse_loss(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the (global) batch."""
    return torch.mean(torch.square(predictions - targets))


def softmax_cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Cross entropy; integer targets -> sparse labels over the last axis of
    ``logits``, float targets -> soft labels of ``logits``' shape. The mean
    runs over every position (batch and any token axes)."""
    if targets.dtype.is_floating_point:
        per_example = -(targets * F.log_softmax(logits, dim=-1)).sum(dim=-1)
        return per_example.mean()
    return F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long()
    )
