"""PyTorch port of ``distributed_pytorch_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference this port is checked against;
the port imports torch, numpy and the standard library, never JAX, flax or
any module of the JAX package. Module names follow the JAX package's, so
``distributed_pytorch_tpu/x/y.py`` has its counterpart at
``distributed_pytorch_tpu_torch/x/y.py``.

Two paths are ported: the paged serving engine (``serving.InferenceEngine``
over ``models.transformer.TransformerLM``, whose single-token decode
attention is the hand-written CUDA kernel ``csrc/paged_attention.cu``) and
single-device training (``training.Trainer`` over the same model, whose
attention forward and backward are the hand-written CUDA kernels of
``csrc/flash_attention.cu``), with ``utils.data.ShardedLoader`` and the
checksummed snapshots of ``checkpoint``. Entry points run on CUDA unless
the caller passes ``device="cpu"``.
"""

from distributed_pytorch_tpu_torch.models.transformer import (
    TransformerLM,
    params_from_jax,
)
from distributed_pytorch_tpu_torch.serving import InferenceEngine, SamplingParams
from distributed_pytorch_tpu_torch.training import (
    Trainer,
    make_train_step,
    mse_loss,
    softmax_cross_entropy_loss,
)
from distributed_pytorch_tpu_torch.utils.data import ArrayDataset, ShardedLoader

__all__ = [
    "ArrayDataset",
    "InferenceEngine",
    "SamplingParams",
    "ShardedLoader",
    "Trainer",
    "TransformerLM",
    "make_train_step",
    "mse_loss",
    "params_from_jax",
    "softmax_cross_entropy_loss",
]
