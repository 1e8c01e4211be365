"""Which process this is.

The part of ``distributed_pytorch_tpu/parallel/bootstrap.py`` that the
single-device trainer and the checkpoint writer need: :func:`process_index`
and :func:`is_main_process`. They read ``torch.distributed`` when a process
group is initialized and answer rank 0 otherwise. Starting a process group
(``setup_distributed``) and DDP arrive with the data-parallel slice.
"""

from __future__ import annotations

import torch.distributed as dist


def process_index() -> int:
    """This process's rank in the default process group, or 0 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    """True on process 0, the single writer of checkpoints and metrics."""
    return process_index() == 0
