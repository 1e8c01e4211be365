"""The train step: forward, loss, backward, optimizer update.

The port of ``distributed_pytorch_tpu/training/train_step.py``'s
:class:`TrainState`, :func:`create_train_state` and :func:`make_train_step`
for one device. Where the JAX step is one pure jitted function over an
immutable state, here the module and the optimizer update their tensors in
place (``loss.backward()`` then ``optimizer.step()``), and
:class:`TrainState` holds them with the step counter: the checkpointable
unit, optimizer state included.

``grad_accum > 1`` splits the batch into that many equal microbatches,
sums their gradients and divides by ``grad_accum`` before the one
optimizer update, as the JAX step's scan does: the mean of the microbatch
means, at 1/``grad_accum`` of the activation memory. The step returns the
loss as a device tensor and never waits for the device. The eval steps,
loss scaling and dropout keys arrive with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the count of optimizer steps taken."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        """The snapshot tree: both state dicts and the step."""
        return {
            "model": self.module.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": int(self.step),
        }

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        self.module.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self.step = int(tree["step"])


def create_train_state(module: nn.Module, optimizer: torch.optim.Optimizer) -> TrainState:
    """A fresh state at step 0. The optimizer must update exactly the
    module's parameters, and those must be float32: flax keeps float32
    params and casts them per call, and an optimizer stepping bf16 weights
    would drift from it (build the model with ``param_dtype=torch.float32``)."""
    params = list(module.parameters())
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}
    if owned != {id(p) for p in params}:
        raise ValueError("the optimizer must be built over module.parameters()")
    low = sorted({str(p.dtype) for p in params if p.dtype != torch.float32})
    if low:
        raise ValueError(
            f"trainable parameters must be float32, found {low}; build the "
            f"model with param_dtype=torch.float32 and a lower compute dtype"
        )
    return TrainState(module=module, optimizer=optimizer, step=0)


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    grad_accum: int = 1,
) -> Callable[[TrainState, Tuple[torch.Tensor, torch.Tensor]], Tuple[TrainState, torch.Tensor]]:
    """Build ``step(state, (inputs, targets)) -> (state, loss)``: one
    optimizer update of ``model`` on the batch, which must already lie on
    the model's device. ``loss`` is a detached 0-d tensor on that device."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        if state.module is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than the step")
        inputs, targets = batch
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss = loss_fn(model(inputs), targets)
            loss.backward()
            loss = loss.detach()
        else:
            if inputs.shape[0] % grad_accum != 0:
                raise ValueError(
                    f"batch {inputs.shape[0]} not divisible by grad_accum {grad_accum}"
                )
            loss_sum = torch.zeros((), dtype=torch.float32, device=inputs.device)
            for mb_in, mb_tgt in zip(inputs.chunk(grad_accum), targets.chunk(grad_accum)):
                loss = loss_fn(model(mb_in), mb_tgt)
                loss.backward()  # .grad accumulates the sum over microbatches
                loss_sum = loss_sum + loss.detach()
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(grad_accum)
            loss = loss_sum / grad_accum
        optimizer.step()
        state.step += 1
        return state, loss

    return step
