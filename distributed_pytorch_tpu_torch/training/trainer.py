"""The Trainer: epoch loop -> batch loop -> train step, plus snapshot I/O.

The port of ``distributed_pytorch_tpu/training/trainer.py`` for one device,
the counterpart of the reference tutorial's ``Trainer(model, train_data,
optimizer, save_every[, snapshot_path])``. The optimizer is a
``torch.optim.Optimizer`` over ``model.parameters()``, as in that tutorial.

Elasticity contract, as in the JAX Trainer: if a snapshot exists at
construction it is loaded (through the ``.prev``/quarantine fallback
chain) and :meth:`Trainer.train` resumes from ``epochs_run``, at the exact
batch when the snapshot was taken mid-epoch; snapshots hold the model's and
the optimizer's state and the step count, so a resumed run continues the
uninterrupted one. Batches go host -> pinned memory -> device without a
sync, and losses stay on the device until the epoch ends.

Left for later slices: meshes and partition specs, the profiler, async
saves, the replica-consistency check, keep-K checkpoints, the preemption
drain and heartbeat, and ``evaluate``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from distributed_pytorch_tpu_torch.checkpoint import (
    load_snapshot_with_fallback,
    save_checkpoint,
    save_snapshot,
)
from distributed_pytorch_tpu_torch.metrics import MetricLogger, ReservoirHistogram
from distributed_pytorch_tpu_torch.parallel.bootstrap import (
    is_main_process,
    process_index,
)
from distributed_pytorch_tpu_torch.training.losses import mse_loss
from distributed_pytorch_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_train_step,
)
from distributed_pytorch_tpu_torch.utils.data import ShardedLoader
from distributed_pytorch_tpu_torch.utils.platform import resolve_device


class Trainer:
    """Drives training of ``model`` over a :class:`ShardedLoader`.

    ``device`` is where the model and every batch live: CUDA unless the
    caller passes ``device="cpu"``. The model is moved there at
    construction; ``optimizer`` must already be built over its parameters
    (moving a module keeps its parameter objects)."""

    def __init__(
        self,
        model: nn.Module,
        train_data: ShardedLoader,
        optimizer: torch.optim.Optimizer,
        save_every: int,
        *,
        snapshot_path: Optional[str] = None,
        checkpoint_path: str = "checkpoint.npz",
        loss_fn: Callable = mse_loss,
        metrics: Optional[MetricLogger] = None,
        log_every: int = 0,
        grad_accum: int = 1,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.train_data = train_data
        self.optimizer = optimizer
        self.save_every = save_every
        self.snapshot_path = snapshot_path
        self.checkpoint_path = checkpoint_path
        self.loss_fn = loss_fn
        self.metrics = metrics or MetricLogger()
        # Per-batch host time (enqueue of the step, plus any wait the loop
        # already does) in a bounded reservoir; p50/p95 logged per epoch.
        self.step_times = ReservoirHistogram(1024)
        self.log_every = log_every
        self.grad_accum = grad_accum
        self.epochs_run = 0
        # Mid-epoch resume point, consumed by the first _run_epoch after a
        # resume: skip the first _resume_step batches of _resume_epoch and
        # seed the epoch-loss mean with the sums taken before the snapshot.
        self._resume_epoch = 0
        self._resume_step = 0
        self._resume_loss_sum = 0.0
        self._resume_loss_count = 0

        if grad_accum > 1:
            if train_data.batch_size % grad_accum != 0:
                raise ValueError(
                    f"batch_size {train_data.batch_size} is not divisible by "
                    f"grad_accum {grad_accum}"
                )
            if not train_data.drop_last and not train_data.pad_final_batch:
                # A ragged final batch would break the microbatch split.
                train_data.pad_final_batch = True

        self.state: TrainState = create_train_state(self.model, optimizer)
        if snapshot_path is not None:
            self._load_snapshot(snapshot_path)
        self.train_step = make_train_step(
            self.model, optimizer, loss_fn, grad_accum=grad_accum
        )

    # ---------------------------------------------------------------- persistence

    def _load_snapshot(self, path: str) -> None:
        loaded = load_snapshot_with_fallback(path)
        if loaded is None:
            return  # a first run, or every candidate was corrupt (warned)
        tree, meta, used = loaded
        self.state.load_state_dict(tree)
        self.epochs_run = int(meta.get("epochs_run", 0))
        # A mid-epoch snapshot: step_in_epoch batches of epoch epochs_run
        # are in the restored state. Resume at that batch only if the
        # loader reproduces the same batch order; otherwise replay the
        # epoch from batch 0 (re-applying a batch is safe for coverage,
        # skipping one is not).
        step = int(meta.get("step_in_epoch", 0))
        step_note = ""
        if step > 0:
            if self.train_data.matches_order_state(meta.get("order")):
                self._resume_epoch = self.epochs_run
                self._resume_step = step
                self._resume_loss_sum = float(meta.get("loss_sum", 0.0))
                self._resume_loss_count = int(meta.get("loss_count", 0))
                step_note = f", step {step}"
            elif is_main_process():
                print(
                    f"snapshot was taken at step {step} of epoch "
                    f"{self.epochs_run} under a different loader geometry; "
                    f"replaying the epoch from step 0",
                    flush=True,
                )
        if is_main_process():
            note = "" if used == path else f" (fell back to {used})"
            print(
                f"Resuming training from snapshot at Epoch {self.epochs_run}"
                f"{step_note}{note}",
                flush=True,
            )

    def _save_snapshot(self, epoch: int) -> None:
        save_snapshot(self.snapshot_path, self.state.state_dict(), epochs_run=epoch + 1)
        if is_main_process():
            print(
                f"Epoch {epoch} | Training snapshot saved at {self.snapshot_path}",
                flush=True,
            )

    def save_mid_epoch_snapshot(
        self, epoch: int, steps_done: int, loss_sum: float, loss_count: int
    ) -> None:
        """A step-granular snapshot inside ``epoch``: ``steps_done`` of its
        batches are in the state, and their losses sum to ``loss_sum``. A
        Trainer built on it resumes at batch ``steps_done`` and logs the
        whole epoch's mean."""
        extra = {
            "order": self.train_data.order_state(),
            "loss_sum": float(loss_sum),
            "loss_count": int(loss_count),
        }
        save_snapshot(
            self.snapshot_path, self.state.state_dict(), epochs_run=epoch,
            step_in_epoch=steps_done, extra_meta=extra,
        )

    def _save_checkpoint(self, epoch: int) -> None:
        save_checkpoint(
            self.checkpoint_path, {"model": self.model.state_dict()},
            metadata={"epoch": epoch, "epochs_run": epoch + 1},
        )
        if is_main_process():
            print(
                f"Epoch {epoch} | Training checkpoint saved at {self.checkpoint_path}",
                flush=True,
            )

    # ---------------------------------------------------------------- training

    def _put_batch(self, xs: np.ndarray, ys: np.ndarray):
        """Host numpy -> device, through pinned memory on a card so the copy
        does not block the host."""
        out = []
        for a in (xs, ys):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return tuple(out)

    def _run_epoch(self, epoch: int) -> float:
        """One pass over this process's shard. Returns the mean loss over
        the epoch (the only point where the loop waits for the device)."""
        self.train_data.set_epoch(epoch)
        n_batches = len(self.train_data)
        start = 0
        carry_sum, carry_count = 0.0, 0
        if self._resume_step and epoch == self._resume_epoch:
            start = self._resume_step
            carry_sum = self._resume_loss_sum
            carry_count = self._resume_loss_count
        self._resume_step = 0  # one-shot: later epochs start at batch 0
        if is_main_process():
            resume_note = f" (resuming at step {start})" if start else ""
            print(
                f"[proc{process_index()}] Epoch {epoch} | "
                f"Batchsize: {self.train_data.batch_size} | Steps: {n_batches}"
                f"{resume_note}",
                flush=True,
            )
        losses = []
        for i, (xs, ys) in enumerate(self.train_data.iter_batches(start), start=start):
            t0 = time.perf_counter()
            batch = self._put_batch(xs, ys)
            self.state, loss = self.train_step(self.state, batch)
            losses.append(loss)
            self.step_times.record(time.perf_counter() - t0)
            if self.log_every and (i + 1) % self.log_every == 0:
                self.metrics.log(self.state.step, loss=float(loss), epoch=epoch)
        total = carry_sum + (float(torch.stack(losses).double().sum()) if losses else 0.0)
        count = carry_count + len(losses)
        epoch_loss = total / count if count else 0.0
        self.metrics.log(
            self.state.step,
            epoch_loss=epoch_loss,
            epoch=epoch,
            step_time_s_p50=self.step_times.quantile(0.5),
            step_time_s_p95=self.step_times.quantile(0.95),
        )
        return epoch_loss

    def train(self, max_epochs: int) -> None:
        """Epoch loop with the snapshot/checkpoint cadence; resumes from
        ``epochs_run``."""
        try:
            for epoch in range(self.epochs_run, max_epochs):
                self._run_epoch(epoch)
                self.epochs_run = epoch + 1
                if self.save_every and (epoch + 1) % self.save_every == 0:
                    if self.snapshot_path is not None:
                        self._save_snapshot(epoch)
                    else:
                        self._save_checkpoint(epoch)
        finally:
            self.metrics.close()
