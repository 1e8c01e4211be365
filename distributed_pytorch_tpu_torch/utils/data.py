"""Host-side datasets and the sharded batch loader.

A numpy copy of ``distributed_pytorch_tpu/utils/data.py``'s
:class:`ArrayDataset`, :class:`RandomDataset` and :class:`ShardedLoader`.
The batch streams are identical to the JAX loader's: the same
``default_rng([seed, epoch])`` shuffle, the same wrap-padded
``DistributedSampler``-style shards, the same final-batch rules and the same
mid-epoch resume point. Data stays in numpy on the host; the Trainer moves
each batch to the device. The C++-backed ``NativeShardedLoader`` and the
real datasets arrive with a later slice.
"""

from __future__ import annotations

import math
from typing import Iterator, Sequence, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]


class ArrayDataset:
    """Materialized dataset over caller-provided arrays (C-contiguous
    ``inputs``/``targets``)."""

    def __init__(self, inputs: np.ndarray, targets: np.ndarray):
        if len(inputs) != len(targets):
            raise ValueError(
                f"inputs ({len(inputs)}) and targets ({len(targets)}) disagree"
            )
        self.inputs = np.ascontiguousarray(inputs)
        self.targets = np.ascontiguousarray(targets)

    def __len__(self) -> int:
        return self.inputs.shape[0]

    def __getitem__(self, index: int) -> Batch:
        return self.inputs[index], self.targets[index]


class RandomDataset:
    """Lazy random dataset, deterministic per index: sample ``i`` is drawn
    from ``default_rng([seed, i])``. ``num_classes`` > 0 gives integer class
    targets, otherwise dense float32 targets of ``target_shape``."""

    def __init__(
        self,
        size: int,
        input_shape: Sequence[int],
        target_shape: Sequence[int] = (1000,),
        seed: int = 0,
        num_classes: int = 0,
    ):
        self.size = size
        self.input_shape = tuple(input_shape)
        self.target_shape = tuple(target_shape)
        self.seed = seed
        self.num_classes = num_classes

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Batch:
        if not 0 <= index < self.size:
            raise IndexError(index)
        rng = np.random.default_rng([self.seed, index])
        x = rng.standard_normal(self.input_shape).astype(np.float32)
        if self.num_classes:
            y = rng.integers(0, self.num_classes, size=(), dtype=np.int32)
            return x, np.asarray(y)
        y = rng.standard_normal(self.target_shape).astype(np.float32)
        return x, y


class ShardedLoader:
    """Batched, optionally shuffled, per-process-sharded iterator over a
    dataset, with ``DistributedSampler`` semantics:

    * the index list is padded by wrapping up to a multiple of
      ``num_shards``, so every shard has the same length;
    * shard ``i`` takes ``indices[i::num_shards]``;
    * ``set_epoch(e)`` reseeds the shuffle so every shard agrees on one
      global permutation per epoch.

    ``drop_last=True`` drops a ragged final batch; ``pad_final_batch=True``
    wraps it around to full ``batch_size`` instead.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        num_shards: int = 1,
        shard_index: int = 0,
        seed: int = 0,
        drop_last: bool = False,
        pad_final_batch: bool = False,
    ):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.seed = seed
        self.drop_last = drop_last
        self.pad_final_batch = pad_final_batch
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed shuffling for ``epoch``; forwarded to an epoch-aware
        dataset."""
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def shard_indices(self) -> np.ndarray:
        """The (padded, strided) global indices owned by this shard, this epoch."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng([self.seed, self._epoch]).permutation(n)
        else:
            order = np.arange(n)
        padded_total = math.ceil(n / self.num_shards) * self.num_shards
        if padded_total > n:
            order = np.concatenate([order, order[: padded_total - n]])
        return order[self.shard_index :: self.num_shards]

    def __len__(self) -> int:
        per_shard = math.ceil(len(self.dataset) / self.num_shards)
        if self.drop_last:
            return per_shard // self.batch_size
        return math.ceil(per_shard / self.batch_size)

    def batch_index_table(self) -> "list[np.ndarray]":
        """This epoch's batches as per-batch index rows (the final batch is
        wrap-padded to full size under ``pad_final_batch``, else it may be
        short)."""
        indices = self.shard_indices()
        rows = []
        for b in range(len(self)):
            chunk = indices[b * self.batch_size : (b + 1) * self.batch_size]
            if self.pad_final_batch and len(chunk) < self.batch_size:
                # np.resize repeats cyclically, so this wraps even when the
                # whole shard is smaller than one batch.
                chunk = np.concatenate(
                    [chunk, np.resize(indices, self.batch_size - len(chunk))]
                )
            rows.append(chunk)
        return rows

    def order_state(self) -> dict:
        """The parameters that fix this epoch's batch order: a mid-epoch
        snapshot records them, and a resumed loader that
        :meth:`matches_order_state` yields the identical sequence."""
        return {
            "seed": int(self.seed),
            "shuffle": bool(self.shuffle),
            "num_shards": int(self.num_shards),
            "batch_size": int(self.batch_size),
            "dataset_size": int(len(self.dataset)),
        }

    def matches_order_state(self, state) -> bool:
        return isinstance(state, dict) and state == self.order_state()

    def iter_batches(self, start_batch: int = 0) -> Iterator[Batch]:
        """This epoch's batches, skipping the first ``start_batch`` of them
        (mid-epoch resume: batches already in the restored state are not
        replayed)."""
        for chunk in self.batch_index_table()[start_batch:]:
            samples = [self.dataset[int(i)] for i in chunk]
            xs = np.stack([s[0] for s in samples])
            ys = np.stack([s[1] for s in samples])
            yield xs, ys

    def __iter__(self) -> Iterator[Batch]:
        return self.iter_batches()
