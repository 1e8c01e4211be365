"""Structured metrics: latency reservoirs and the training metric logger.

A copy of ``distributed_pytorch_tpu/metrics.py``: :class:`ReservoirHistogram`
and :class:`ReservoirGroup` (the serving engine's TTFT/TPOT and the
Trainer's step times) and :class:`MetricLogger` (one JSON line per report
from process 0). The port keeps its own copy rather than importing the JAX
package.
"""

from __future__ import annotations

import bisect
import json
import math
import random
import time
from typing import Dict, Optional

from distributed_pytorch_tpu_torch.parallel.bootstrap import is_main_process


class ReservoirHistogram:
    """Bounded-memory quantile estimator: uniform reservoir sampling
    (Vitter's algorithm R) over a stream of observations.

    Counters alone (the old metrics surface) cannot answer "what is p99
    TTFT?" without keeping every sample; a reservoir keeps a fixed
    ``capacity`` (default 1024) uniform subsample regardless of stream
    length, so quantiles stay O(capacity) memory and are exact until the
    reservoir first overflows. Deterministic for a given ``seed`` and record
    order — the serving tests rely on that.

    ``sum``/``count``/``min``/``max`` are exact over the WHOLE stream (they
    are running aggregates, not reservoir-derived)."""

    def __init__(self, capacity: int = 1024, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._rng = random.Random(seed)
        self._samples: list = []
        # Lazily-built sorted view, kept valid incrementally once a
        # quantile has been read: per-step SLO evaluation would otherwise
        # re-sort the full reservoir on every tick. None = not built.
        self._ordered: Optional[list] = None
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if len(self._samples) < self.capacity:
            self._samples.append(value)
            if self._ordered is not None:
                bisect.insort(self._ordered, value)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                old = self._samples[j]
                self._samples[j] = value
                if self._ordered is not None:
                    self._ordered.pop(bisect.bisect_left(self._ordered, old))
                    bisect.insort(self._ordered, value)

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile over the reservoir; NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if not self._samples:
            return math.nan
        if self._ordered is None:
            self._ordered = sorted(self._samples)
        ordered = self._ordered
        pos = q * (len(ordered) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(ordered) - 1)
        frac = pos - lo
        return ordered[lo] * (1.0 - frac) + ordered[hi] * frac

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def summary(self, prefix: str = "") -> Dict[str, float]:
        """``{count, mean, min, max, p50, p95, p99}``, optionally prefixed —
        ready to splat into :meth:`MetricLogger.log` or a JSON report."""
        if not self.count:
            return {f"{prefix}count": 0}
        return {
            f"{prefix}count": self.count,
            f"{prefix}mean": self.mean,
            f"{prefix}min": self.min,
            f"{prefix}max": self.max,
            f"{prefix}p50": self.quantile(0.50),
            f"{prefix}p95": self.quantile(0.95),
            f"{prefix}p99": self.quantile(0.99),
        }

    def state(self) -> Dict[str, object]:
        """JSON-serializable full state — exact aggregates plus the
        reservoir samples — the unit of cross-host aggregation: each host
        ships its state, one host folds them with :meth:`merge_state`."""
        return {
            "capacity": self.capacity,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "samples": list(self._samples),
        }

    def merge_state(self, state: Dict[str, object]) -> None:
        """Fold another reservoir's :meth:`state` into this one. Exact
        aggregates (count/sum/min/max) combine exactly; the merged
        reservoir is a weighted subsample of the union — each retained
        sample stands for ``stream_count / n_samples`` observations of its
        source stream, and when the pooled samples overflow ``capacity``
        they are downsampled without replacement by those weights
        (Efraimidis-Spirakis keys on this reservoir's own RNG, so merges
        stay deterministic per seed and merge order). Merging an empty
        state is a no-op; merging INTO an empty reservoir adopts the
        incoming samples."""
        n = int(state["count"])
        if n == 0:
            return
        my_count = self.count
        theirs = [float(v) for v in state["samples"]]
        self.count += n
        self.sum += float(state["sum"])
        self.min = min(self.min, float(state["min"]))
        self.max = max(self.max, float(state["max"]))
        pool = [
            (v, my_count / len(self._samples)) for v in self._samples
        ] + [(v, n / len(theirs)) for v in theirs]
        if len(pool) <= self.capacity:
            self._samples = [v for v, _ in pool]
        else:
            keyed = sorted(
                pool,
                key=lambda vw: self._rng.random() ** (1.0 / vw[1]),
                reverse=True,
            )
            self._samples = [v for v, _ in keyed[: self.capacity]]
        self._ordered = None


class ReservoirGroup:
    """A fixed family of labeled :class:`ReservoirHistogram` reservoirs
    sharing one capacity — per-source latency splits, e.g. TTFT for
    prefix-cache hits vs misses. Labels are declared up front so the
    summary surface is stable (an unseen label reports ``count: 0`` rather
    than vanishing); each label gets a distinct derived seed so the
    reservoirs stay deterministic yet uncorrelated."""

    def __init__(self, labels, capacity: int = 1024, seed: int = 0):
        labels = tuple(labels)
        if not labels:
            raise ValueError("ReservoirGroup needs at least one label")
        if len(set(labels)) != len(labels):
            raise ValueError(f"duplicate labels: {labels}")
        self._hists: Dict[str, ReservoirHistogram] = {
            label: ReservoirHistogram(capacity, seed=seed + i)
            for i, label in enumerate(labels)
        }

    @property
    def labels(self):
        return tuple(self._hists)

    def __getitem__(self, label: str) -> ReservoirHistogram:
        return self._hists[label]

    def record(self, label: str, value: float) -> None:
        try:
            hist = self._hists[label]
        except KeyError:
            raise KeyError(
                f"unknown label {label!r}; declared: {self.labels}"
            ) from None
        hist.record(value)

    def summary(self, prefix: str = "") -> Dict[str, float]:
        """Every label's summary merged flat: ``{prefix}{label}_p50`` etc."""
        out: Dict[str, float] = {}
        for label, hist in self._hists.items():
            out.update(hist.summary(f"{prefix}{label}_"))
        return out

    def state(self) -> Dict[str, Dict[str, object]]:
        """Per-label :meth:`ReservoirHistogram.state` — the group's
        cross-host aggregation unit."""
        return {label: hist.state() for label, hist in self._hists.items()}

    def merge_state(self, state: Dict[str, Dict[str, object]]) -> None:
        """Fold another group's :meth:`state` in, label by label. Labels
        are a fixed declared family, so an unknown incoming label is a
        schema mismatch and raises (same contract as :meth:`record`)."""
        for label, sub in state.items():
            if label not in self._hists:
                raise KeyError(
                    f"unknown label {label!r}; declared: {self.labels}"
                )
            self._hists[label].merge_state(sub)


class MetricLogger:
    """Process-0 metric emitter: one JSON line per report + optional TensorBoard."""

    def __init__(self, tensorboard_dir: Optional[str] = None):
        self._writer = None
        if tensorboard_dir and is_main_process():
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(tensorboard_dir)
            except ImportError:  # the TensorBoard backend is optional
                self._writer = None
        self._start = time.perf_counter()

    def log(self, step: int, **scalars: float) -> None:
        if not is_main_process():
            return
        record = {"step": int(step), "elapsed_s": round(time.perf_counter() - self._start, 3)}
        record.update({k: float(v) for k, v in scalars.items()})
        print(json.dumps(record), flush=True)
        if self._writer is not None:
            for key, value in scalars.items():
                self._writer.add_scalar(key, value, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
