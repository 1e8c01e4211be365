"""Checkpoints and elastic snapshots, atomic and checksummed.

The port of the snapshot half of ``distributed_pytorch_tpu/checkpoint.py``:
:func:`save_checkpoint` (atomic write, optional ``.prev`` rotation),
:func:`save_snapshot`/:func:`load_snapshot` (``epochs_run``,
``step_in_epoch`` and any extra resume context in the metadata),
:func:`quarantine` and :func:`load_snapshot_with_fallback`.

Format: one ``.npz`` holding every tensor of a nested tree (dicts, lists,
tuples, tensors and JSON scalars, e.g. a model's and an optimizer's
``state_dict``) keyed by its "/"-joined path, plus a JSON
metadata entry. Unlike the JAX format, which restores into a template
pytree, the metadata also records the tree's layout, so a file restores on
its own: a fresh optimizer has no state to serve as a template. bfloat16
tensors are stored as their int16 bit patterns.

Integrity: every save embeds a CRC of each array plus a CRC of that
manifest in the metadata; loads verify both and raise
:class:`SnapshotIntegrityError` on any mismatch, so a torn write or bit rot
is detected, never trained on. :func:`load_snapshot_with_fallback`
quarantines a candidate that fails to load as ``<path>.corrupt`` and falls
back to ``<path>.prev``. Writes happen on process 0 only.

``AsyncCheckpointer``, ``CheckpointManager`` (keep-K rotation) and Orbax
import/export arrive with a later slice.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from distributed_pytorch_tpu_torch.parallel.bootstrap import is_main_process

_META_KEY = "__checkpoint_meta__"
_INTEGRITY_KEY = "__integrity__"
_LAYOUT_KEY = "__layout__"
_CRC_ALGO = "crc32"


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


class SnapshotIntegrityError(RuntimeError):
    """A checkpoint failed checksum verification (torn write, truncation, or
    disk bit-rot). Callers with a fallback chain quarantine and move on."""


# ---------------------------------------------------------------- tree codec


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def _flatten(tree: Any, path: str, arrays: Dict[str, np.ndarray]) -> Any:
    """Move every tensor leaf of ``tree`` into ``arrays`` under its
    path; return the JSON layout that rebuilds the tree around them."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arrays[path] = t.numpy()
        return {"tensor": path, "dtype": str(tree.dtype).replace("torch.", "")}
    if isinstance(tree, dict):
        return {"dict": [[k, _flatten(v, _join(path, k), arrays)] for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        items = [_flatten(v, _join(path, i), arrays) for i, v in enumerate(tree)]
        return {"tuple" if isinstance(tree, tuple) else "list": items}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {path!r}")


def _unflatten(layout: Any, arrays) -> Any:
    if "tensor" in layout:
        t = torch.from_numpy(np.array(arrays[layout["tensor"]]))
        if layout["dtype"] == "bfloat16":
            return t.view(torch.bfloat16)
        return t
    if "dict" in layout:
        return {k: _unflatten(v, arrays) for k, v in layout["dict"]}
    if "list" in layout:
        return [_unflatten(v, arrays) for v in layout["list"]]
    if "tuple" in layout:
        return tuple(_unflatten(v, arrays) for v in layout["tuple"])
    return layout["value"]


# ---------------------------------------------------------------- atomic, checked I/O


def _atomic_write(path: str, write_fn, *, mode: str = "wb") -> None:
    """Atomic durable write: tmp file in the target dir + ``os.replace``.
    ``write_fn(file_object)`` produces the content."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _with_integrity(arrays: Dict[str, np.ndarray], meta: Dict) -> Dict[str, np.ndarray]:
    """The arrays plus a metadata entry carrying per-array checksums and a
    checksum of that manifest, so a corruption of the metadata is as
    detectable as one of the array bytes."""
    manifest = {
        key: _crc(np.ascontiguousarray(value).tobytes()) for key, value in arrays.items()
    }
    meta = dict(meta)
    meta[_INTEGRITY_KEY] = {
        "algo": _CRC_ALGO,
        "arrays": manifest,
        "manifest": _crc(json.dumps(manifest, sort_keys=True).encode("utf-8")),
    }
    out = dict(arrays)
    out[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    return out


def _verify_integrity(npz, meta: Dict, *, source: str) -> None:
    """Raise :class:`SnapshotIntegrityError` if any checksum recorded at
    save time no longer matches."""
    integ = meta.get(_INTEGRITY_KEY)
    if not integ or integ.get("algo") != _CRC_ALGO:
        return
    manifest = integ.get("arrays", {})
    if _crc(json.dumps(manifest, sort_keys=True).encode("utf-8")) != integ.get("manifest"):
        raise SnapshotIntegrityError(f"{source}: checksum manifest is corrupt")
    for key, expect in manifest.items():
        if key not in npz:
            raise SnapshotIntegrityError(
                f"{source}: array {key!r} listed in manifest is missing"
            )
        got = _crc(np.ascontiguousarray(npz[key]).tobytes())
        if got != expect:
            raise SnapshotIntegrityError(
                f"{source}: array {key!r} checksum mismatch "
                f"(expected {expect:#010x}, got {got:#010x}) - torn write "
                "or disk corruption"
            )


def _rotate_previous(path: str) -> None:
    """Keep the previous file as ``<path>.prev``."""
    if os.path.exists(path):
        os.replace(path, path + ".prev")


def quarantine(path: str) -> Optional[str]:
    """Move a corrupt checkpoint aside as ``<path>.corrupt`` (suffixing
    ``.1``, ``.2``, ... on collision) so it is never loaded again. Returns
    the new path, or None if the file was already gone."""
    if not os.path.exists(path):
        return None
    dest = path + ".corrupt"
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = f"{path}.corrupt.{n}"
    try:
        os.replace(path, dest)
    except OSError:
        return None
    return dest


def save_checkpoint(
    path: str,
    tree: Any,
    metadata: Optional[Dict] = None,
    *,
    keep_previous: bool = False,
) -> None:
    """Atomically write ``tree`` (+ JSON-able ``metadata``) to ``path``
    (.npz), on process 0 only. ``keep_previous`` rotates an existing file to
    ``<path>.prev`` first."""
    arrays: Dict[str, np.ndarray] = {}
    meta = dict(metadata or {})
    meta[_LAYOUT_KEY] = _flatten(tree, "", arrays)
    if _META_KEY in arrays:
        raise ValueError(f"reserved key {_META_KEY} present in tree")
    if not is_main_process():
        return
    if keep_previous:
        _rotate_previous(path)
    _atomic_write(path, lambda f: np.savez(f, **_with_integrity(arrays, meta)))


def load_checkpoint(path: str) -> Tuple[Any, Dict]:
    """Restore ``(tree, metadata)`` from ``path``: tensors come back on the
    CPU in their saved dtypes. Raises :class:`SnapshotIntegrityError` on a
    checksum mismatch."""
    with np.load(path) as data:
        meta = json.loads(bytes(data[_META_KEY].tobytes()).decode("utf-8"))
        _verify_integrity(data, meta, source=f"checkpoint {path}")
        tree = _unflatten(meta.pop(_LAYOUT_KEY), data)
    meta.pop(_INTEGRITY_KEY, None)
    return tree, meta


# ---------------------------------------------------------------- snapshots


def _snapshot_meta(epochs_run: int, step_in_epoch: int = 0, extra: Optional[Dict] = None) -> Dict:
    """The snapshot metadata schema. ``step_in_epoch`` > 0 marks a
    mid-epoch snapshot: ``epochs_run`` epochs are complete and
    ``step_in_epoch`` batches of epoch ``epochs_run`` are already applied."""
    meta = {"epochs_run": int(epochs_run), "step_in_epoch": int(step_in_epoch)}
    if extra:
        meta.update(extra)
    return meta


def save_snapshot(
    path: str,
    tree: Any,
    epochs_run: int,
    *,
    step_in_epoch: int = 0,
    extra_meta: Optional[Dict] = None,
) -> None:
    """Elastic-training snapshot: the full training state + a progress
    marker, rotating the previous snapshot to ``<path>.prev``."""
    save_checkpoint(
        path, tree, metadata=_snapshot_meta(epochs_run, step_in_epoch, extra_meta),
        keep_previous=True,
    )


def load_snapshot(path: str) -> Tuple[Any, Dict]:
    """Restore ``(tree, meta)``; ``meta`` carries at least ``epochs_run``
    and ``step_in_epoch``."""
    tree, meta = load_checkpoint(path)
    meta.setdefault("epochs_run", 0)
    meta.setdefault("step_in_epoch", 0)
    return tree, meta


def load_snapshot_with_fallback(path: str) -> Optional[Tuple[Any, Dict, str]]:
    """Self-healing resume: try ``path``, then ``<path>.prev``. A candidate
    that exists but fails to load (checksum mismatch, torn zip) is
    quarantined with a loud warning and the chain moves on. Returns
    ``(tree, meta, used_path)``, or None when no candidate exists (a first
    run) or every candidate was corrupt (the caller starts fresh)."""
    candidates = [c for c in (path, path + ".prev") if os.path.exists(c)]
    if not candidates:
        return None
    for cand in candidates:
        try:
            tree, meta = load_snapshot(cand)
            return tree, meta, cand
        except Exception as e:  # any unreadable file: quarantine, try the next
            dest = quarantine(cand)
            print(
                f"[checkpoint] snapshot {cand} failed to load "
                f"({type(e).__name__}: {e}); quarantined to {dest}",
                file=sys.stderr,
                flush=True,
            )
    print(
        f"[checkpoint] WARNING: no loadable snapshot for {path} - every "
        "candidate was corrupt and quarantined; training will start FRESH",
        file=sys.stderr,
        flush=True,
    )
    return None
