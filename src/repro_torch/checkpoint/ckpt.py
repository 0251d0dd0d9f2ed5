"""Checkpoints in the reference's on-disk format.

Counterpart of :mod:`repro.checkpoint.ckpt`.  One directory per step::

    <dir>/step_000000042/
        manifest.json          # step, leaves (file, shape, dtype, crc), extra, paths
        leaf_00000.npy ...     # one file per leaf, bfloat16 as its uint16 bits

The leaves are a nested dict's, walked as JAX flattens a dict (keys
sorted, :func:`repro_torch.tree.flatten`), so the same state written by
either package gives the same files and CRCs.  The reference's manifest
carries its tree structure as a JAX ``treedef`` protobuf, which the port
cannot read; the port writes ``paths`` (each leaf's key path) beside it
instead, and reads a reference checkpoint given the key paths its tree
has (:func:`repro_torch.train.trainer.checkpoint_paths` rebuilds them from
a config).  Writes go to ``<step dir>.tmp`` and are published by a rename;
every leaf's CRC is verified on restore, and a mismatch raises.
:class:`AsyncCheckpointer` copies the tensors to the host synchronously
and writes in a background thread.

Leaves may be tensors (any device), numpy arrays or
:class:`repro_torch.convert.Stacked` groups (stacked as they are written,
so a layout from :func:`repro_torch.convert.reference_layout` is stored as
the reference's stacked leaves); :func:`restore`
returns CPU tensors (bfloat16 rebuilt from its bits, with no numpy
bfloat16 type needed).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.convert import Stacked

def _host(leaf) -> tuple[np.ndarray, str]:
    """(a host copy of the array as stored, its true dtype's name); a
    :class:`Stacked` leaf's pieces stacked on the host.  A copy, so that a
    background write never sees the in-place updates of a later step.
    bfloat16, which numpy cannot hold natively, is stored as its uint16
    bits, as the reference stores it."""
    if isinstance(leaf, Stacked):
        parts = [_host(p) for p in leaf]
        return np.stack([a for a, _ in parts]), parts[0][1]
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(leaf)
    if a.dtype.name == "bfloat16":  # numpy's ml_dtypes.bfloat16
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.astype(dtype, copy=False))


def _path(d: str, step: int) -> str:
    return os.path.join(d, f"step_{step:09d}")


def _snapshot(tree: Any) -> list[tuple[tuple, np.ndarray, str]]:
    """The tree's leaves on the host, in the reference's order: ``[(key path,
    stored array, dtype name), ...]``."""
    return [(path, *_host(leaf)) for path, leaf in tree_lib.flatten(tree)]


def _write(leaves, directory: str, step: int, extra: Optional[dict]) -> str:
    final = _path(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {},
                "paths": [list(path) for path, _, _ in leaves]}
    for i, (_, stored, dtype) in enumerate(leaves):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), stored)
        manifest["leaves"].append({"file": fname, "shape": list(stored.shape), "dtype": dtype,
                                   "crc": zlib.crc32(stored.tobytes())})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(tree: Any, directory: str, step: int, extra: Optional[dict] = None) -> str:
    """Synchronous checkpoint write (atomic publish by rename) → its path."""
    return _write(_snapshot(tree), directory, step, extra)


class AsyncCheckpointer:
    """Snapshot to the host synchronously, write to disk in the background;
    one write outstanding at a time.  A write's error is raised by the next
    :meth:`wait` (or :meth:`save`)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, tree, directory: str, step: int, extra=None):
        self.wait()
        leaves = _snapshot(tree)

        def _run():
            try:
                _write(leaves, directory, step, extra)
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return max(steps) if steps else None


def restore(directory: str, step: Optional[int] = None, *, paths=None,
            verify: bool = True) -> tuple[dict, dict]:
    """Load a checkpoint (the latest if ``step`` is None) → (nested dict of
    CPU tensors, extra metadata).  The key paths come from the manifest (a
    port checkpoint) or from ``paths`` (a reference checkpoint, whose
    structure the port cannot decode).  Raises on a CRC mismatch."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = _path(directory, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    keys = manifest.get("paths", paths)
    if keys is None:
        raise ValueError(f"{d}: a reference checkpoint; pass the key paths of its tree")
    if len(keys) != len(manifest["leaves"]):
        raise ValueError(f"{d}: {len(manifest['leaves'])} leaves, {len(keys)} key paths")
    items = []
    for path, meta in zip(keys, manifest["leaves"]):
        a = np.load(os.path.join(d, meta["file"]))
        if verify and zlib.crc32(a.tobytes()) != meta["crc"]:
            raise IOError(f"CRC mismatch in {meta['file']} @ step {step}")
        if list(a.shape) != meta["shape"]:
            raise IOError(f"{meta['file']} @ step {step}: shape {a.shape}, manifest "
                          f"{meta['shape']}")
        items.append((tuple(path), _tensor(a, meta["dtype"])))
    return tree_lib.unflatten(items), manifest.get("extra", {})
