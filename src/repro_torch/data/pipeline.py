"""Data pipeline: the deterministic synthetic LM stream and a device feed.

Counterpart of :mod:`repro.data.pipeline`.  :class:`SyntheticLM` is pure
numpy, so its batches are bit-identical to the reference's: Zipfian token
soup with a prefix span re-emitted later in each sequence (induction
structure), so that cross entropy has learnable headroom below the
unigram entropy.  :func:`shard_batch` gives a rank its rows of a host
batch by the ``batch`` rule (the reference places the global batch with a
``NamedSharding``; here each rank keeps the block of rows its coordinates
on the batch axes name, pod-major).  :func:`prefetch` is the reference's
double-buffered feed: a background thread (sharding each batch first,
over a mesh) pins host batches and copies them to the card on a side
stream, ``depth`` batches ahead of the train step.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.2
    repeat_frac: float = 0.3  # fraction of each sequence that is a repeated span


class SyntheticLM:
    """Deterministic synthetic next-token stream: ``batch(step)`` depends on
    ``(seed, step)`` only."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        probs = 1.0 / np.arange(1, cfg.vocab_size + 1) ** cfg.zipf_alpha
        self._probs = probs / probs.sum()

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        toks = rng.choice(
            cfg.vocab_size, size=(cfg.global_batch, cfg.seq_len + 1), p=self._probs
        ).astype(np.int32)
        span = max(2, int(cfg.seq_len * cfg.repeat_frac / 2))
        if 2 * span < cfg.seq_len:
            toks[:, span: 2 * span] = toks[:, :span]  # repeated span
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].copy(),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def shard_batch(batch: dict, mesh, rules) -> dict:
    """The rank's rows of a host (or device) batch: every leaf's dim 0 cut
    by ``spec_for(("batch", None, ...), rules)`` over ``mesh`` (a
    :class:`~repro_torch.distributed.mesh.MeshView` or a ``DeviceMesh``)."""
    from repro_torch.sharding import partitioning as P

    if hasattr(mesh, "mesh_dim_names"):
        sizes, coords = P.mesh_sizes(mesh), P.mesh_coords(mesh)
    else:
        sizes, coords = mesh.sizes, mesh.coords

    def rows(x):
        spec = P.spec_for(("batch",) + (None,) * (x.ndim - 1), rules)
        return x[P.shard_index(x.shape, spec, sizes, coords)]

    return {k: rows(v) for k, v in batch.items()}


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy) as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


_DONE = object()


def prefetch(it: Iterator[dict], device, depth: int = 2, *, mesh=None,
             rules=None) -> Iterator[dict]:
    """Batches of ``it`` on ``device``, ``depth`` ahead of the consumer; over
    ``mesh`` with ``rules``, each the rank's rows (:func:`shard_batch`).  On
    a CUDA device a background thread pins each host batch and copies it on
    a side stream; the consumer's stream waits for the copy before it may
    read the batch.  On the CPU the batches are only converted.  Closing
    the generator stops the thread."""
    device = torch.device(device)
    if mesh is not None:
        it = (shard_batch(b, mesh, rules) for b in it)
    if device.type != "cuda":
        for b in it:
            yield to_device(b, device)
        return
    stream = torch.cuda.Stream(device)
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for b in it:
                with torch.cuda.stream(stream):
                    out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                           .to(device, non_blocking=True) for k, v in b.items()}
                    ready = torch.cuda.Event()
                    ready.record(stream)
                while not stop.is_set():
                    try:
                        q.put((out, ready), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        finally:
            q.put(_DONE)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            out, ready = item
            torch.cuda.current_stream(device).wait_event(ready)
            for v in out.values():  # the consumer's stream now uses them
                v.record_stream(torch.cuda.current_stream(device))
            yield out
    finally:
        stop.set()
        while t.is_alive():  # unblock a worker waiting to put
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()
