"""Serving engine: scheduler-driven continuous batching over resident weights.

Counterpart of :mod:`repro.serve.engine` with contiguous ring caches.
Weights are converted once (``convert_params``) to the residency policy
``mode`` and stay on the device; every prefill and decode step then runs
through each layer's format — the hand-written kernels on a CUDA device,
their plain versions on the CPU, or the plain PyTorch path everywhere with
``impl="plain"``.  Each ``step()`` is ``scheduler.plan(view)`` followed by
one microbatched prefill for all refills (left-padded, negative positions
masked) and one decode call for every live slot.

Requests walk ``QUEUED → DECODING → DONE | CANCELLED`` and
carry three-clock stamps (wall seconds, engine steps, processed
positions) from which :meth:`ServeEngine.stats` derives TTFT and TPOT.
Each step ends by copying its logits to the host, so the wall clock
covers the device work.

Not ported yet: paging and prefix sharing, chunking schedulers (and
their PREFILLING state), the observability spans.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import kvcache, residency
from repro_torch.models import model as model_lib
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve.scheduler import (
    CANCELLED,
    DECODING,
    DONE,
    QUEUED,
    EngineStats,
    EngineView,
    Stamp,
    StepPlan,
)

#: parameter dict keys eligible for quantized residency
QUANTIZABLE_KEYS = ("wq", "wk", "wv", "wo", "w_in", "w_out")


def convert_params(params, cfg, spec, *, min_dim: int = 64):
    """One-time residency conversion (the amortized layout transform).

    ``spec`` is anything :meth:`ResidencySpec.parse` accepts.  The tree is
    walked with dot-joined paths (``layers.3.ffn.w_in``); 2-D float leaves
    under quantizable keys become the :class:`QuantLinearState` of the
    format the policy selects; everything else stays float.
    """
    spec = residency.ResidencySpec.parse(spec)
    if spec.is_trivial:
        return params

    def walk(tree, path):
        if isinstance(tree, dict):
            return {
                k: _convert_leaf(v, spec.mode_for(".".join(path + (k,))), min_dim)
                if k in QUANTIZABLE_KEYS else walk(v, path + (k,))
                for k, v in tree.items()
            }
        if isinstance(tree, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        return tree

    return walk(params, ())


def _convert_leaf(w, mode, min_dim):
    if residency.get_format(mode).keeps_float_params:
        return w
    if not isinstance(w, torch.Tensor) or w.ndim != 2 or min(w.shape) < min_dim:
        return w
    return residency.from_float(w.to(torch.float32), mode)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    if isinstance(tree, (torch.Tensor, residency.QuantLinearState)):
        return tree.to(device)
    return tree


def resident_bytes(params) -> int:
    """Device-resident weight bytes (payload + scales for quantized leaves)."""
    if isinstance(params, dict):
        return sum(resident_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(resident_bytes(v) for v in params)
    if isinstance(params, residency.QuantLinearState):
        return residency.resident_bytes(params)
    return params.numel() * params.element_size()


@dataclasses.dataclass(eq=False)  # identity equality: queue membership
class Request:
    """One serving request as a lifecycle object (see module docstring).
    ``force`` teacher-forces the emitted tokens."""

    uid: int
    prompt: np.ndarray  # [P] int32
    max_new: int = 0
    out: list = dataclasses.field(default_factory=list)
    force: Optional[np.ndarray] = None
    state: str = QUEUED
    arrival: Optional[Stamp] = None
    first_token: Optional[Stamp] = None
    finished: Optional[Stamp] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.state in (DONE, CANCELLED)

    def cancel(self) -> None:
        if self.state not in (DONE, CANCELLED):
            self.state = CANCELLED


class ServeEngine:
    """Greedy batched decoder over a fixed slot count (continuous batching).

    ``mode``: weight-residency policy (``"ffn=bsdp_fused,mixer=w8a16"``);
    ``cache_format``: decode-cache residency (``"int4_bp_fused"``);
    ``scheduler``: orchestration policy (``"fcfs"``); ``impl="plain"``
    serves through the plain PyTorch paths instead of the kernels;
    ``device`` defaults to ``"cuda"`` and raises when there is none.
    """

    def __init__(self, params, cfg, *, slots: int = 4, max_len: int = 256,
                 impl: Optional[str] = None, mode: residency.SpecLike = "bf16",
                 cache_format: Optional[str] = None,
                 scheduler: sched_lib.SchedulerLike = "fcfs", min_dim: int = 64,
                 trace_logits: bool = False, device=None):
        self.device = resolve_device(device)
        spec = residency.ResidencySpec.parse(mode)
        params = _tree_to(params, self.device)
        if not spec.is_trivial:
            params = convert_params(params, cfg, spec, min_dim=min_dim)
        if cache_format is not None:
            cfg = dataclasses.replace(cfg, cache_format=cache_format)
        self.params, self.cfg = params, cfg
        self.slots, self.max_len, self.impl = slots, max_len, impl
        self.mode = spec.describe()
        self.cache_format = kvcache.format_for(cfg).name
        self.scheduler = sched_lib.make_scheduler(scheduler)
        self.trace_logits = trace_logits
        #: when ``trace_logits``: [(kind, slots, np.ndarray logits)] in order
        self.logit_trace: list = []
        self.queue: list[Request] = []
        self.active: list[Optional[Request]] = [None] * slots
        self.requests: list[Request] = []
        self.caches = None
        self.pos = np.zeros(slots, np.int32)
        self.step_index = 0
        self.work = 0
        self.wall_s = 0.0
        self._total_tokens = 0

    # -- admission ------------------------------------------------------
    def submit(self, prompt, max_new: int = 0, *, force=None) -> Request:
        """Admit one request; uids count up from 0 in submission order."""
        req = Request(uid=len(self.requests), prompt=np.asarray(prompt), max_new=max_new,
                      force=None if force is None else np.asarray(force))
        self.scheduler.admit(req, self._view())
        req.arrival = self._stamp()
        self.queue.append(req)
        self.requests.append(req)
        return req

    # -- bookkeeping ----------------------------------------------------
    def _stamp(self) -> Stamp:
        return Stamp(time.perf_counter(), self.step_index, self.work)

    def _view(self) -> EngineView:
        return EngineView(slots=self.slots, active=tuple(self.active),
                          queue=tuple(self.queue))

    @staticmethod
    def _next_token(req: Request, logits_row: np.ndarray) -> int:
        i = len(req.out)
        if req.force is not None and i < len(req.force):
            return int(req.force[i])
        return int(np.argmax(logits_row))

    def _emit(self, req: Request, logits_row: np.ndarray) -> None:
        tok = self._next_token(req, logits_row)
        req.out.append(tok)
        self._total_tokens += 1
        if req.first_token is None:
            req.first_token = self._stamp()

    def _finish(self, req: Request, slot: Optional[int], state: str) -> None:
        req.state = state
        req.finished = self._stamp()
        if slot is not None:
            self.active[slot] = None
        self.scheduler.on_complete(req, self._view())

    def _sweep_terminal(self) -> None:
        for req in list(self.queue):
            if req.state in (CANCELLED, DONE):
                self.queue.remove(req)
                self._finish(req, None, req.state)
        for slot in range(self.slots):
            req = self.active[slot]
            if req is not None and req.state in (CANCELLED, DONE):
                self._finish(req, slot, req.state)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- execution ------------------------------------------------------
    def _prefill_slots(self, assignments: list) -> None:
        """ONE prefill call for every refill (left-padded, pads at negative
        positions), then the per-row caches are spliced into the slots and
        each request emits its first token."""
        lens = [req.prompt_len for _, req in assignments]
        s_max = max(lens)
        toks = np.zeros((len(assignments), s_max), np.int32)
        pos = np.zeros((len(assignments), s_max), np.int32)
        for i, (_, req) in enumerate(assignments):
            pad = s_max - req.prompt_len
            toks[i, pad:] = req.prompt
            pos[i] = np.arange(s_max, dtype=np.int32) - pad
        batch = {"tokens": self._tensor(toks).long()}
        if s_max != min(lens):
            batch["positions"] = self._tensor(pos)
        logits, cache_b = model_lib.prefill(self.params, batch, self.cfg,
                                            max_len=self.max_len, impl=self.impl)
        self.work += toks.size
        if self.caches is None:
            self.caches = [
                {name: torch.zeros((self.slots, *t.shape[1:]), dtype=t.dtype,
                                   device=t.device)
                 for name, t in layer.items()}
                for layer in cache_b
            ]
        slot_ids = torch.tensor([slot for slot, _ in assignments], dtype=torch.long,
                                device=self.device)
        for full, rows in zip(self.caches, cache_b):
            for name, t in rows.items():
                full[name][slot_ids] = t
        last_logits = logits[:, -1].cpu().numpy()
        for i, (slot, req) in enumerate(assignments):
            self.active[slot] = req
            self.pos[slot] = req.prompt_len
            req.state = DECODING
            if self.trace_logits:
                self.logit_trace.append(("prefill", (slot,), last_logits[i]))
            self._emit(req, last_logits[i])

    def _decode(self, decode_slots) -> list:
        """One decode call for every slot (idle slots ride along at a pad
        position); returns the ``(request, slot)`` pairs that finished."""
        toks = np.zeros((self.slots, 1), np.int32)
        pos = np.full((self.slots, 1), -1, np.int32)
        for slot in decode_slots:
            toks[slot, 0] = self.active[slot].out[-1]
            pos[slot, 0] = self.pos[slot]
        logits, self.caches = model_lib.decode_step(
            self.params, self._tensor(toks).long(), self.caches, self._tensor(pos),
            self.cfg, impl=self.impl)
        self.work += toks.size
        step_logits = logits[:, -1].cpu().numpy()
        if self.trace_logits:
            self.logit_trace.append(
                ("decode", tuple(decode_slots), step_logits[list(decode_slots)]))
        finished = []
        for slot in decode_slots:
            req = self.active[slot]
            self._emit(req, step_logits[slot])
            self.pos[slot] += 1
            if len(req.out) >= req.max_new:
                finished.append((req, slot))
        return finished

    def _execute(self, plan: StepPlan) -> bool:
        for slot, req in plan.refills:
            if self.active[slot] is not None:
                raise ValueError(f"plan refills occupied slot {slot}")
            if req not in self.queue:
                raise ValueError(f"plan refills unqueued request {req.uid}")
            self.queue.remove(req)
        if plan.refills:
            self._prefill_slots(list(plan.refills))
        decode_slots = tuple(
            s for s in plan.decode
            if self.active[s] is not None and self.active[s].state == DECODING
        )
        if decode_slots:
            for req, slot in self._decode(decode_slots):
                self._finish(req, slot, DONE)
        return bool(plan.refills or decode_slots)

    def step(self) -> bool:
        """One scheduler-planned step; False when no progress was possible."""
        t0 = time.perf_counter()
        self._sweep_terminal()
        progressed = self._execute(self.scheduler.plan(self._view()))
        self.step_index += 1
        self.wall_s += time.perf_counter() - t0
        return progressed

    def run(self):
        while self.step():
            pass

    # -- SLO surface ----------------------------------------------------
    def stats(self) -> EngineStats:
        return EngineStats(
            scheduler=self.scheduler.describe(),
            requests=tuple(sched_lib.request_stats(r) for r in self.requests),
            total_tokens=self._total_tokens, wall_s=self.wall_s, work=self.work,
            steps=self.step_index,
        )

