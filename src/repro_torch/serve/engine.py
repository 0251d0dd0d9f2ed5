"""Serving engine: scheduler-driven continuous batching over resident weights.

Counterpart of :mod:`repro.serve.engine` with contiguous ring caches.
Weights are converted once (``convert_params``, or
``materialize_converted`` leaf by leaf as they are drawn) to the residency
policy ``mode`` and stay on the device; every prefill and decode step then runs
through each layer's format — the hand-written kernels on a CUDA device,
their plain versions on the CPU, or the plain PyTorch path everywhere with
``impl="plain"``.  Each ``step()`` is ``scheduler.plan(view)`` followed by
one microbatched prefill for all refills (left-padded, negative positions
masked) and one ``decode_step`` call for the chunk rows and decode rows
together (a chunking scheduler's later prompt chunks ride in the decode
call, right-aligned beside the one-token decode rows).

Requests walk ``QUEUED → PREFILLING → DECODING → DONE | CANCELLED``,
stream each token to ``on_token`` and carry three-clock stamps (wall
seconds, engine steps, processed positions) from which
:meth:`ServeEngine.stats` derives TTFT and TPOT.  Each step ends by
copying its logits to the host, so the wall clock covers the device work.

Attention (GQA, MLA or cross-attention) ignores pad tokens, so a config
whose every mixer is attention refills in one microbatch and may chunk its prompts; a Mamba
state would absorb pad tokens, so an SSM or hybrid config refills one
slot at a time and never chunks (the scheduler refills whole prompts), as
the reference does.  A MoE layer routes pad tokens like any other, and an
idle slot's Mamba state takes its pad token at every decode step until a
refill overwrites it, both as in the reference.

Not ported yet: paging and prefix sharing (and with them the
``prefix_cache`` scheduler), the observability spans.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

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
    PREFILLING,
    QUEUED,
    EngineStats,
    EngineView,
    Stamp,
    StepPlan,
)

#: parameter dict keys eligible for quantized residency (the reference's)
QUANTIZABLE_KEYS = (
    "wq", "wk", "wv", "wo",
    "w_in", "w_out", "w_uq", "w_dq", "w_dkv", "w_uk", "w_uv",
    "in_proj", "out_proj", "x_proj",
    "shared_w_in", "shared_w_out",
    "head",
)


def convert_params(params, cfg, spec, *, min_dim: int = 64):
    """One-time residency conversion (the amortized layout transform).

    ``spec`` is anything :meth:`ResidencySpec.parse` accepts.  The tree is
    walked with dot-joined paths (``layers.3.ffn.w_in``) and each leaf goes
    through :func:`leaf_converter`'s rule.
    """
    spec = residency.ResidencySpec.parse(spec)
    if spec.is_trivial:
        return params
    convert = leaf_converter(spec, min_dim)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        return convert(path, tree)

    return walk(params, ())


def materialize_converted(cfg, spec, *, seed: int = 0, device=None, min_dim: int = 64):
    """``convert_params(materialize(cfg, seed, device), cfg, spec)``, equal
    to it bit for bit, with each leaf converted as soon as it is drawn: the
    float tree is never held whole, so a model whose float weights do not
    fit the card beside their converted form (qwen1.5-32b) fits."""
    convert = leaf_converter(residency.ResidencySpec.parse(spec), min_dim)
    return model_lib.draw(cfg, seed, device, leaf=convert)


def leaf_converter(spec, min_dim: int):
    """The conversion rule of one leaf, ``convert(path, w)`` with ``path``
    the tuple of keys: a float tensor under a quantizable key whose last two
    axes are at least ``min_dim`` long becomes the :class:`QuantLinearState`
    of the format the policy selects for the dot-joined path (converted
    from float32, a block of columns at a time): a ``[K, N]`` weight one
    state, a stacked ``[E, K, N]`` expert weight one stacked state,
    converted an expert at a time.  Everything else stays as it is; a
    quantizable leaf of any other rank raises."""

    def convert(path, w):
        if not path or path[-1] not in QUANTIZABLE_KEYS:
            return w
        mode = spec.mode_for(".".join(path))
        if residency.get_format(mode).keeps_float_params or not isinstance(w, torch.Tensor):
            return w
        if w.ndim not in (2, 3):
            raise ValueError(f"{'.'.join(path)}: cannot convert a {w.ndim}-D weight "
                             f"{tuple(w.shape)} to {mode}")
        if min(w.shape[-2:]) < min_dim:
            return w
        return residency.from_float(w, mode, dtype=torch.float32)

    return convert


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

    ``Request(uid, prompt, max_new)`` works positionally; ``uid=None`` is
    assigned at ``submit``.  ``force`` teacher-forces the emitted tokens;
    ``on_token(req, tok)`` streams every emitted token; ``prefilled``
    counts the prompt tokens consumed (the whole prompt once DECODING).
    """

    uid: Optional[int] = None
    prompt: np.ndarray = None  # [P] int32
    max_new: int = 0
    out: list = dataclasses.field(default_factory=list)
    force: Optional[np.ndarray] = None
    state: str = QUEUED
    prefilled: int = 0
    on_token: Optional[Callable[["Request", int], None]] = None
    arrival: Optional[Stamp] = None
    first_token: Optional[Stamp] = None
    finished: Optional[Stamp] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        """Terminal state (DONE or CANCELLED)."""
        return self.state in (DONE, CANCELLED)

    @done.setter
    def done(self, value: bool) -> None:  # legacy writers stop a request
        if value:
            self.state = DONE

    def cancel(self) -> None:
        """Cancel; the engine frees the slot at its next step (a queued
        request is dropped before it ever takes a slot)."""
        if self.state not in (DONE, CANCELLED):
            self.state = CANCELLED


class ServeEngine:
    """Greedy batched decoder over a fixed slot count (continuous batching).

    ``mode``: weight-residency policy (``"ffn=bsdp_fused,mixer=w8a16"``);
    ``cache_format``: decode-cache residency (``"int4_bp_fused"``);
    ``scheduler``: anything :func:`~repro_torch.serve.scheduler.make_scheduler`
    takes (``"fcfs"``, ``"sjf"``, ``"token_budget:budget=16"``, a class or
    an instance); ``impl="plain"`` serves through the plain PyTorch paths
    instead of the kernels; ``clock`` stamps the wall-time clock;
    ``device`` defaults to ``"cuda"`` and raises when there is none.
    """

    def __init__(self, params, cfg, *, slots: int = 4, max_len: int = 256,
                 impl: Optional[str] = None, mode: residency.SpecLike = "bf16",
                 cache_format: Optional[str] = None,
                 scheduler: sched_lib.SchedulerLike = "fcfs", min_dim: int = 64,
                 trace_logits: bool = False,
                 clock: Callable[[], float] = time.perf_counter, device=None):
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
        #: when ``trace_logits``: [(kind, slots, np.ndarray logits)] in order;
        #: a chunked request's first-token logits also record as "prefill"
        self.logit_trace: list = []
        self.queue: list[Request] = []
        self.active: list[Optional[Request]] = [None] * slots
        self.requests: list[Request] = []
        self.caches = None
        self.pos = np.zeros(slots, np.int32)
        # left-padded microbatched refills and chunked prefill need layers
        # that ignore pad tokens: attention (self or cross) does, a Mamba
        # state does not
        self._pad_ok = all(cfg.mixer_kind(i) in ("attn", "attn_cross", "cross")
                           for i in range(cfg.n_layers))
        self._clock = clock
        self._next_uid = 0
        self._uids: set = set()
        self.step_index = 0
        self.work = 0
        self.wall_s = 0.0
        self._total_tokens = 0

    # -- admission ------------------------------------------------------
    def submit(self, prompt, max_new: int = 0, *, uid: Optional[int] = None,
               force=None, on_token: Optional[Callable] = None) -> Request:
        """Admit one request (a prompt, or a pre-built :class:`Request`).
        An omitted uid is assigned; a duplicate uid is rejected."""
        if isinstance(prompt, Request):
            req = prompt
        else:
            req = Request(uid=uid, prompt=np.asarray(prompt), max_new=max_new,
                          force=None if force is None else np.asarray(force),
                          on_token=on_token)
        if req.uid is None:
            while self._next_uid in self._uids:
                self._next_uid += 1
            req.uid = self._next_uid
        if req.uid in self._uids:
            raise ValueError(f"duplicate request uid {req.uid!r}")
        self.scheduler.admit(req, self._view())  # may raise: rejected
        self._uids.add(req.uid)
        self._next_uid = max(self._next_uid, req.uid) + 1
        req.state = QUEUED
        req.arrival = self._stamp()
        self.queue.append(req)
        self.requests.append(req)
        return req

    # -- bookkeeping ----------------------------------------------------
    def _stamp(self) -> Stamp:
        return Stamp(self._clock(), self.step_index, self.work)

    def _view(self) -> EngineView:
        return EngineView(slots=self.slots, active=tuple(self.active),
                          queue=tuple(self.queue), chunking_ok=self._pad_ok,
                          max_len=self.max_len, step_index=self.step_index)

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
        if req.on_token is not None:
            req.on_token(req, tok)

    def _finish(self, req: Request, slot: Optional[int], state: str) -> None:
        req.state = state
        req.finished = self._stamp()
        if slot is not None:
            self.active[slot] = None
        self.scheduler.on_complete(req, self._view())

    def _sweep_terminal(self) -> None:
        """Free the queue entries and slots of requests moved to a terminal
        state from outside the engine (``cancel()``, ``done = True``)."""
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
        """ONE prefill call for every refill ``(slot, request, n_tokens)``
        (left-padded, pads at negative positions), then the per-row caches
        are spliced into the slots.  A whole prompt emits its first token;
        a first chunk (``n_tokens`` short of the prompt) leaves the request
        PREFILLING and its logits are discarded."""
        lens = [n for _, _, n in assignments]
        s_max = max(lens)
        toks = np.zeros((len(assignments), s_max), np.int32)
        pos = np.zeros((len(assignments), s_max), np.int32)
        for i, (_, req, n) in enumerate(assignments):
            pad = s_max - n
            toks[i, pad:] = req.prompt[:n]
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
        slot_ids = torch.tensor([slot for slot, _, _ in assignments], dtype=torch.long,
                                device=self.device)
        for full, rows in zip(self.caches, cache_b):
            for name, t in rows.items():
                full[name][slot_ids] = t
        last_logits = logits[:, -1].cpu().numpy()
        for i, (slot, req, n) in enumerate(assignments):
            self.active[slot] = req
            self.pos[slot] = n
            req.prefilled = n
            if n == req.prompt_len:
                req.state = DECODING
                if self.trace_logits:
                    self.logit_trace.append(("prefill", (slot,), last_logits[i]))
                self._emit(req, last_logits[i])
            else:
                req.state = PREFILLING  # a chunk's logits are partial: discard

    def _chunk_decode(self, chunks, decode_slots) -> list:
        """One ``decode_step`` for this step's chunk rows and decode rows.

        Rows are right-aligned in a ``[slots, S]`` token block (``S`` the
        longest chunk, 1 without chunks): a chunk row carries its next
        prompt tokens at positions ``prefilled..prefilled+n``, a decode row
        its last token at ``pos[slot]``, and the rest are pads at -1.  A
        chunk that ends its prompt emits the request's first token from its
        last logits.  Returns the ``(request, slot)`` pairs that finished.
        """
        s_len = max([n for _, n in chunks], default=1)
        toks = np.zeros((self.slots, s_len), np.int32)
        pos = np.full((self.slots, s_len), -1, np.int32)
        for slot, n in chunks:
            a = self.active[slot].prefilled
            toks[slot, s_len - n:] = self.active[slot].prompt[a:a + n]
            pos[slot, s_len - n:] = np.arange(a, a + n, dtype=np.int32)
        for slot in decode_slots:
            toks[slot, -1] = self.active[slot].out[-1]
            pos[slot, -1] = self.pos[slot]
        logits, self.caches = model_lib.decode_step(
            self.params, self._tensor(toks).long(), self.caches, self._tensor(pos),
            self.cfg, impl=self.impl)
        self.work += toks.size
        step_logits = logits[:, -1].cpu().numpy()
        for slot, n in chunks:
            req = self.active[slot]
            req.prefilled += n
            self.pos[slot] = req.prefilled
            if req.prefilled >= req.prompt_len:
                req.state = DECODING  # the last chunk's logits are the first token's
                if self.trace_logits:
                    self.logit_trace.append(("prefill", (slot,), step_logits[slot]))
                self._emit(req, step_logits[slot])
        if decode_slots and self.trace_logits:
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
        """Run one validated :class:`StepPlan`; returns progress."""
        refills = []
        for slot, req, n in plan.refills:
            if self.active[slot] is not None:
                raise ValueError(f"plan refills occupied slot {slot}")
            if req not in self.queue:
                raise ValueError(f"plan refills unqueued request {req.uid}")
            self.queue.remove(req)
            refills.append((slot, req, min(n, req.prompt_len)))
        if refills:
            if self._pad_ok:
                self._prefill_slots(refills)
            else:  # a Mamba state cannot skip pad tokens: one refill a call
                for one in refills:
                    self._prefill_slots([one])
        chunks = [
            (slot, min(n, self.active[slot].prompt_len - self.active[slot].prefilled))
            for slot, n in plan.chunks
            if self.active[slot] is not None
            and self.active[slot].state == PREFILLING and n > 0
        ]
        decode_slots = tuple(
            s for s in plan.decode
            if self.active[s] is not None and self.active[s].state == DECODING
        )
        if chunks or decode_slots:
            for req, slot in self._chunk_decode(chunks, decode_slots):
                self._finish(req, slot, DONE)
        return bool(refills or chunks or decode_slots)

    def step(self) -> bool:
        """One scheduler-planned step; False when no progress was possible."""
        t0 = self._clock()
        self._sweep_terminal()
        progressed = self._execute(self.scheduler.plan(self._view()))
        self.step_index += 1
        self.wall_s += self._clock() - t0
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
