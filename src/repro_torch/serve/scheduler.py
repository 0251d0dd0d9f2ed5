"""Scheduler registry, request lifecycle vocabulary and SLO statistics.

Counterpart of :mod:`repro.serve.scheduler` (framework-free Python and
numpy).  A scheduler turns an :class:`EngineView` into a :class:`StepPlan`:
which free slots refill from the queue with a whole prompt, and which live
slots decode one token.  The port ships ``fcfs``; the ``sjf``,
``token_budget`` and ``prefix_cache`` policies (and with them chunked
prefill and the PREFILLING state) and the analytic ``simulate`` replay
come later.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import numpy as np

QUEUED = "queued"          # admitted, waiting for a slot
DECODING = "decoding"      # holds a slot; emitting tokens
DONE = "done"              # finished normally (max_new reached)
CANCELLED = "cancelled"    # cancelled by the client; slot freed at next step


class Stamp(NamedTuple):
    """One lifecycle event in three clocks: wall seconds, engine steps and
    processed-position work units."""

    time: float
    step: int
    work: int


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """``refills``: ``(slot, request)`` — prefill a queued request's whole
    prompt into a free slot (all refills of a plan run as one microbatched
    prefill); ``decode``: slots that decode one token."""

    refills: tuple = ()
    decode: tuple = ()


@dataclasses.dataclass(frozen=True)
class EngineView:
    """Read-only engine snapshot handed to ``plan()``."""

    slots: int
    active: tuple
    queue: tuple

    def free_slots(self) -> tuple:
        return tuple(s for s in range(self.slots) if self.active[s] is None)


class Scheduler:
    """Base class / protocol for one admission+batching policy."""

    name: str = ""

    def admit(self, req, view: EngineView) -> None:
        """Admission hook; raise to reject."""

    def plan(self, view: EngineView) -> StepPlan:
        raise NotImplementedError

    def on_complete(self, req, view: EngineView) -> None:
        """Called once per request reaching DONE or CANCELLED."""

    def describe(self) -> str:
        return self.name


SCHEDULERS: dict[str, Callable[..., Scheduler]] = {}

SchedulerLike = Union[Scheduler, str, type, None]


def register_scheduler(factory: Callable[..., Scheduler]) -> Callable:
    name = getattr(factory, "name", "")
    if not name:
        raise ValueError("scheduler must set a non-empty .name")
    SCHEDULERS[name] = factory
    return factory


def schedulers() -> tuple[str, ...]:
    return tuple(SCHEDULERS)


def make_scheduler(spec: SchedulerLike) -> Scheduler:
    """An instance (as-is), a class, or a registered name."""
    if spec is None:
        spec = "fcfs"
    if isinstance(spec, Scheduler):
        return spec
    if isinstance(spec, type):
        return spec()
    if spec not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {spec!r}; registered: {schedulers()}")
    return SCHEDULERS[spec]()


class FCFSScheduler(Scheduler):
    """First-come-first-served whole-prompt refill: refill free slots from
    the queue head, then decode every live slot, including the slots
    refilled this step."""

    name = "fcfs"

    def plan(self, view: EngineView) -> StepPlan:
        refills = tuple(zip(view.free_slots(), view.queue))
        refilled = {slot for slot, _ in refills}
        decode = tuple(
            s for s in range(view.slots)
            if s in refilled
            or (view.active[s] is not None and view.active[s].state == DECODING)
        )
        return StepPlan(refills=refills, decode=decode)


register_scheduler(FCFSScheduler)


@dataclasses.dataclass(frozen=True)
class RequestStats:
    """Per-request SLO record in all three clocks."""

    uid: int
    state: str
    prompt_len: int
    new_tokens: int
    ttft_s: Optional[float] = None
    ttft_steps: Optional[int] = None
    ttft_work: Optional[int] = None
    tpot_s: Optional[float] = None
    e2e_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Aggregate serving statistics surfaced by ``ServeEngine.stats()``."""

    scheduler: str
    requests: tuple
    total_tokens: int
    wall_s: float
    work: int
    steps: int

    @property
    def tok_per_s(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)

    def percentile(self, field: str, q: float) -> Optional[float]:
        vals = [getattr(r, field) for r in self.requests if getattr(r, field) is not None]
        if not vals:
            return None
        return float(np.percentile(np.asarray(vals, np.float64), q))


def request_stats(req) -> RequestStats:
    arrival, first, finish = req.arrival, req.first_token, req.finished
    ttft_s = ttft_steps = ttft_work = tpot_s = e2e_s = None
    if first is not None and arrival is not None:
        ttft_s = first.time - arrival.time
        ttft_steps = first.step - arrival.step
        ttft_work = first.work - arrival.work
    if finish is not None and arrival is not None:
        e2e_s = finish.time - arrival.time
        if first is not None and len(req.out) > 1:
            tpot_s = (finish.time - first.time) / (len(req.out) - 1)
    return RequestStats(uid=req.uid, state=req.state, prompt_len=req.prompt_len,
                        new_tokens=len(req.out), ttft_s=ttft_s, ttft_steps=ttft_steps,
                        ttft_work=ttft_work, tpot_s=tpot_s, e2e_s=e2e_s)
