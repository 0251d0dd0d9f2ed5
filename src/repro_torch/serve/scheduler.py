"""Scheduler registry, request lifecycle vocabulary, SLO statistics and the
analytic serving model.

Counterpart of :mod:`repro.serve.scheduler` (framework-free Python and
numpy).  A scheduler turns an :class:`EngineView` into a :class:`StepPlan`:
which free slots refill from the queue (and with how many prompt tokens),
which PREFILLING slots advance a chunk, and which live slots decode one
token.

``admit(req, view)``        admission hook (raise to reject)
``plan(view)``              :class:`EngineView` → :class:`StepPlan`
``on_complete(req, view)``  completion hook

Registered schedulers:

* ``fcfs``         — first-come-first-served whole-prompt refill.
* ``sjf``          — shortest-prompt-first refill ordering.
* ``token_budget`` — chunked prefill: each slot prefills at most
                     ``budget`` prompt tokens a step, and the chunks run
                     through the decode path beside the decode rows.
* ``prefix_cache`` — ``token_budget`` (budget 32) that asks the engine for
                     prefix sharing (``wants_prefix_cache``): under a
                     ``paged_*`` cache a request attaches the pages of a
                     registered prompt prefix and prefills the rest.

``make_scheduler`` takes a registered name, a CLI string with int kwargs
(``"token_budget:budget=16"``), a class or an instance.

The module also holds the lifecycle states (``QUEUED → PREFILLING →
DECODING → DONE | CANCELLED``), the :class:`EngineStats` SLO surface and
:func:`simulate`, the analytic replay of an arrival trace through a real
scheduler under a two-term cost model.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np

QUEUED = "queued"          # admitted, waiting for a slot
PREFILLING = "prefilling"  # holds a slot; prompt partially consumed (chunked)
DECODING = "decoding"      # holds a slot; emitting tokens
DONE = "done"              # finished normally (max_new reached)
CANCELLED = "cancelled"    # cancelled by the client; slot freed at next step

STATES = (QUEUED, PREFILLING, DECODING, DONE, CANCELLED)


class Stamp(NamedTuple):
    """One lifecycle event in three clocks: wall seconds, engine steps and
    processed-position work units (every padded batch position a model
    invocation runs counts one unit: the deterministic clock)."""

    time: float
    step: int
    work: int


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """One engine step, as a scheduler decides it.

    ``refills``: ``(slot, request, n_tokens)`` — place a queued request in
    a free slot and prefill its first ``n_tokens`` prompt tokens (all
    refills of a plan run as one microbatched prefill).  ``chunks``:
    ``(slot, n_tokens)`` — advance a PREFILLING slot by its next
    ``n_tokens`` prompt tokens through the decode path.  ``decode``: slots
    that decode one token.  Chunk rows and decode rows share one model
    invocation a step.
    """

    refills: tuple = ()
    chunks: tuple = ()
    decode: tuple = ()

    @property
    def is_empty(self) -> bool:
        return not (self.refills or self.chunks or self.decode)


@dataclasses.dataclass(frozen=True)
class EngineView:
    """Read-only engine snapshot handed to ``plan()``.  Schedulers read the
    requests' ``state``, ``prompt_len``, ``prefilled``, ``max_new`` and
    ``uid``; ``chunking_ok`` False makes chunking schedulers refill whole
    prompts."""

    slots: int
    active: tuple
    queue: tuple
    chunking_ok: bool = True
    max_len: int = 0
    step_index: int = 0
    #: ``PagePool.stats()`` under a paged cache format, None otherwise
    #: (schedulers may read it, never change it)
    pages: Optional[dict] = None

    def free_slots(self) -> tuple:
        return tuple(s for s in range(self.slots) if self.active[s] is None)


class Scheduler:
    """Base class / protocol for one admission and batching policy.  ``plan``
    must schedule some progress whenever work exists: the engine stops when
    a plan makes none."""

    name: str = ""

    def admit(self, req, view: EngineView) -> None:
        """Admission hook; raise to reject."""

    def plan(self, view: EngineView) -> StepPlan:
        raise NotImplementedError

    def on_complete(self, req, view: EngineView) -> None:
        """Called once per request reaching DONE or CANCELLED."""

    def describe(self) -> str:
        return self.name

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<Scheduler {self.describe()!r}>"


SCHEDULERS: dict[str, Callable[..., Scheduler]] = {}

SchedulerLike = Union[Scheduler, str, type, None]


def register_scheduler(factory: Callable[..., Scheduler]) -> Callable:
    """Register a scheduler class or factory under its ``name``."""
    name = getattr(factory, "name", "")
    if not name:
        raise ValueError("scheduler must set a non-empty .name")
    SCHEDULERS[name] = factory
    return factory


def schedulers() -> tuple[str, ...]:
    """Registered scheduler names, in registration order."""
    return tuple(SCHEDULERS)


def make_scheduler(spec: SchedulerLike) -> Scheduler:
    """An instance (as-is), a class (instantiated), a registered name, or a
    CLI string ``"name:key=val,..."`` with int-parsed values."""
    if spec is None:
        spec = "fcfs"
    if isinstance(spec, Scheduler):
        return spec
    if isinstance(spec, type):
        return spec()
    name, _, argstr = spec.partition(":")
    if name not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {name!r}; registered: {schedulers()}")
    kwargs = {}
    for entry in filter(None, (e.strip() for e in argstr.split(","))):
        key, _, val = entry.partition("=")
        if not val:
            raise ValueError(f"bad scheduler arg {entry!r}")
        kwargs[key] = int(val) if val.lstrip("-").isdigit() else val
    return SCHEDULERS[name](**kwargs)


def _decode_slots(view: EngineView, refills) -> tuple:
    """Every DECODING slot, and every slot refilled with its whole prompt."""
    return tuple(
        s for s in range(view.slots)
        if (view.active[s] is not None and view.active[s].state == DECODING)
        or any(slot == s and n == req.prompt_len for slot, req, n in refills)
    )


class FCFSScheduler(Scheduler):
    """First-come-first-served whole-prompt refill: refill free slots from
    the queue head, then decode every live slot, including the slots
    refilled this step."""

    name = "fcfs"

    def _ordered_queue(self, view: EngineView) -> list:
        return list(view.queue)

    def plan(self, view: EngineView) -> StepPlan:
        queue = self._ordered_queue(view)
        refills = tuple((slot, req, req.prompt_len)
                        for slot, req in zip(view.free_slots(), queue))
        return StepPlan(refills=refills, decode=_decode_slots(view, refills))


class SJFScheduler(FCFSScheduler):
    """Shortest-prompt-first refill ordering (stable on ties): a long prompt
    never pads every co-refilled short prompt up to its own length."""

    name = "sjf"

    def _ordered_queue(self, view: EngineView) -> list:
        return sorted(view.queue, key=lambda r: r.prompt_len)


class TokenBudgetScheduler(FCFSScheduler):
    """Chunked prefill: at most ``budget`` prompt tokens a slot a step.

    Long prompts advance in chunks through the decode path while the other
    slots keep decoding in the same model invocation, so the TTFT of
    co-scheduled requests is bounded by ``budget``, not by the longest
    queued prompt.  Falls back to whole-prompt fcfs when the view says the
    architecture cannot chunk.
    """

    name = "token_budget"

    def __init__(self, budget: int = 32):
        if budget < 1:
            raise ValueError("token_budget needs budget >= 1")
        self.budget = budget

    def describe(self) -> str:
        return f"{self.name}:budget={self.budget}"

    def plan(self, view: EngineView) -> StepPlan:
        if not view.chunking_ok:
            return super().plan(view)
        budget = min(self.budget, view.max_len) if view.max_len else self.budget
        chunks = tuple(
            (slot, min(budget, req.prompt_len - req.prefilled))
            for slot, req in enumerate(view.active)
            if req is not None and req.state == PREFILLING
        )
        refills = tuple((slot, req, min(budget, req.prompt_len))
                        for slot, req in zip(view.free_slots(), view.queue))
        return StepPlan(refills=refills, chunks=chunks,
                        decode=_decode_slots(view, refills))


class PrefixCacheScheduler(TokenBudgetScheduler):
    """Token-budget chunking plus prefix-cache admission.

    ``wants_prefix_cache`` asks the engine to attach a refilled request to
    the pages of the longest registered page-aligned prefix of its prompt
    (the attach is the engine's and the page pool's work): the request
    enters PREFILLING with ``prefilled`` at the matched length, so it must
    advance by chunks, which this planner gives it."""

    name = "prefix_cache"
    wants_prefix_cache = True


register_scheduler(FCFSScheduler)
register_scheduler(SJFScheduler)
register_scheduler(TokenBudgetScheduler)
register_scheduler(PrefixCacheScheduler)


@dataclasses.dataclass(frozen=True)
class RequestStats:
    """Per-request SLO record in all three clocks."""

    uid: int
    state: str
    prompt_len: int
    new_tokens: int
    ttft_s: Optional[float] = None     # arrival → first token, seconds
    ttft_steps: Optional[int] = None   # ... in engine steps
    ttft_work: Optional[int] = None    # ... in processed-position units
    tpot_s: Optional[float] = None     # mean seconds per token after the 1st
    e2e_s: Optional[float] = None      # arrival → finish, seconds


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Aggregate serving statistics surfaced by ``ServeEngine.stats()``."""

    scheduler: str
    requests: tuple  # RequestStats, submission order
    total_tokens: int
    wall_s: float
    work: int
    steps: int
    #: the final ``PagePool.stats()`` (paged cache formats only)
    pages: Optional[dict] = None

    @property
    def tok_per_s(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)

    def percentile(self, field: str, q: float) -> Optional[float]:
        """q-th percentile (0..100) of a RequestStats field over the
        requests that recorded it."""
        vals = [getattr(r, field) for r in self.requests if getattr(r, field) is not None]
        if not vals:
            return None
        return float(np.percentile(np.asarray(vals, np.float64), q))

    def summary(self) -> dict:
        return {
            "scheduler": self.scheduler,
            "requests": len(self.requests),
            "tokens": self.total_tokens,
            "tok_per_s": self.tok_per_s,
            "ttft_s_p50": self.percentile("ttft_s", 50),
            "ttft_s_p95": self.percentile("ttft_s", 95),
            "ttft_work_p50": self.percentile("ttft_work", 50),
            "ttft_work_p95": self.percentile("ttft_work", 95),
            "tpot_s_p50": self.percentile("tpot_s", 50),
        }


def request_stats(req) -> RequestStats:
    """One :class:`RequestStats` from a request's lifecycle stamps."""
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


@dataclasses.dataclass(eq=False)  # identity equality: queue membership
class _SimRequest:
    """Duck-typed request for :func:`simulate`: the lifecycle surface that
    schedulers read."""

    uid: int
    prompt_len: int
    max_new: int
    arrival_s: float
    state: str = QUEUED
    prefilled: int = 0
    out: list = dataclasses.field(default_factory=list)
    arrival: Optional[Stamp] = None
    first_token: Optional[Stamp] = None
    finished: Optional[Stamp] = None


def simulate(scheduler: SchedulerLike, trace: Sequence[tuple], *, slots: int,
             t_call: float, t_token: float, max_len: int = 0, chunking_ok: bool = True,
             max_steps: int = 100_000) -> EngineStats:
    """Analytic replay of an arrival trace through a real scheduler.

    The same ``plan()`` objects the engine runs, executed against a cost
    model instead of a model: every model invocation costs ``t_call`` plus
    ``t_token`` per processed batch position (padded positions count, as in
    the real microbatched prefill).  ``trace`` rows are ``(arrival_s,
    prompt_len, max_new)``.  The result's ``wall_s`` and ``ttft_s`` are in
    simulated seconds; its ``work`` counts processed positions, the clock
    the engine records.
    """
    scheduler = make_scheduler(scheduler)
    pending = sorted(
        (_SimRequest(uid=i, prompt_len=int(p), max_new=int(m), arrival_s=float(a))
         for i, (a, p, m) in enumerate(trace)),
        key=lambda r: r.arrival_s,
    )
    done: list[_SimRequest] = []
    queue: list[_SimRequest] = []
    active: list[Optional[_SimRequest]] = [None] * slots
    clock, work = 0.0, 0

    def view(step):
        return EngineView(slots=slots, active=tuple(active), queue=tuple(queue),
                          chunking_ok=chunking_ok, max_len=max_len, step_index=step)

    def emit(req, step):
        req.out.append(0)
        if req.first_token is None:
            req.first_token = Stamp(clock, step, work)

    for step in range(max_steps):
        while pending and pending[0].arrival_s <= clock:
            req = pending.pop(0)
            req.arrival = Stamp(max(clock, req.arrival_s), step, work)
            scheduler.admit(req, view(step))
            queue.append(req)
        if not queue and not any(active) and pending:
            clock = pending[0].arrival_s  # idle: jump to the next arrival
            continue
        plan = scheduler.plan(view(step))
        if plan.is_empty:
            break
        if plan.refills:
            s_max = max(n for _, _, n in plan.refills)
            clock += t_call + len(plan.refills) * s_max * t_token
            work += len(plan.refills) * s_max
            for slot, req, n in plan.refills:
                queue.remove(req)
                active[slot] = req
                req.prefilled = n
                if n == req.prompt_len:
                    req.state = DECODING
                    emit(req, step)
                else:
                    req.state = PREFILLING
        decode = [s for s in plan.decode
                  if active[s] is not None and active[s].state == DECODING]
        if plan.chunks or decode:
            s_len = max([n for _, n in plan.chunks], default=1)
            clock += t_call + slots * s_len * t_token
            work += slots * s_len
            for slot, n in plan.chunks:
                req = active[slot]
                req.prefilled += n
                if req.prefilled >= req.prompt_len:
                    req.state = DECODING
                    emit(req, step)
            for slot in decode:
                req = active[slot]
                emit(req, step)
                if len(req.out) >= req.max_new:
                    req.state = DONE
                    req.finished = Stamp(clock, step, work)
                    active[slot] = None
                    done.append(req)
                    scheduler.on_complete(req, view(step))
    for req in queue + [r for r in active if r is not None] + pending:
        done.append(req)  # unfinished: recorded with partial stamps
    done.sort(key=lambda r: r.uid)
    return EngineStats(
        scheduler=scheduler.describe(),
        requests=tuple(request_stats(r) for r in done),
        total_tokens=sum(len(r.out) for r in done), wall_s=clock, work=work,
        steps=step + 1,
    )
