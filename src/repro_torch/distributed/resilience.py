"""Fault tolerance and straggler telemetry for long training jobs.

Counterpart of :mod:`repro.distributed.resilience`, which is pure Python:
:class:`StepWatchdog` (per-step time against an EWMA baseline; stragglers
and hangs), :class:`FailureSim` (raises :class:`SimulatedFailure` at
configured steps, once each, to drive the trainer's restart from its
latest checkpoint) and :func:`plan_elastic_mesh` (the largest ``(data,
model)`` grid the surviving devices hold; a checkpoint holds the global
tree, so the trainer restores it onto that mesh as onto any other).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class WatchdogReport:
    step: int
    seconds: float
    ewma: float
    straggler: bool


class StepWatchdog:
    def __init__(self, *, ratio: float = 2.0, alpha: float = 0.1,
                 hang_timeout: float = 600.0):
        self.ratio, self.alpha, self.hang_timeout = ratio, alpha, hang_timeout
        self.ewma: Optional[float] = None
        self.last_beat = time.monotonic()
        self.reports: list[WatchdogReport] = []
        self.straggler_steps: list[int] = []

    def observe(self, step: int, seconds: float) -> WatchdogReport:
        self.last_beat = time.monotonic()
        if self.ewma is None:
            self.ewma = seconds
        straggler = seconds > self.ratio * self.ewma and step > 2
        # stragglers do not update the baseline (they would mask repeats)
        if not straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        rep = WatchdogReport(step, seconds, self.ewma, straggler)
        self.reports.append(rep)
        if straggler:
            self.straggler_steps.append(step)
        return rep

    def hung(self) -> bool:
        return (time.monotonic() - self.last_beat) > self.hang_timeout


class FailureSim:
    """Raise SimulatedFailure at the configured steps (once each)."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = set(fail_at)

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise SimulatedFailure(f"injected failure at step {step}")


def plan_elastic_mesh(n_devices: int, *, model_parallel: int, min_data: int = 1
                      ) -> Optional[tuple[int, int]]:
    """Largest ``(data, model)`` grid for the surviving device count:
    ``model_parallel`` is fixed by the weights' shardability, ``data`` the
    largest with ``data · model <= n_devices``; None if even ``min_data``
    does not fit (the job cannot continue)."""
    if n_devices < model_parallel * min_data:
        return None
    return (n_devices // model_parallel, model_parallel)
