"""Derived metrics over an observability record stream.

Counterpart of :mod:`repro.obs.metrics` (a copy: pure Python).
Everything here is *derivation*, not collection: the inputs are the
records a :class:`~repro_torch.obs.trace.RingSink` retained (i.e.
``ServeEngine.timeline()``) or the live counter registry, and the outputs
are the summaries the launchers and examples print:

* :func:`percentile`         — linear-interpolation percentile (the numpy
                               default method), pure Python so the obs
                               layer stays dependency-free; property-tested
                               against ``np.percentile``.
* :func:`summarize_spans`    — per-span-name duration stats (count / total
                               / p50 / p95 / max).
* :func:`dispatch_table`     — kernel-dispatch counts per (kernel, labels)
                               series from ``kernel.dispatch`` counter
                               records (each record is one dispatch).
* :func:`request_stats_from_events` — rebuild per-request
                               :class:`~repro_torch.serve.scheduler.RequestStats`
                               from the ``request.*`` lifecycle event
                               stream.  The events carry the engine's own
                               three-clock stamps, so TTFT/TPOT derived
                               here are **value-identical** to the
                               engine's Stamp-based ``stats()``.
* :class:`StatsLineSink`     — periodic one-line serving stats for
                               ``launch/serve.py --stats-every N``.
"""

from __future__ import annotations

import math
import sys

from repro_torch.obs import trace as _trace
from repro_torch.obs.trace import PointRecord, Sink, SpanRecord


def percentile(values, q: float) -> float:
    """q-th percentile (0..100) with linear interpolation between closest
    ranks — the same method as ``np.percentile``'s default, so the two
    agree to float rounding on every input (property-tested)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("percentile of empty sequence")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    if len(vals) == 1:
        return vals[0]
    rank = (q / 100.0) * (len(vals) - 1)
    lo = math.floor(rank)
    frac = rank - lo
    if frac == 0.0:
        return vals[lo]
    return vals[lo] + frac * (vals[lo + 1] - vals[lo])


def summarize_spans(records) -> dict[str, dict]:
    """Per-span-name duration summary over a timeline.

    Returns ``{name: {count, total_s, mean_s, p50_s, p95_s, max_s}}`` —
    the per-phase step-loop breakdown (plan/prefill/decode/...) that the
    stats line and the serve launcher print.
    """
    by_name: dict[str, list] = {}
    for r in records:
        if isinstance(r, SpanRecord):
            by_name.setdefault(r.name, []).append(r.dur)
    out = {}
    for name, durs in by_name.items():
        out[name] = {
            "count": len(durs),
            "total_s": sum(durs),
            "mean_s": sum(durs) / len(durs),
            "p50_s": percentile(durs, 50),
            "p95_s": percentile(durs, 95),
            "max_s": max(durs),
        }
    return out


def dispatch_table(records, name: str = "kernel.dispatch") -> dict[tuple, int]:
    """Kernel-dispatch counts per label series from one timeline.

    Every ``kernel.dispatch`` counter record is one dispatch (the counters
    increment by 1), so counting records — rather than reading the global
    running totals, which other engines in the process also bump — gives
    the per-timeline table: ``{(("kernel","gemm_fused"), ("blocks","128x128x32"),
    ...): n_calls}`` keyed by the sorted label items.
    """
    table: dict[tuple, int] = {}
    for r in records:
        if isinstance(r, PointRecord) and r.kind == "counter" \
                and r.name == name:
            key = tuple(sorted(r.labels.items()))
            table[key] = table.get(key, 0) + 1
    return table


def counter_total(name: str) -> float:
    """Sum of the live counter registry over every label set of ``name``."""
    return sum(v for k, v in _trace.counters_snapshot().items()
               if k[0] == name)


# ---------------------------------------------------------------------------
# Request lifecycle: events → RequestStats (the spans-vs-Stamps twin)
# ---------------------------------------------------------------------------

#: lifecycle event names the engine emits (one mark per Stamp it takes)
EV_ARRIVAL = "request.arrival"
EV_FIRST_TOKEN = "request.first_token"
EV_FINISHED = "request.finished"


def request_stats_from_events(records) -> tuple:
    """Rebuild per-request SLO stats from the lifecycle event stream.

    Each ``request.*`` event carries the engine's three-clock stamp
    (``t`` seconds / ``step`` / ``work``) **as recorded by the engine's own
    clock at the moment it stamped the request**, plus ``uid``, ``state``,
    ``prompt_len`` and (at finish) ``new_tokens`` — so the TTFT/TPOT/E2E
    values derived here are bit-identical to
    ``ServeEngine.stats().requests`` (the Stamp path), not merely close.
    Returns a uid-ordered tuple of
    :class:`~repro_torch.serve.scheduler.RequestStats`.
    """
    from repro_torch.serve.scheduler import RequestStats  # lazy: no import cycle

    reqs: dict[int, dict] = {}
    for r in records:
        if not (isinstance(r, PointRecord) and r.kind == "event"
                and r.name.startswith("request.")):
            continue
        uid = int(r.labels["uid"])
        info = reqs.setdefault(uid, {})
        info[r.name] = r.labels
        info["state"] = r.labels["state"]  # latest event wins

    out = []
    for uid in sorted(reqs):
        info = reqs[uid]
        arr = info.get(EV_ARRIVAL)
        first = info.get(EV_FIRST_TOKEN)
        fin = info.get(EV_FINISHED)
        ttft_s = ttft_steps = ttft_work = tpot_s = e2e_s = None
        if first is not None and arr is not None:
            ttft_s = first["t"] - arr["t"]
            ttft_steps = first["step"] - arr["step"]
            ttft_work = first["work"] - arr["work"]
        new_tokens = int((fin or first or arr).get("new_tokens", 0))
        if fin is not None and arr is not None:
            e2e_s = fin["t"] - arr["t"]
            if first is not None and new_tokens > 1:
                tpot_s = (fin["t"] - first["t"]) / (new_tokens - 1)
        out.append(RequestStats(
            uid=uid, state=info["state"],
            prompt_len=int(arr["prompt_len"]) if arr else 0,
            new_tokens=new_tokens, ttft_s=ttft_s, ttft_steps=ttft_steps,
            ttft_work=ttft_work, tpot_s=tpot_s, e2e_s=e2e_s,
        ))
    return tuple(out)


# ---------------------------------------------------------------------------
# Periodic stats line
# ---------------------------------------------------------------------------


class StatsLineSink(Sink):
    """Print one serving stats line every ``every`` engine steps.

    Triggered by ``engine.step`` span records (the engine emits exactly one
    per :meth:`~repro_torch.serve.engine.ServeEngine.step`); the line summarizes
    the live registry — emitted tokens, kernel dispatches, page occupancy
    and resident bytes — plus the mean step wall time over the window::

        [obs] step 40 | 128 tok (3.2 tok/step) | 212 dispatches | \
pages 14/16 (hw 16) | cache 0.04 MB | step p50 12.1ms

    This is the ``launch/serve.py --stats-every N`` wiring; ``stream``
    defaults to stderr so CSV/JSON stdout consumers stay clean.
    """

    def __init__(self, every: int = 10, stream=None):
        if every < 1:
            raise ValueError("StatsLineSink needs every >= 1")
        self.every = int(every)
        self.stream = stream if stream is not None else sys.stderr
        self._steps = 0
        self._window: list = []
        self._last_tokens = 0.0

    def on_span(self, rec: SpanRecord) -> None:
        if rec.name != "engine.step":
            return
        self._steps += 1
        self._window.append(rec.dur)
        if self._steps % self.every:
            return
        tokens = counter_total("engine.tokens")
        d_tok = tokens - self._last_tokens
        self._last_tokens = tokens
        parts = [
            f"[obs] step {self._steps}",
            f"{tokens:.0f} tok ({d_tok / self.every:.1f} tok/step)",
            f"{counter_total('kernel.dispatch'):.0f} dispatches",
        ]
        occ = _trace.gauge_value("pages.occupancy")
        if occ is not None:
            hw = _trace.gauge_value("pages.high_water")
            parts.append(f"pages {occ:.0f} (hw {hw:.0f})")
        cache_b = _trace.gauge_value("bytes.cache")
        if cache_b is not None:
            parts.append(f"cache {cache_b / 1e6:.2f} MB")
        parts.append(f"step p50 {percentile(self._window, 50) * 1e3:.1f}ms")
        self._window.clear()
        print(" | ".join(parts), file=self.stream, flush=True)
