"""Chrome-trace / Perfetto export of an observability record stream.

Counterpart of :mod:`repro.obs.export` (a copy: pure Python).
``chrome_trace(records)`` converts :class:`~repro_torch.obs.trace.SpanRecord`
/ :class:`~repro_torch.obs.trace.PointRecord` streams (e.g. from a
:class:`~repro_torch.obs.trace.RingSink`, i.e. ``ServeEngine.timeline()``)
into the Trace Event Format JSON object that ``chrome://tracing`` and
https://ui.perfetto.dev load directly:

* spans     → ``"ph": "X"`` complete events (``ts``/``dur`` in µs),
              ``tid`` = nesting depth so the flame graph renders without
              parent pointers;
* counters  → ``"ph": "C"`` counter tracks carrying the running total
              (one track per (name, labels) series);
* gauges    → ``"ph": "C"`` tracks of the last value;
* events    → ``"ph": "i"`` instants, ``tid`` keyed by the request ``uid``
              label when present, so per-request lifecycle marks thread
              onto per-request rows.

:class:`ChromeTraceSink` is the streaming form for
``launch/serve.py --trace out.json``: it collects records as they are
emitted and writes the JSON file on :meth:`close`.  The emitted document
always validates against :func:`repro_torch.obs.validate.validate_chrome`.
"""

from __future__ import annotations

import json

from repro_torch.obs.trace import PointRecord, Sink, SpanRecord

#: Chrome Trace Event Format phase codes this exporter emits
PH_COMPLETE, PH_COUNTER, PH_INSTANT, PH_META = "X", "C", "i", "M"


def _series(name: str, labels: dict) -> str:
    if not labels:
        return name
    tags = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}[{tags}]"


def chrome_trace(records, *, pid: int = 0) -> dict:
    """Records → ``{"traceEvents": [...], ...}`` Trace Event Format dict.

    Timestamps are rebased to the earliest record so traces start at 0 —
    ``perf_counter`` epochs are process-relative and Chrome renders huge
    absolute offsets poorly.
    """
    if not records:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(r.ts for r in records)
    events = [
        {"name": "process_name", "ph": PH_META, "pid": pid, "tid": 0,
         "ts": 0, "args": {"name": "repro_torch.serve"}},
    ]
    for r in sorted(records, key=lambda r: r.ts):
        ts_us = (r.ts - t0) * 1e6
        if isinstance(r, SpanRecord):
            events.append({
                "name": r.name, "ph": PH_COMPLETE, "pid": pid,
                "tid": r.depth, "ts": ts_us, "dur": r.dur * 1e6,
                "args": {k: _jsonable(v) for k, v in r.attrs.items()},
            })
        elif isinstance(r, PointRecord) and r.kind in ("counter", "gauge"):
            events.append({
                "name": _series(r.name, r.labels), "ph": PH_COUNTER,
                "pid": pid, "tid": 0, "ts": ts_us,
                "args": {"value": _jsonable(r.value)},
            })
        elif isinstance(r, PointRecord):  # instant lifecycle event
            events.append({
                "name": r.name, "ph": PH_INSTANT, "pid": pid,
                "tid": int(r.labels.get("uid", 0)), "ts": ts_us, "s": "t",
                "args": {k: _jsonable(v) for k, v in r.labels.items()},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _jsonable(v):
    """Coerce attr values to JSON scalars (numpy ints/floats, tuples)."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    try:
        return v.item()  # numpy scalar
    except AttributeError:
        return str(v)


def write_chrome_trace(records, path: str, *, pid: int = 0) -> dict:
    """Export ``records`` and write the JSON document to ``path``."""
    doc = chrome_trace(records, pid=pid)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc


class ChromeTraceSink(Sink):
    """Streaming Chrome-trace sink: collect records, write JSON on close.

    ``launch/serve.py --trace out.json`` registers one of these for the
    whole serve run; :meth:`close` (or use as a context manager) writes
    the file and unregisters nothing — pair with
    :func:`repro_torch.obs.trace.unregister_sink` for scoped use.
    """

    def __init__(self, path: str):
        self.path = path
        self._records: list = []

    def on_span(self, rec: SpanRecord) -> None:
        self._records.append(rec)

    def on_point(self, rec: PointRecord) -> None:
        self._records.append(rec)

    def __len__(self) -> int:
        return len(self._records)

    def close(self) -> dict:
        """Write the collected records to ``self.path``; returns the doc."""
        return write_chrome_trace(self._records, self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
