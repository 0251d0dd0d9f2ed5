"""Trace Event Format schema validation for exported Chrome traces.

Counterpart of :mod:`repro.obs.validate` (a copy: pure Python).
``validate_chrome(doc)`` checks the subset of the Chrome Trace Event Format
that :mod:`repro_torch.obs.export` emits (and that ``chrome://tracing``
/ Perfetto require to load a file at all): a ``traceEvents`` list of
event dicts, each with a string ``name``, a known ``ph`` phase code, a
numeric ``ts``, integer ``pid``/``tid``, and — for ``"X"`` complete
events — a non-negative numeric ``dur``.  Raises :class:`TraceFormatError`
on the first violation with the offending event index.

CLI form::

    PYTHONPATH=src python -m repro_torch.obs.validate out.json
"""

from __future__ import annotations

import json
import sys

#: phase codes the exporter may emit plus the B/E pair for completeness
KNOWN_PHASES = frozenset({"X", "B", "E", "i", "I", "C", "M"})


class TraceFormatError(ValueError):
    """The document does not conform to the Trace Event Format subset."""


def _fail(i, msg):
    raise TraceFormatError(f"traceEvents[{i}]: {msg}")


def validate_chrome(doc) -> dict:
    """Validate a Chrome-trace document; returns summary stats.

    Returns ``{"events": n, "spans": n_x, "counters": n_c,
    "instants": n_i, "span_names": set, "counter_names": set}`` so
    callers (the chip smoke run, the tests) can assert on
    *content* — which spans and counter tracks made it into the file —
    after structural validity is established.
    """
    if not isinstance(doc, dict):
        raise TraceFormatError(f"document must be a JSON object, "
                               f"got {type(doc).__name__}")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise TraceFormatError('document must carry a "traceEvents" list')
    n_x = n_c = n_i = 0
    span_names, counter_names = set(), set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            _fail(i, f"event must be an object, got {type(ev).__name__}")
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            _fail(i, f"missing/empty name: {name!r}")
        ph = ev.get("ph")
        if ph not in KNOWN_PHASES:
            _fail(i, f"unknown phase {ph!r} (known: {sorted(KNOWN_PHASES)})")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool):
            _fail(i, f"ts must be a number, got {ts!r}")
        for field in ("pid", "tid"):
            v = ev.get(field)
            if not isinstance(v, int) or isinstance(v, bool):
                _fail(i, f"{field} must be an int, got {v!r}")
        args = ev.get("args")
        if args is not None and not isinstance(args, dict):
            _fail(i, f"args must be an object, got {type(args).__name__}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or isinstance(dur, bool):
                _fail(i, f'"X" event needs a numeric dur, got {dur!r}')
            if dur < 0:
                _fail(i, f"negative dur {dur}")
            n_x += 1
            span_names.add(name)
        elif ph == "C":
            n_c += 1
            counter_names.add(name)
        elif ph in ("i", "I"):
            n_i += 1
    return {"events": len(events), "spans": n_x, "counters": n_c,
            "instants": n_i, "span_names": span_names,
            "counter_names": counter_names}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.validate trace.json",
              file=sys.stderr)
        return 2
    path = argv[0]
    with open(path) as f:
        doc = json.load(f)
    try:
        stats = validate_chrome(doc)
    except TraceFormatError as e:
        print(f"INVALID {path}: {e}", file=sys.stderr)
        return 1
    print(f"OK {path}: {stats['events']} events "
          f"({stats['spans']} spans, {stats['counters']} counter samples, "
          f"{stats['instants']} instants)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
