"""The port's observability registry (``repro_torch.obs``) against the JAX
reference's.

The cases of ``tests/test_obs.py`` that need no JAX, on the port's copy:
span nesting and exception safety, the shared null span, ``disabled()``,
counters and gauges, the ring's capacity, ``percentile`` against numpy,
the stats line, the Chrome round trip and the validator's refusals (and
its command line); the page pool's ``pages.*`` counters.  Then a traced
serve in both packages on one trace (``paged_int4_bp_fused`` under
``prefix_cache``, path A's stack, prompts sharing a prefix): the same
``engine.*`` spans and ``request.*`` events, name for name and count for
count, and the same ``pages.*`` totals; the port's Chrome trace valid under
both validators; TTFT/TPOT rebuilt from the events equal to ``stats()``;
the ``kernel.dispatch`` counter's totals equal to the launch counts and,
for the plain versions the CPU runs, to the calls a step makes; and the
launcher's ``--trace`` / ``--stats-every`` on the CPU.
"""

import io
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

import repro.obs as ref_obs
import repro_torch.obs as obs
from repro.obs import validate as ref_validate
from repro.serve import engine as ref_engine
from repro_torch.kernels import ops
from repro_torch.obs import trace as trace_mod
from repro_torch.obs import validate
from repro_torch.serve import engine

from _hypothesis_compat import given, settings, st
from test_torch_mla import cfgs, port_params, ref_params

SRC = Path(__file__).resolve().parents[1] / "src"
VOCAB = 128
MODE = "ffn=bsdp_fused,mixer=w8a16"
SLOTS, MAX_LEN, MAX_NEW = 2, 32, 4


@pytest.fixture(autouse=True)
def _clean_obs():
    """Sinks and the registry are module-global: reset around every test."""
    for mod in (obs, ref_obs):
        mod.clear_sinks()
        mod.reset_metrics()
    yield
    for mod in (obs, ref_obs):
        mod.clear_sinks()
        mod.reset_metrics()


class _SpySink(obs.Sink):
    def __init__(self):
        self.calls = 0

    def on_span(self, rec):
        self.calls += 1

    def on_point(self, rec):
        self.calls += 1


# ---------------------------------------------------------------------------
# The core
# ---------------------------------------------------------------------------


class TestSpans:
    @settings(max_examples=12)
    @given(st.lists(st.integers(min_value=1, max_value=4), min_size=0, max_size=6))
    def test_nesting_depth_restored_and_recorded(self, chain_depths):
        obs.clear_sinks()
        ring = obs.register_sink(obs.RingSink())

        def nest(d):
            with obs.span(f"level{d}"):
                if d > 1:
                    nest(d - 1)

        for d in chain_depths:
            nest(d)
        assert obs.current_depth() == 0
        spans = [r for r in ring.records() if isinstance(r, obs.SpanRecord)]
        assert len(spans) == sum(chain_depths)
        assert sorted(r.depth for r in spans) == sorted(
            lvl for d in chain_depths for lvl in range(d))
        assert all(r.dur >= 0 for r in spans)

    @settings(max_examples=8)
    @given(st.integers(min_value=1, max_value=5))
    def test_exception_safety(self, depth):
        obs.clear_sinks()
        ring = obs.register_sink(obs.RingSink())

        class Boom(RuntimeError):
            pass

        def nest(d):
            with obs.span(f"s{d}"):
                if d == 1:
                    raise Boom("bang")
                nest(d - 1)

        with pytest.raises(Boom):
            nest(depth)
        assert obs.current_depth() == 0
        spans = [r for r in ring.records() if isinstance(r, obs.SpanRecord)]
        assert len(spans) == depth
        assert all(r.attrs.get("error") == "Boom" for r in spans)

    def test_no_sink_returns_shared_null_span(self):
        assert not obs.active()
        assert {id(obs.span(f"s{i}", a=i)) for i in range(100)} == {id(obs.NULL_SPAN)}

    def test_disabled_context_spy_sees_nothing(self):
        spy = obs.register_sink(_SpySink())
        assert obs.active()
        with obs.disabled():
            assert not obs.active()
            assert obs.span("x", a=1) is obs.NULL_SPAN
            with obs.span("y"):
                obs.counter("c.test", 5)
                obs.gauge("g.test", 1.0)
                obs.event("e.test")
        assert spy.calls == 0
        assert obs.counter_value("c.test") == 0 and obs.gauge_value("g.test") is None
        with obs.span("z"):
            obs.counter("c.test")
        assert spy.calls == 2 and obs.counter_value("c.test") == 1

    def test_span_attrs_reach_sink(self):
        ring = obs.register_sink(obs.RingSink())
        with obs.span("engine.prefill", slots=2, tokens=17):
            pass
        (rec,) = ring.records()
        assert rec.name == "engine.prefill" and rec.attrs == {"slots": 2, "tokens": 17}


class TestCountersAndGauges:
    def test_counter_accumulates_per_label_set(self):
        ring = obs.register_sink(obs.RingSink())
        obs.counter("k.d", kernel="a")
        obs.counter("k.d", kernel="a")
        obs.counter("k.d", kernel="b")
        obs.counter("k.d", 3, kernel="b")
        assert obs.counter_value("k.d", kernel="a") == 2
        assert obs.counter_value("k.d", kernel="b") == 4
        assert [r.value for r in ring.records() if r.labels == {"kernel": "b"}] == [1, 4]

    def test_gauge_last_value_wins(self):
        obs.register_sink(obs.NullSink())
        obs.gauge("occ", 3)
        obs.gauge("occ", 7)
        assert obs.gauge_value("occ") == 7
        assert trace_mod.gauges_snapshot() == {("occ",): 7}

    def test_pool_telemetry_emits_counters(self):
        from repro_torch.core import paging

        obs.register_sink(obs.NullSink())
        pool = paging.PagePool(4, 2)
        pool.release(pool.alloc(3))
        pool.note_cow()
        pool.note_eviction(2)
        pool.note_prefix_hit(16)
        assert obs.counter_value("pages.alloc") == 3
        assert obs.counter_value("pages.free") == 3
        assert obs.counter_value("pages.cow") == 1
        assert obs.counter_value("pages.evict") == 2
        assert obs.counter_value("pages.prefix_hit") == 1
        assert obs.counter_value("pages.prefix_tokens_saved") == 16
        assert obs.gauge_value("pages.occupancy") == 0
        assert obs.gauge_value("pages.high_water") == 3


class TestRingSink:
    def test_capacity_drops_oldest(self):
        ring = obs.register_sink(obs.RingSink(capacity=4))
        for i in range(7):
            obs.event("e", i=i)
        assert len(ring.records()) == 4 and ring.dropped == 3
        assert [r.labels["i"] for r in ring.records()] == [3, 4, 5, 6]
        ring.clear()
        assert ring.records() == [] and ring.dropped == 0
        with pytest.raises(ValueError):
            obs.RingSink(capacity=0)

    def test_register_unregister(self):
        ring = obs.register_sink(obs.RingSink())
        assert obs.active() and ring in obs.sinks()
        obs.unregister_sink(ring)
        assert not obs.active()
        obs.unregister_sink(ring)  # a second removal is a no-op


class TestDerivedMetrics:
    @settings(max_examples=30)
    @given(st.lists(st.floats(min_value=-1e6, max_value=1e6), min_size=1, max_size=40),
           st.floats(min_value=0.0, max_value=100.0))
    def test_percentile_matches_numpy(self, values, q):
        expected = float(np.percentile(np.asarray(values, np.float64), q))
        assert obs.percentile(values, q) == pytest.approx(expected, rel=1e-9, abs=1e-6)

    def test_percentile_rejects_empty_and_bad_q(self):
        with pytest.raises(ValueError):
            obs.percentile([], 50)
        with pytest.raises(ValueError):
            obs.percentile([1.0], 101)

    def test_summarize_spans_and_dispatch_table(self):
        recs = [obs.SpanRecord("a", 0.0, d, 0, {}) for d in (0.1, 0.3)]
        recs.append(obs.SpanRecord("b", 0.0, 0.2, 1, {}))
        recs.append(obs.PointRecord("counter", "c", 0.0, 1, {}))
        summary = obs.summarize_spans(recs)
        assert set(summary) == {"a", "b"} and summary["a"]["count"] == 2
        assert summary["a"]["total_s"] == pytest.approx(0.4)
        assert summary["a"]["p50_s"] == pytest.approx(0.2)
        recs = [obs.PointRecord("counter", "kernel.dispatch", 0.0, t, {"kernel": k})
                for t, k in [(1, "a"), (2, "a"), (1, "b"), (3, "a")]]
        recs.append(obs.PointRecord("gauge", "kernel.dispatch", 0.0, 9, {}))
        assert obs.dispatch_table(recs) == {(("kernel", "a"),): 3, (("kernel", "b"),): 1}

    def test_stats_line_every_n_steps(self):
        out = io.StringIO()
        sink = obs.register_sink(obs.StatsLineSink(every=2, stream=out))
        obs.counter("engine.tokens", 6)
        obs.gauge("pages.occupancy", 3)
        obs.gauge("pages.high_water", 5)
        obs.gauge("bytes.cache", 2e6)
        step = obs.SpanRecord("engine.step", 0.0, 0.01, 0, {})
        sink.on_span(step)
        sink.on_span(obs.SpanRecord("engine.plan", 0.0, 0.01, 1, {}))
        assert out.getvalue() == ""
        sink.on_span(step)
        line = out.getvalue()
        for part in ("[obs] step 2", "6 tok (3.0 tok/step)", "pages 3 (hw 5)",
                     "cache 2.00 MB"):
            assert part in line
        with pytest.raises(ValueError):
            obs.StatsLineSink(every=0)


class TestChromeExport:
    def test_roundtrip_validates_under_both_validators(self, tmp_path):
        ring = obs.register_sink(obs.RingSink())
        with obs.span("outer", a=1):
            with obs.span("inner"):
                obs.counter("k", kernel="x")
            obs.gauge("g", np.float32(2.0))
            obs.event("request.arrival", uid=3, state="queued", t=0.0, step=0, work=0,
                      prompt_len=4, new_tokens=0)
        path = tmp_path / "trace.json"
        doc = obs.write_chrome_trace(ring.records(), str(path))
        assert json.loads(path.read_text()) == doc
        for check in (obs.validate_chrome, ref_obs.validate_chrome):
            stats = check(doc)
            assert stats["span_names"] == {"inner", "outer"}
            assert stats["counter_names"] == {"k[kernel=x]", "g"}
            assert stats["instants"] == 1
        assert min(e["ts"] for e in doc["traceEvents"]) == 0
        assert obs.validate_chrome(obs.chrome_trace([]))["events"] == 0

    @pytest.mark.parametrize("doc", [
        [1, 2],
        {"foo": []},
        {"traceEvents": [None]},
        {"traceEvents": [{"ph": "X", "ts": 0, "pid": 0, "tid": 0, "dur": 1}]},
        {"traceEvents": [{"name": "a", "ph": "Q", "ts": 0, "pid": 0, "tid": 0}]},
        {"traceEvents": [{"name": "a", "ph": "i", "ts": "0", "pid": 0, "tid": 0}]},
        {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "pid": 0, "tid": 0}]},
        {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "pid": 0, "tid": 0, "dur": -1}]},
        {"traceEvents": [{"name": "a", "ph": "i", "ts": 0, "pid": 0, "tid": 1.5}]},
    ])
    def test_validator_rejects(self, doc):
        with pytest.raises(obs.TraceFormatError):
            obs.validate_chrome(doc)

    def test_validate_cli(self, tmp_path):
        good = tmp_path / "good.json"
        good.write_text('{"traceEvents": []}')
        assert validate.main([str(good)]) == 0
        bad = tmp_path / "bad.json"
        bad.write_text('{"traceEvents": [{"ph": "Z"}]}')
        assert validate.main([str(bad)]) == 1
        assert validate.main([]) == 2
        out = subprocess.run([sys.executable, "-m", "repro_torch.obs.validate", str(good)],
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, PYTHONPATH=str(SRC)))
        assert out.returncode == 0 and out.stdout.startswith("OK")


# ---------------------------------------------------------------------------
# A traced serve in both packages
# ---------------------------------------------------------------------------


def _prompts():
    """Four prompts, the first three sharing a 16-token prefix (two pages),
    so later requests attach to the first one's pages."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, VOCAB, size=16).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, VOCAB, size=n).astype(np.int32)])
            for n in (3, 5, 2)] + [rng.integers(0, VOCAB, size=7).astype(np.int32)]


def _traced(mod, params, cfg, **kw):
    mod_obs = obs if mod is engine else ref_obs
    mod_obs.clear_sinks()
    mod_obs.reset_metrics()
    eng = mod.ServeEngine(params, cfg, slots=SLOTS, max_len=MAX_LEN, mode=MODE,
                          cache_format="paged_int4_bp_fused", scheduler="prefix_cache",
                          min_dim=16, trace=True, **kw)
    reqs = [eng.submit(p, MAX_NEW) for p in _prompts()]
    eng.run()
    data = dict(timeline=eng.timeline(), stats=eng.stats(), outs=[r.out for r in reqs],
                cache_bytes=mod_obs.gauge_value("bytes.cache"),
                pages={name: mod_obs.counter_total(name) for name in (
                    "pages.alloc", "pages.free", "pages.cow", "pages.evict",
                    "pages.prefix_hit", "pages.prefix_tokens_saved")})
    if mod is engine:
        from repro_torch.core import kvcache

        data["caches_bytes"] = kvcache.cache_resident_bytes(eng.caches)
        data["launches"] = ops.launch_counts()
    mod_obs.clear_sinks()
    mod_obs.reset_metrics()
    return data


@pytest.fixture(scope="module")
def traced_pair():
    cfg_ref, cfg = cfgs("qwen3-1.7b", vocab_size=VOCAB)
    ops.reset_counts()
    port = _traced(engine, port_params("qwen3-1.7b"), cfg, device="cpu")
    ref = _traced(ref_engine, ref_params("qwen3-1.7b"), cfg_ref)
    return port, ref


def _span_counts(timeline, mod):
    return Counter(r.name for r in timeline if isinstance(r, mod.SpanRecord)
                   and r.name.startswith("engine."))


def _event_counts(timeline, mod):
    return Counter((r.name, r.labels["uid"]) for r in timeline
                   if isinstance(r, mod.PointRecord) and r.kind == "event"
                   and r.name.startswith("request."))


def test_traced_serve_matches_reference_span_for_span(traced_pair):
    """The same ``engine.*`` spans (cow included) and ``request.*`` events
    name for name and count for count, the same tokens, and the same
    ``pages.*`` counter totals, which equal ``stats().pages``."""
    port, ref = traced_pair
    assert port["outs"] == ref["outs"] and all(len(o) == MAX_NEW for o in port["outs"])
    spans = _span_counts(port["timeline"], obs)
    assert spans == _span_counts(ref["timeline"], ref_obs)
    assert {"engine.step", "engine.plan", "engine.reserve", "engine.prefill", "engine.cow",
            "engine.decode", "engine.complete"} <= set(spans)
    assert _event_counts(port["timeline"], obs) == _event_counts(ref["timeline"], ref_obs)
    assert port["pages"] == ref["pages"]
    pages = port["stats"].pages
    assert pages == ref["stats"].pages and pages["prefix_hits"] >= 1
    assert port["pages"] == {
        "pages.alloc": pages["total_allocated"], "pages.free": pages["total_freed"],
        "pages.cow": pages["cow_copies"], "pages.evict": pages["evictions"],
        "pages.prefix_hit": pages["prefix_hits"],
        "pages.prefix_tokens_saved": pages["prefix_tokens_saved"]}
    assert port["cache_bytes"] == port["caches_bytes"]


def test_trace_validates_under_both_validators(traced_pair, tmp_path):
    doc = obs.write_chrome_trace(traced_pair[0]["timeline"], str(tmp_path / "t.json"))
    for check in (obs.validate_chrome, ref_obs.validate_chrome):
        stats = check(json.loads((tmp_path / "t.json").read_text()))
        assert {"engine.plan", "engine.prefill", "engine.decode"} <= stats["span_names"]
        assert any(n.startswith("kernel.dispatch") for n in stats["counter_names"])
    assert doc["traceEvents"]


def test_request_stats_from_events_equal_stats(traced_pair):
    derived = obs.request_stats_from_events(traced_pair[0]["timeline"])
    assert derived == traced_pair[0]["stats"].requests
    assert all(r.state == "done" for r in derived)


def test_kernel_dispatch_counts_executions(traced_pair):
    """On the CPU no kernel launches (``impl="cuda"`` totals equal the
    launch counts: zero) and every dispatch is a plain version: plane
    attention once a layer a decode call, ``dequant_matmul`` four times a
    layer (wq, wk, wv, wo) a prefill or decode call, the two BSDP FFN
    projections twice a layer a call, the GEMV at one token a row."""
    port = traced_pair[0]
    table = obs.dispatch_table(port["timeline"])
    by_impl = Counter()
    for key, n in table.items():
        labels = dict(key)
        by_impl[labels["kernel"], labels["impl"]] += n
    assert {k: v for (k, impl), v in by_impl.items() if impl == "cuda"} == {
        k: v for k, v in port["launches"].items() if v}
    spans = _span_counts(port["timeline"], obs)
    layers = cfgs("qwen3-1.7b")[1].n_layers
    calls = spans["engine.decode"] + spans["engine.prefill"]
    assert by_impl["plane_decode_attention", "plain"] == layers * spans["engine.decode"]
    assert by_impl["dequant_matmul", "plain"] == 4 * layers * calls
    assert by_impl["bsdp_gemm_fused", "plain"] + by_impl["bsdp_gemv", "plain"] == \
        2 * layers * calls


def test_launcher_traces_a_paged_prefix_cache_serve(tmp_path):
    trace = tmp_path / "t.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b", "--smoke",
         "--cache-format", "paged_int4_bp", "--scheduler", "prefix_cache", "--trace",
         str(trace), "--stats-every", "2", "--device", "cpu", "--min-dim", "16",
         "--requests", "3", "--max-new", "4"],
        capture_output=True, text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr
    assert "[obs] step 2" in out.stderr and "pages:" in out.stdout
    doc = json.loads(trace.read_text())
    assert "engine.decode" in obs.validate_chrome(doc)["span_names"]
    assert ref_validate.main([str(trace)]) == 0
