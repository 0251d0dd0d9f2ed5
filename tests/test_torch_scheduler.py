"""The port's schedulers and chunked prefill against the JAX reference.

Twin of ``tests/test_scheduler.py``.  Both packages serve the reference's
own weights (brought across with ``repro_torch.convert.params_from_numpy``)
on the 2-layer smoke qwen3-1.7b with ``VOCAB = 128``, in float32, at
slots=2: the canonical schedule of three requests (prompts 5, 3 and 7
tokens), first teacher-forced, then greedy (unforced, so equal ``out``
lists say that both packages picked the same argmax at every step).  Every
scheduler × cache format × weight residency must give the reference's
logit-trace kinds and slots, logits within ``LOGIT_RTOL`` and the same
tokens; ``token_budget:budget=2`` and ``:budget=6`` cut the prompts into
chunks, which run through the decode path beside the decode rows.  Then
the lifecycle (cancel, streaming, uids), the registry, the deterministic
work clock on the reference's mixed-length trace, and ``simulate``.  The
port runs on the CPU, where every kernel wrapper takes its plain version.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.serve import scheduler as ref_sched
from repro.sharding import partitioning as P
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import (
    CANCELLED,
    DECODING,
    DONE,
    PREFILLING,
    QUEUED,
    FCFSScheduler,
    StepPlan,
)

VOCAB = 128
SCHEDULERS = ["fcfs", "sjf", "token_budget:budget=2", "token_budget:budget=6"]
CACHES = ["bf16", "int8", "int4_bp", "int4_bp_fused"]
MODES = ["bf16", "w8a8", "ffn=bsdp_fused,mixer=w8a16"]
#: the serve tests' logit tolerance (tests/test_torch_serve.py: float32
#: rounding between the two frameworks, relative to the largest logit;
#: measured at most 7e-7 on these schedules)
LOGIT_RTOL = 1e-4


def _cfgs():
    ref_cfg = ref_smoke_config("qwen3-1.7b").scaled(
        n_layers=2, vocab_size=VOCAB, dtype=jnp.float32)
    cfg = get_smoke_config("qwen3-1.7b").scaled(
        n_layers=2, vocab_size=VOCAB, dtype=torch.float32)
    return ref_cfg, cfg


_PARAMS: dict = {}


def _params():
    """(reference params, the port's copy of them), once per process."""
    if not _PARAMS:
        ref_cfg, cfg = _cfgs()
        ref_params = P.materialize(ref_model.specs(ref_cfg, 1), jax.random.PRNGKey(0))
        _PARAMS["both"] = (ref_params, convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu"))
    return _PARAMS["both"]


def _submit_schedule(eng, forced):
    """The canonical mid-stream-refill schedule of the serve tests."""
    rng = np.random.default_rng(0)
    return [
        eng.submit(rng.integers(0, VOCAB, size=(n,)).astype(np.int32), mn,
                   force=rng.integers(0, VOCAB, size=(mn,)).astype(np.int32)
                   if forced else None)
        for n, mn in zip((5, 3, 7), (6, 2, 4))
    ]


def _engines(**kw):
    ref_params, params = _params()
    ref_cfg, cfg = _cfgs()
    return (ref_engine.ServeEngine(ref_params, ref_cfg, **kw),
            ServeEngine(params, cfg, device="cpu", **kw))


_SERVES: dict = {}


def _serve(scheduler, cache, mode):
    """Both engines serve the forced schedule, then the greedy one (one
    engine per package and combination, so the reference compiles once);
    returns {forced: (ref trace, ref reqs, port trace, port reqs, the
    port's planned chunk rows)}."""
    key = (scheduler, cache, mode)
    if key not in _SERVES:
        engines = _engines(slots=2, max_len=32, mode=mode, cache_format=cache,
                           scheduler=scheduler, min_dim=16, trace_logits=True)
        plan = engines[1].scheduler.plan
        chunks = []  # the port's chunk rows, as its scheduler planned them

        def recording_plan(view):
            step_plan = plan(view)
            chunks.extend(step_plan.chunks)
            return step_plan

        engines[1].scheduler.plan = recording_plan
        runs = {forced: [] for forced in (True, False)}
        for forced in (True, False):
            for eng in engines:
                start = len(eng.logit_trace)
                reqs = _submit_schedule(eng, forced)
                eng.run()
                runs[forced] += [eng.logit_trace[start:], reqs]
            runs[forced].append(len(chunks))
            chunks.clear()
        _SERVES[key] = runs
    return _SERVES[key]


@pytest.mark.parametrize("forced", [True, False], ids=["forced", "greedy"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_schedule_matches_reference(scheduler, cache, mode, forced):
    ref_trace, ref_reqs, trace, reqs, n_chunks = _serve(scheduler, cache, mode)[forced]
    kinds = [(k, s) for k, s, _ in trace]
    assert kinds == [(k, s) for k, s, _ in ref_trace]
    assert sum(1 for k, _ in kinds if k == "prefill") == 3
    for (_, _, lr), (_, _, lp) in zip(ref_trace, trace):
        lr = np.asarray(lr, np.float32)
        assert lr.shape == lp.shape
        err = np.abs(lr - lp).max() / (np.abs(lr).max() + 1e-6)
        assert err < LOGIT_RTOL, err
    for a, b in zip(ref_reqs, reqs):
        assert a.out == b.out and a.state == b.state == DONE
        assert b.prefilled == b.prompt_len
    # the prompts longer than the budget advanced through chunk rows
    assert (n_chunks > 0) == scheduler.startswith("token_budget")


def test_chunk_state_walks_prefilling_to_decoding():
    """Twin of the reference's walk: a 10-token prompt at budget 4 is
    PREFILLING after the first two steps and DECODING after the third, in
    both packages step for step."""
    walks = []
    for eng in _engines(slots=1, max_len=32, scheduler="token_budget:budget=4"):
        r = eng.submit(np.arange(10, dtype=np.int32), 2)
        walk = []
        while eng.step():
            walk.append((r.state, r.prefilled, len(r.out)))
        walks.append(walk)
    assert walks[1] == walks[0]
    assert walks[1][:3] == [(PREFILLING, 4, 0), (PREFILLING, 8, 0), (DECODING, 10, 1)]
    assert walks[1][-1] == (DONE, 10, 2)


#: the reference's mixed-length arrival trace (test_scheduler.py TestTokenBudget):
#: (arrival step, prompt length, max_new)
TRACE = ((0, 24, 3), (0, 4, 3), (0, 5, 3), (0, 6, 3), (0, 4, 3),
         (2, 5, 3), (3, 6, 3), (4, 4, 3))


def _drive_trace(eng, prompts):
    pending = list(zip(TRACE, prompts))
    reqs = []
    while pending or any(eng.active) or eng.queue:
        while pending and pending[0][0][0] <= eng.step_index:
            (_, _, max_new), prompt = pending.pop(0)
            reqs.append(eng.submit(prompt, max_new))
        eng.step()
    return reqs


@pytest.mark.parametrize("scheduler", ["fcfs", "token_budget:budget=8"])
def test_work_clock_on_the_mixed_length_trace_equals_reference(scheduler):
    """The deterministic clocks are the reference's exactly: ttft_work and
    ttft_steps of every request, total tokens, work and steps."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, size=(p,)).astype(np.int32) for _, p, _ in TRACE]
    ref_st, st = (_drive_and_stats(eng, prompts)
                  for eng in _engines(slots=4, max_len=32, scheduler=scheduler))
    for field in ("ttft_work", "ttft_steps", "new_tokens", "state", "prompt_len"):
        assert [getattr(r, field) for r in st.requests] == \
            [getattr(r, field) for r in ref_st.requests], field
    assert (st.total_tokens, st.work, st.steps, st.scheduler) == \
        (ref_st.total_tokens, ref_st.work, ref_st.steps, ref_st.scheduler)


def _drive_and_stats(eng, prompts):
    _drive_trace(eng, prompts)
    return eng.stats()


def test_chunking_strictly_lowers_the_shorts_ttft_work():
    """The port's own run of the reference's acceptance: the four shorts
    co-arriving with the 24-token prompt get their first token strictly
    earlier in work units under token_budget:budget=8, and p95 does not
    regress."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, size=(p,)).astype(np.int32) for _, p, _ in TRACE]
    _, params = _params()
    stats = {}
    for name in ("fcfs", "token_budget:budget=8"):
        eng = ServeEngine(params, _cfgs()[1], slots=4, max_len=32, scheduler=name,
                          device="cpu")
        stats[name.split(":")[0]] = _drive_and_stats(eng, prompts)
    fcfs, tb = stats["fcfs"], stats["token_budget"]
    for i in (1, 2, 3, 4):
        assert tb.requests[i].ttft_work < fcfs.requests[i].ttft_work, i
    assert tb.percentile("ttft_work", 95) <= fcfs.percentile("ttft_work", 95)
    assert tb.total_tokens == fcfs.total_tokens


def _port_engine(**kw):
    _, params = _params()
    return ServeEngine(params, _cfgs()[1], max_len=32, device="cpu", **kw)


class TestLifecycle:
    def test_cancel_mid_decode_frees_slot_for_queued_request(self):
        eng = _port_engine(slots=1)
        hog = eng.submit(np.arange(5, dtype=np.int32), 50)
        waiter = eng.submit(np.arange(4, dtype=np.int32), 3)
        eng.step()
        eng.step()
        assert hog.state == DECODING and waiter.state == QUEUED
        hog.cancel()
        eng.run()
        assert hog.state == CANCELLED and hog.done
        assert len(hog.out) < 50 and hog.finished is not None
        assert waiter.state == DONE and len(waiter.out) == 3

    def test_cancel_while_queued_never_takes_a_slot(self):
        eng = _port_engine(slots=1)
        a = eng.submit(np.arange(4, dtype=np.int32), 2)
        b = eng.submit(np.arange(4, dtype=np.int32), 2)
        b.cancel()
        eng.run()
        assert a.state == DONE and b.state == CANCELLED and not b.out
        st = {r.uid: r for r in eng.stats().requests}
        assert st[b.uid].ttft_s is None and st[b.uid].e2e_s is not None

    def test_cancel_while_prefilling_frees_the_slot(self):
        eng = _port_engine(slots=1, scheduler="token_budget:budget=4")
        a = eng.submit(np.arange(12, dtype=np.int32), 3)
        b = eng.submit(np.arange(4, dtype=np.int32), 2)
        eng.step()
        assert a.state == PREFILLING
        a.cancel()
        eng.run()
        assert a.state == CANCELLED and not a.out
        assert b.state == DONE and len(b.out) == 2

    def test_legacy_done_writer_frees_slot(self):
        eng = _port_engine(slots=1)
        a = eng.submit(np.arange(4, dtype=np.int32), 50)
        b = eng.submit(np.arange(4, dtype=np.int32), 2)
        eng.step()
        a.done = True
        eng.run()
        assert a.state == DONE and a.finished is not None and len(a.out) < 50
        assert b.state == DONE and len(b.out) == 2

    @pytest.mark.parametrize("scheduler", ["fcfs", "token_budget:budget=2"])
    def test_on_token_streams_every_token_in_order(self, scheduler):
        eng = _port_engine(slots=1, scheduler=scheduler)
        seen = []
        r = eng.submit(np.arange(5, dtype=np.int32), 4,
                       on_token=lambda req, tok: seen.append((req.uid, tok)))
        eng.run()
        assert seen == [(r.uid, t) for t in r.out] and len(seen) == 4

    def test_uid_auto_assignment_and_duplicate_rejection(self):
        eng = _port_engine(slots=1)
        a = eng.submit(np.arange(3, dtype=np.int32), 1)
        b = eng.submit(np.arange(3, dtype=np.int32), 1)
        assert a.uid != b.uid and a.uid is not None
        with pytest.raises(ValueError, match="duplicate request uid"):
            eng.submit(np.arange(3, dtype=np.int32), 1, uid=a.uid)
        c = eng.submit(np.arange(3, dtype=np.int32), 1, uid=99)
        d = eng.submit(np.arange(3, dtype=np.int32), 1)
        assert c.uid == 99 and d.uid == 100
        assert len({r.uid for r in eng.requests}) == len(eng.requests)

    def test_prebuilt_request_and_positional_constructor(self):
        eng = _port_engine(slots=1)
        legacy = Request(7, np.arange(4, dtype=np.int32), 2)
        assert (legacy.uid, legacy.max_new, legacy.done) == (7, 2, False)
        assert eng.submit(legacy) is legacy
        eng.run()
        assert legacy.done and legacy.uid == 7 and len(legacy.out) == 2

    def test_injected_clock_stamps_ttft(self):
        fake = iter(np.arange(0.0, 100.0, 0.5))
        eng = _port_engine(slots=2, clock=lambda: float(next(fake)))
        _submit_schedule(eng, forced=False)
        eng.run()
        st = eng.stats()
        for r in st.requests:
            assert r.state == DONE and r.ttft_s > 0 and r.e2e_s >= r.ttft_s
        assert st.summary()["tokens"] == st.total_tokens == 12


class TestRegistry:
    def test_registry_ships_the_three_policies(self):
        assert sched_lib.schedulers() == ("fcfs", "sjf", "token_budget", "prefix_cache")
        assert sched_lib.schedulers() == ref_sched.schedulers()
        with pytest.raises(ValueError, match="unknown scheduler"):
            sched_lib.make_scheduler("round_robin_nope")
        with pytest.raises(ValueError, match="bad scheduler arg"):
            sched_lib.make_scheduler("token_budget:budget")
        with pytest.raises(ValueError, match="budget >= 1"):
            sched_lib.make_scheduler("token_budget:budget=0")

    def test_make_scheduler_parses_cli_kwargs(self):
        s = sched_lib.make_scheduler("token_budget:budget=16")
        assert isinstance(s, sched_lib.TokenBudgetScheduler)
        assert s.budget == 16 and s.describe() == "token_budget:budget=16"
        inst = sched_lib.FCFSScheduler()
        assert sched_lib.make_scheduler(inst) is inst
        assert isinstance(sched_lib.make_scheduler(None), sched_lib.FCFSScheduler)
        assert isinstance(sched_lib.make_scheduler(sched_lib.SJFScheduler),
                          sched_lib.SJFScheduler)

    def test_new_scheduler_registers_in_25_lines(self):
        class LIFOScheduler(FCFSScheduler):
            name = "lifo_test"

            def _ordered_queue(self, view):
                return list(reversed(view.queue))

        assert len(inspect.getsource(LIFOScheduler).splitlines()) <= 25
        try:
            sched_lib.register_scheduler(LIFOScheduler)
            eng = _port_engine(slots=1, scheduler="lifo_test")
            a = eng.submit(np.arange(4, dtype=np.int32), 2)
            b = eng.submit(np.arange(5, dtype=np.int32), 2)
            eng.run()
            assert a.done and b.done
            assert b.first_token.step < a.first_token.step
        finally:
            sched_lib.SCHEDULERS.pop("lifo_test", None)

    def test_sjf_orders_refills_by_prompt_length(self):
        eng = _port_engine(slots=1, scheduler="sjf")
        long = eng.submit(np.arange(12, dtype=np.int32), 2)
        short = eng.submit(np.arange(3, dtype=np.int32), 2)
        eng.run()
        assert short.first_token.step < long.first_token.step

    def test_plan_validation_rejects_occupied_slots_and_unqueued_requests(self):
        class BadScheduler(FCFSScheduler):
            name = "bad_test"

            def plan(self, view):
                return StepPlan(refills=((0, view.queue[0], view.queue[0].prompt_len),))

        eng = _port_engine(slots=1, scheduler=BadScheduler())
        eng.submit(np.arange(3, dtype=np.int32), 5)
        eng.submit(np.arange(3, dtype=np.int32), 5)
        eng.step()
        with pytest.raises(ValueError, match="occupied slot"):
            eng.step()

        class Stranger(FCFSScheduler):
            name = "stranger_test"

            def plan(self, view):
                req = Request(5, np.arange(3, dtype=np.int32), 1)
                return StepPlan(refills=((0, req, 3),))

        eng = _port_engine(slots=1, scheduler=Stranger())
        eng.submit(np.arange(3, dtype=np.int32), 1)
        with pytest.raises(ValueError, match="unqueued request"):
            eng.step()

    def test_engine_view_carries_the_new_fields(self):
        eng = _port_engine(slots=2)
        eng.step_index = 3
        view = eng._view()
        assert (view.chunking_ok, view.max_len, view.step_index) == (True, 32, 3)
        assert StepPlan().is_empty and not StepPlan(chunks=((0, 1),)).is_empty
        assert sched_lib.STATES == ref_sched.STATES


#: test_scheduler.py's simulate trace: (arrival_s, prompt_len, max_new)
SIM_TRACE = [(0.0, 64, 8), (0.0, 4, 8), (0.0, 6, 8), (0.0, 5, 8), (0.0, 4, 8), (5.0, 6, 8)]


@pytest.mark.parametrize("scheduler", ["fcfs", "sjf", "token_budget:budget=8"])
def test_simulate_equals_reference_field_for_field(scheduler):
    got = sched_lib.simulate(scheduler, SIM_TRACE, slots=4, t_call=0.1, t_token=0.5)
    want = ref_sched.simulate(scheduler, SIM_TRACE, slots=4, t_call=0.1, t_token=0.5)
    want_fields = dataclasses.asdict(want)
    for field, value in dataclasses.asdict(got).items():
        assert value == want_fields.pop(field), field
    assert want_fields == {}  # ``pages`` too: None off the paged formats
    assert got.summary() == want.summary()


def test_simulate_ranks_schedulers_like_the_reference():
    out = {name: sched_lib.simulate(name, SIM_TRACE, slots=4, t_call=0.1, t_token=0.5)
           for name in ("fcfs", "sjf", "token_budget:budget=8")}
    assert {s.total_tokens for s in out.values()} == {6 * 8}
    assert out["token_budget:budget=8"].percentile("ttft_s", 95) < \
        out["fcfs"].percentile("ttft_s", 95)
    assert out["sjf"].percentile("ttft_s", 50) <= out["fcfs"].percentile("ttft_s", 50)


def test_chunked_prefill_outputs_match_whole_prompt():
    """Chunking is scheduling only: the same greedy tokens as one
    whole-prompt prefill, on the port alone."""
    outs = {}
    for name in ("fcfs", "token_budget:budget=6"):
        eng = _port_engine(slots=2, scheduler=name)
        rng = np.random.default_rng(1)
        reqs = [eng.submit(rng.integers(0, VOCAB, size=(n,)).astype(np.int32), 3)
                for n in (18, 4)]
        eng.run()
        outs[name] = [r.out for r in reqs]
        if name != "fcfs":
            assert eng.stats().requests[0].ttft_steps >= 2
    assert outs["fcfs"] == outs["token_budget:budget=6"]
