"""Sliding-window attention (mixtral-8x7b) in the port against the JAX reference.

mixtral-8x7b's smoke config (window 32, 4 experts top 2): the ring length
``min(window, max_len)``; the windowed prefill mask of
``chunked_attention`` and the window term of the decode mask, function by
function under every cache format (with a ring longer than the window, so
that the decode term is the one that drops the old keys); the same at bf16
on identical inputs; and the config served end to end by both engines,
greedy, with prompts longer than the window and decode past the ring's
wrap, under ``fcfs`` and the chunking ``token_budget`` (whose chunk rows
past position 32 write the window-long ring before they attend, and so lose
keys their earlier tokens would see, as in the reference), on path A's
stack (the fused cache's additive bias carries the window) and path B's.
A planted fault, the window dropped from the prefill mask, fails the limit.
The port runs on the CPU, where every kernel wrapper takes its plain
version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro.models import stack as ref_stack
from repro.serve import engine as ref_engine
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.models import model as model_lib
from repro_torch.serve import engine

from test_torch_mla import (CACHES, STACK_IDS, STACKS, VOCAB, cfgs, max_rel_err, port_params,
                            ref_params)
from test_torch_serve import LOGIT_RTOL

ARCH = "mixtral-8x7b"
WINDOW = 32
#: the serves' horizon: the ring is min(WINDOW, MAX_LEN) = 32 long
MAX_LEN = 64


def schedule(eng, forced=False):
    """Three requests on two slots: prompts of 40 and 45 tokens (longer than
    the window and the ring) and one of 12 that finishes early, so the
    45-token prompt refills its slot while the first decodes past position
    40; greedy, or teacher-forced with ``forced``."""
    rng = np.random.default_rng(1)
    reqs = []
    for n, mn in zip((40, 12, 45), (12, 4, 8)):
        prompt = rng.integers(0, VOCAB, size=(n,)).astype(np.int32)
        force = rng.integers(0, VOCAB, size=(mn,)).astype(np.int32)
        reqs.append(eng.submit(prompt, mn, force=force if forced else None))
    eng.run()
    return reqs


_SERVES: dict = {}


def reference_serve(stack, sched):
    key = stack, sched
    if key not in _SERVES:
        ref = ref_engine.ServeEngine(ref_params(ARCH), cfgs(ARCH, vocab_size=VOCAB)[0],
                                     slots=2, max_len=MAX_LEN, mode=stack[0],
                                     cache_format=stack[1], scheduler=sched, min_dim=16,
                                     trace_logits=True)
        _SERVES[key] = ref, schedule(ref)
    return _SERVES[key]


def port_serve(stack, sched, params=None):
    eng = engine.ServeEngine(port_params(ARCH) if params is None else params,
                             cfgs(ARCH, vocab_size=VOCAB)[1], slots=2, max_len=MAX_LEN,
                             mode=stack[0], cache_format=stack[1], scheduler=sched,
                             min_dim=16, trace_logits=True, device="cpu")
    return eng, schedule(eng)


def test_config_and_ring_length():
    """The window is the reference's; the ring is min(window, max_len) long
    in both packages, and ``model.prefill`` allocates it so."""
    cfg_ref, cfg = cfgs(ARCH, vocab_size=VOCAB)
    assert cfg.sliding_window == cfg_ref.sliding_window == WINDOW
    for max_len in (16, 32, 64, 200):
        assert attention.cache_len_for(cfg, max_len) == ref_stack._cache_len_for(
            cfg_ref, max_len) == min(WINDOW, max_len)
    no_window = dataclasses.replace(cfg, sliding_window=None)
    assert attention.cache_len_for(no_window, 200) == 200
    tokens = torch.zeros((1, 40), dtype=torch.long)
    for max_len, ring in ((16, 16), (MAX_LEN, WINDOW)):
        _, caches = model_lib.prefill(port_params(ARCH), {"tokens": tokens}, cfg,
                                      max_len=max_len)
        assert all(c["pos_ids"].shape == (1, ring) for c in caches)
        # a 40-token prompt keeps its last `ring` positions
        assert sorted(caches[0]["pos_ids"][0].tolist()) == list(range(40 - ring, 40))


# ---------------------------------------------------------------------------
# The windowed masks on identical inputs
# ---------------------------------------------------------------------------


def _mixers(dtype="float32"):
    rp = ref_params(ARCH, dtype)
    ref_mix = jax.tree_util.tree_map(lambda a: a[0], rp["stack"]["slot0"])["mixer"]
    return ref_mix, port_params(ARCH, dtype)["layers"][0]["mixer"]


def test_windowed_chunked_attention_matches_reference():
    """``chunked_attention`` with the window against the reference's, 80
    positions (one row left-padded by 5) and windows 1, 7 and 32; without
    the window it differs."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 80, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 80, 2, 16)).astype(np.float32) for _ in range(2))
    pos = np.stack([np.arange(80), np.arange(80) - 5]).astype(np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, pos)]
    for window in (1, 7, WINDOW):
        want = np.asarray(ref_attention.chunked_attention(
            *map(jnp.asarray, (q, k, v)), q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
            window=window))
        got = attention.chunked_attention(*t[:3], q_pos=t[3], kv_pos=t[3], window=window)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    unwindowed = attention.chunked_attention(*t[:3], q_pos=t[3], kv_pos=t[3])
    assert np.abs(unwindowed.numpy() - want).max() > 1e-2


def _run_gqa(cache, dtype="float32", *, ring=48, prompt=40, steps=12):
    """Prefill a left-padded pair of 40-token prompts into a ring longer
    than the window, then one-token decode steps past its wrap (one row idle
    every third step): the outputs of both packages step by step, and the
    final pos_ids."""
    cfg_ref, cfg = (dataclasses.replace(c, cache_format=cache)
                    for c in cfgs(ARCH, dtype, vocab_size=VOCAB))
    ref_mix, mix = _mixers(dtype)
    rng = np.random.default_rng(11)
    pos = np.stack([np.arange(prompt), np.arange(prompt) - 3]).astype(np.int32)

    def inputs(shape):
        x = jnp.asarray(rng.normal(size=shape), getattr(jnp, dtype))
        return x, torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))

    x, xt = inputs((2, prompt, cfg.d_model))
    want, ref_cache = ref_attention.gqa_prefill(ref_mix, x, cfg_ref, tp=1, cache_len=ring,
                                                positions=jnp.asarray(pos))
    got, cache_t = attention.gqa_prefill(mix, xt, cfg, cache_len=ring,
                                         positions=torch.from_numpy(pos))
    outs = [(np.asarray(want, np.float64), got.double().numpy())]
    nxt = pos[:, -1] + 1
    for step in range(steps):
        p = nxt.copy()
        if step % 3 == 2:
            p[1] = -1
        x, xt = inputs((2, 1, cfg.d_model))
        want, ref_cache = ref_attention.gqa_decode(ref_mix, x, ref_cache, cfg_ref, tp=1,
                                                   pos=jnp.asarray(p))
        got, cache_t = attention.gqa_decode(mix, xt, cache_t, cfg, pos=torch.from_numpy(p))
        outs.append((np.asarray(want, np.float64), got.double().numpy()))
        nxt = np.where(p >= 0, p + 1, nxt)
    np.testing.assert_array_equal(cache_t["pos_ids"].numpy(), np.asarray(ref_cache["pos_ids"]))
    return outs


#: windowed prefill and decode outputs, max |Δ| / max |ref| a step: float32
#: rounding only (measured 5.2e-7 at most); 1e-4 as the serves' limit
SWA_RTOL = 1e-4


@pytest.mark.parametrize("cache", CACHES)
def test_windowed_prefill_and_decode_match_reference(cache, monkeypatch):
    """GQA with the window over a 48-slot ring (longer than the window, so
    the decode mask's window term drops the keys 32 positions back): each
    output within SWA_RTOL of the reference's under every cache format (the
    fused format takes the window through its additive bias), the same
    pos_ids in the ring; with the decode term dropped the outputs move."""
    for i, (want, got) in enumerate(_run_gqa(cache)):
        assert np.abs(got - want).max() <= SWA_RTOL * np.abs(want).max(), (i, cache)
    decode_attention = attention._decode_attention
    monkeypatch.setattr(attention, "_decode_attention",
                        lambda *a, window=None, **k: decode_attention(*a, **k))
    worst = max(np.abs(got - want).max() / np.abs(want).max()
                for want, got in _run_gqa(cache)[1:])
    assert worst > 1e-2


#: bf16 windowed attention layer, port against reference on identical bf16
#: inputs: max |Δ| / max |ref| a step.  Both packages cast q, k, v to bf16 at
#: the same points and measured bit-identical here; one bf16 step of the
#: largest leaves room for a float32 sum in another order that moves one
#: bf16 rounding.
BF16_RTOL = 2.0 ** -8


@pytest.mark.parametrize("cache", ["bf16", "int4_bp_fused"])
def test_windowed_attention_at_bf16(cache):
    for i, (want, got) in enumerate(_run_gqa(cache, "bfloat16", steps=6)):
        assert np.abs(got - want).max() <= BF16_RTOL * np.abs(want).max(), (i, cache)


# ---------------------------------------------------------------------------
# Serves
# ---------------------------------------------------------------------------

#: (stack, scheduler): each stack under fcfs and under token_budget, whose
#: chunk rows of up to 8 tokens run past position 32
SERVES = [(stack, sched) for stack in STACKS for sched in ("fcfs", "token_budget:budget=8")]
SERVE_IDS = [f"{i}-{s.split(':')[0]}" for i in STACK_IDS for s in ("fcfs", "token_budget")]


@pytest.mark.parametrize("stack, sched", SERVES, ids=SERVE_IDS)
def test_serve_matches_reference(stack, sched):
    """mixtral-8x7b served greedy by both engines, float32, prompts longer
    than the window, decode past the ring's wrap: the same trace and tokens,
    logits within LOGIT_RTOL of the largest, each slot's ring holding the
    same positions as the reference's, every one of them among the slot's
    last 32; no kernel launched on the CPU."""
    ref, ref_reqs = reference_serve(stack, sched)
    eng, reqs = port_serve(stack, sched)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert max_rel_err(ref, eng) < LOGIT_RTOL
    if sched != "fcfs":
        assert any(k == "prefill" and len(s) == 1 for k, s, _ in eng.logit_trace)
    ref_pos = np.asarray(ref.caches["stack"]["slot0"]["pos_ids"])  # [layers, slots, L]
    for i, layer in enumerate(eng.caches):
        pos_ids = layer["pos_ids"].numpy()
        assert pos_ids.shape == (2, WINDOW)
        np.testing.assert_array_equal(pos_ids, ref_pos[i])
        for slot in range(2):
            live = pos_ids[slot][pos_ids[slot] >= 0]
            assert live.max() - live.min() < WINDOW and len(set(live)) == len(live)
    assert all(v == 0 for v in ops.launch_counts().values())


def test_dropped_prefill_window_fails_the_limit(monkeypatch):
    """The planted fault: ``chunked_attention`` ignoring the window, so a
    prompt's last tokens see keys more than 32 positions back (measured
    1.90 of the largest logit; the faultless serve 2.8e-7)."""
    ref, _ = reference_serve(*SERVES[2])
    chunked = attention.chunked_attention
    monkeypatch.setattr(attention, "chunked_attention",
                        lambda *a, window=None, **k: chunked(*a, **k))
    eng, _ = port_serve(*SERVES[2])
    assert max_rel_err(ref, eng) > LOGIT_RTOL
