"""MLA (multi-head latent attention) in the port against the JAX reference.

minicpm3-4b's smoke config (low-rank q, kv_lora 32, nope 16, rope 8, v 16)
and deepseek-v2-lite-16b's full-rank q: the prefill form and the absorbed
decode, function by function on seeded inputs, under every cache format
and with the projections in float, ``w8a8`` and path A's stack; each
format's ``to_float`` (what the absorbed decode reads ``w_uk`` / ``w_uv``
through); and minicpm3-4b served end to end by both engines, greedy, under
``fcfs`` and the chunking ``token_budget``, in float32 and bf16.  At the
smoke widths every MLA projection is at least 32 wide, so ``min_dim=16``
converts all of them.  The port runs on the CPU, where every kernel wrapper
takes its plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import residency as ref_residency
from repro.models import attention as ref_attention
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.sharding import partitioning as P
from repro_torch import configs, convert
from repro_torch.core import residency
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.serve import engine

from test_torch_serve import LOGIT_RTOL

ARCH = "minicpm3-4b"
VOCAB = 128
#: the cache formats: the reference's four
CACHES = ["bf16", "int8", "int4_bp", "int4_bp_fused"]
#: the MLA projections' residency: float, path B's and path A's stacks
WEIGHTS = ["bf16", "w8a8", "ffn=bsdp_fused,mixer=w8a16"]
#: the two engine stacks (path A's, path B's)
STACKS = [("ffn=bsdp_fused,mixer=w8a16", "int4_bp_fused"), ("w8a8", "bf16")]
STACK_IDS = ["A", "B"]


def cfgs(arch=ARCH, dtype="float32", **over):
    """(reference config, port config) of ``arch``'s smoke config."""
    return (ref_smoke_config(arch).scaled(dtype=getattr(jnp, dtype), **over),
            configs.get_smoke_config(arch).scaled(dtype=getattr(torch, dtype), **over))


_PARAMS: dict = {}


def ref_params(arch=ARCH, dtype="float32"):
    """The reference's own seeded parameters (vocab 128), with every norm
    scale drawn around 1 (seeded) so that a dropped norm would show."""
    key = arch, dtype
    if key not in _PARAMS:
        params = P.materialize(ref_model.specs(cfgs(arch, dtype, vocab_size=VOCAB)[0], 1),
                               jax.random.PRNGKey(0))
        rng = np.random.default_rng(7)

        def leaf(path, a):
            a = np.asarray(a)
            if path[-1].key in ("scale", "q_norm", "kv_norm"):
                return jnp.asarray((1.0 + rng.normal(0.0, 0.3, a.shape)).astype(a.dtype))
            return jnp.asarray(a)

        _PARAMS[key] = jax.tree_util.tree_map_with_path(leaf, params)
    return _PARAMS[key]


def port_params(arch=ARCH, dtype="float32", params=None):
    params = ref_params(arch, dtype) if params is None else params
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                     cfgs(arch, dtype, vocab_size=VOCAB)[1], "cpu")


def schedule(eng, forced=False, vocab=VOCAB):
    """Three requests on two slots (the third refills the slot the second
    frees while the first decodes), greedy, or teacher-forced with
    ``forced``."""
    rng = np.random.default_rng(0)
    reqs = []
    for n, mn in zip((5, 3, 7), (6, 2, 4)):
        prompt = rng.integers(0, vocab, size=(n,)).astype(np.int32)
        force = rng.integers(0, vocab, size=(mn,)).astype(np.int32)
        reqs.append(eng.submit(prompt, mn, force=force if forced else None))
    eng.run()
    return reqs


_SERVES: dict = {}


def reference_serve(arch, stack, sched, dtype="float32"):
    """The reference engine's serve, once per test process: greedy in
    float32, teacher-forced in bf16."""
    key = arch, stack, sched, dtype
    if key not in _SERVES:
        ref = ref_engine.ServeEngine(ref_params(arch, dtype),
                                     cfgs(arch, dtype, vocab_size=VOCAB)[0], slots=2,
                                     max_len=32, mode=stack[0], cache_format=stack[1],
                                     scheduler=sched, min_dim=16, trace_logits=True)
        _SERVES[key] = ref, schedule(ref, forced=dtype != "float32")
    return _SERVES[key]


def port_serve(arch, stack, sched, dtype="float32", params=None):
    eng = engine.ServeEngine(port_params(arch, dtype) if params is None else params,
                             cfgs(arch, dtype, vocab_size=VOCAB)[1], slots=2, max_len=32,
                             mode=stack[0], cache_format=stack[1], scheduler=sched,
                             min_dim=16, trace_logits=True, device="cpu")
    return eng, schedule(eng, forced=dtype != "float32")


def max_rel_err(ref, eng) -> float:
    """max |Δ logit| / max |logit| over the two engines' logit traces, which
    must have the same structure."""
    assert [(k, s) for k, s, _ in ref.logit_trace] == [(k, s) for k, s, _ in eng.logit_trace]
    return max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                     / np.abs(np.asarray(a, np.float64)).max())
               for (_, _, a), (_, _, b) in zip(ref.logit_trace, eng.logit_trace))


def bf16_errors(ref, eng):
    """(max |Δ logit| / max |logit|, min cosine) over the logit traces."""
    max_rel, min_cos = 0.0, 1.0
    for (_, _, a), (_, _, b) in zip(ref.logit_trace, eng.logit_trace):
        a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
        assert np.isfinite(b).all()
        max_rel = max(max_rel, np.abs(a - b).max() / np.abs(a).max())
        min_cos = min(min_cos, a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return max_rel, min_cos


# ---------------------------------------------------------------------------
# to_float: every format, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bf16", "w8a16", "w8a8", "w4a8", "w4a4_bsdp", "bsdp",
                                  "bsdp_fused"])
def test_to_float_matches_reference_bit_exact(mode):
    """Each format's dequantized matrix, odd K included (int4 pads one row,
    the planes a part word), equals the reference's bit for bit, and every
    format supports the absorbed decode."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(37, 48)) * 0.2).astype(np.float32)
    want = np.asarray(ref_residency.get_format(mode).to_float(
        ref_residency.from_float(jnp.asarray(w), mode)))
    got = residency.get_format(mode).to_float(residency.from_float(torch.from_numpy(w), mode))
    assert got.dtype == torch.float32 and got.shape == (37, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    assert residency.get_format(mode).supports_absorbed_decode


# ---------------------------------------------------------------------------
# The MLA functions on identical inputs
# ---------------------------------------------------------------------------


def _mixers(arch, weights):
    """Layer 0's MLA parameters in both packages under ``weights``."""
    rp = ref_params(arch)
    ref_mix = (rp["prefix"]["layer0"] if "prefix" in rp else
               jax.tree_util.tree_map(lambda a: a[0], rp["stack"]["slot0"]))["mixer"]
    cfg_ref, cfg = cfgs(arch, vocab_size=VOCAB)
    port_mix = port_params(arch)["layers"][0]["mixer"]
    return (ref_engine.convert_params(ref_mix, cfg_ref, weights, min_dim=16),
            engine.convert_params(port_mix, cfg, weights, min_dim=16))


def _run_mla(arch, weights, cache, *, prompt, steps, cache_len=8):
    """Prefill a left-padded pair of prompts, then ``steps`` one-token
    decode steps (one row idle at -1 every third step): the outputs of
    both packages, step by step, and the final caches' pos_ids."""
    cfg_ref, cfg = (dataclasses.replace(c, cache_format=cache) for c in cfgs(arch))
    ref_mix, mix = _mixers(arch, weights)
    rng = np.random.default_rng(11)
    d = cfg.d_model
    pos = np.stack([np.arange(prompt), np.arange(prompt) - 2]).astype(np.int32)
    x = rng.normal(size=(2, prompt, d)).astype(np.float32)
    want, ref_cache = ref_attention.mla_apply(ref_mix, jnp.asarray(x), cfg_ref,
                                              positions=jnp.asarray(pos),
                                              cache_len=cache_len)
    got, cache_t = attention.mla_prefill(mix, torch.from_numpy(x), cfg, cache_len=cache_len,
                                         positions=torch.from_numpy(pos))
    outs = [(np.asarray(want), got.numpy())]
    nxt = pos[:, -1] + 1
    for step in range(steps):
        p = nxt.copy()
        if step % 3 == 2:
            p[1] = -1  # an idle row: a pad, dropped from the write
        xt = rng.normal(size=(2, 1, d)).astype(np.float32)
        want, ref_cache = ref_attention.mla_decode(ref_mix, jnp.asarray(xt), ref_cache,
                                                   cfg_ref, pos=jnp.asarray(p))
        got, cache_t = attention.mla_decode(mix, torch.from_numpy(xt), cache_t, cfg,
                                            pos=torch.from_numpy(p))
        outs.append((np.asarray(want), got.numpy()))
        nxt = np.where(p >= 0, p + 1, nxt)
    np.testing.assert_array_equal(cache_t["pos_ids"].numpy(), np.asarray(ref_cache["pos_ids"]))
    return outs


#: prefill and decode outputs, max |Δ| / max |ref| per step: float32
#: rounding only (measured below 1e-6); 1e-4 as the serves' limit
MLA_RTOL = 1e-4


@pytest.mark.parametrize("cache, weights", [(c, "bf16") for c in CACHES] + [
    ("int4_bp_fused", w) for w in WEIGHTS[1:]], ids=[f"{c}-float" for c in CACHES] + [
    "int4_bp_fused-w8a8", "int4_bp_fused-A"])
def test_mla_prefill_and_absorbed_decode_match_reference(cache, weights):
    """minicpm3-4b's MLA: a 5-token prefill (one row left-padded by 2) into
    an 8-slot ring, then 7 decode steps, past the ring's wraparound, with an
    idle row every third step; each output within MLA_RTOL of the
    reference's, and the same pos_ids in the ring."""
    for i, (want, got) in enumerate(_run_mla(ARCH, weights, cache, prompt=5, steps=7)):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= MLA_RTOL * np.abs(want).max(), (i, cache, weights)


def test_mla_full_rank_q_and_a_prompt_longer_than_the_ring():
    """deepseek-v2-lite-16b's full-rank ``wq`` under path A's stack and the
    int8 cache, with a 10-token prompt written into the 8-slot ring (each
    row's last 8 positions kept)."""
    for i, (want, got) in enumerate(_run_mla("deepseek-v2-lite-16b",
                                             "ffn=bsdp_fused,mixer=w8a16", "int8",
                                             prompt=10, steps=4)):
        if i == 0:
            continue  # the prefill reads the whole prompt; the ring holds the last 8
        assert np.abs(got - want).max() <= MLA_RTOL * np.abs(want).max(), i


def test_absorbed_decode_refuses_a_format_that_cannot_dequantize(monkeypatch):
    fmt = residency.get_format("w8a8")
    monkeypatch.setattr(fmt, "supports_absorbed_decode", False)
    _, mix = _mixers(ARCH, "w8a8")
    with pytest.raises(NotImplementedError, match="absorbed MLA decode"):
        attention._as_float(mix["w_uk"], (32, 4, 16), torch.float32)


# ---------------------------------------------------------------------------
# Serves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", ["fcfs", "token_budget:budget=2"])
@pytest.mark.parametrize("stack", STACKS, ids=STACK_IDS)
def test_serve_matches_reference(stack, sched):
    """minicpm3-4b served greedy by both engines, float32: the same trace,
    the same tokens, logits within LOGIT_RTOL of the largest; every MLA
    projection in the reference's format; no kernel launched on the CPU."""
    ref, ref_reqs = reference_serve(ARCH, stack, sched)
    eng, reqs = port_serve(ARCH, stack, sched)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert max_rel_err(ref, eng) < LOGIT_RTOL
    mixer, ref_mixer = eng.params["layers"][1]["mixer"], ref.params["stack"]["slot0"]["mixer"]
    for name in ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "wo"):
        assert isinstance(mixer[name], residency.QuantLinearState), name
        assert mixer[name].mode == ref_mixer[name].mode
    assert all(v == 0 for v in ops.launch_counts().values())


#: bf16 serves, port against reference, teacher-forced: (max |Δ logit| /
#: max |logit|, min cosine) by (arch, stack).  The two packages round to bf16
#: at different points, and on path A's stack every rounding difference is
#: re-quantized to int4, so the limits follow each config's own bf16 noise,
#: which the reference shows against its own float32 serve of the same
#: schedule: minicpm3-4b A 0.344 / 0.965 (port against reference measured
#: 0.327 / 0.967), B 0.057 / 0.9988 (measured 0.026 / 0.9998);
#: deepseek-v2-lite-16b B 0.33 / 0.947, where the router flips an expert
#: near a tie (measured 0.054 / 0.9989).  deepseek-v2-lite-16b on path A's
#: stack reads 0.98 / 0.40 against its own float32, which no limit can
#: use: tests/test_torch_moe.py holds its layers at bf16 on identical inputs
#: instead.  The limits sit above the measured readings and below the
#: planted faults' (the readings beside FAULTS; deepseek-v2-lite-16b's
#: dropped shared expert 0.388 / 0.816).
BF16_LIMITS = {("minicpm3-4b", "A"): (0.5, 0.95), ("minicpm3-4b", "B"): (5e-2, 0.999),
               ("deepseek-v2-lite-16b", "B"): (0.15, 0.995)}


@pytest.mark.parametrize("stack", STACKS, ids=STACK_IDS)
def test_bf16_serve_matches_reference(stack):
    """The configs' working type: both engines in bf16 under ``fcfs``,
    within BF16_LIMITS.  Teacher-forced, as the qwen3-1.7b bf16 serves are:
    a rounding difference can flip a greedy choice, after which the two
    traces hold other tokens."""
    max_rel, min_cos = BF16_LIMITS[ARCH, STACK_IDS[STACKS.index(stack)]]
    ref, ref_reqs = reference_serve(ARCH, stack, "fcfs", "bfloat16")
    eng, reqs = port_serve(ARCH, stack, "fcfs", "bfloat16")
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    got_rel, got_cos = bf16_errors(ref, eng)
    assert got_rel < max_rel and got_cos > min_cos, (got_rel, got_cos)


def _drop_kv_norm(params):
    for layer in params["layers"]:
        layer["mixer"]["kv_norm"] = torch.ones_like(layer["mixer"]["kv_norm"])


def _rope_on_nope(params, monkeypatch):
    """The planted fault: rope applied to the whole query head."""
    mla_q = attention._mla_q

    def wrong(p, x, cfg, positions, impl=None, tp=None):
        q_nope, q_rope = mla_q(p, x, cfg, positions, impl, tp)
        from repro_torch.models import layers
        return layers.apply_rope(q_nope, positions, cfg.rope_theta), q_rope

    monkeypatch.setattr(attention, "_mla_q", wrong)


#: faults planted in the port alone; their readings on path B's stack
#: (max |Δ logit| / max |logit|, greedy, float32): the latent's norm scale
#: dropped 1.59, rope on the no-rope query part 1.39; the faultless serve
#: 4e-7.  In bf16 (max_rel, min cos), path A / path B: 0.514, 0.887 /
#: 0.381, 0.937 and 0.559, 0.891 / 0.461, 0.923; faultless 0.327, 0.967 /
#: 0.026, 0.9998.
FAULTS = {"kv_norm_dropped": lambda p, mp: _drop_kv_norm(p), "rope_on_nope": _rope_on_nope}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_the_limit(fault, monkeypatch):
    ref, _ = reference_serve(ARCH, STACKS[1], "fcfs")
    params = port_params()
    FAULTS[fault](params, monkeypatch)
    eng, _ = port_serve(ARCH, STACKS[1], "fcfs", params=params)
    assert max_rel_err(ref, eng) > LOGIT_RTOL


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("stack", STACKS, ids=STACK_IDS)
def test_bf16_limits_fail_planted_faults(stack, fault, monkeypatch):
    """Each planted fault breaks one of the bf16 limits."""
    max_rel, min_cos = BF16_LIMITS[ARCH, STACK_IDS[STACKS.index(stack)]]
    ref, _ = reference_serve(ARCH, stack, "fcfs", "bfloat16")
    params = port_params(dtype="bfloat16")
    FAULTS[fault](params, monkeypatch)
    eng, _ = port_serve(ARCH, stack, "fcfs", "bfloat16", params=params)
    got_rel, got_cos = bf16_errors(ref, eng)
    assert got_rel >= max_rel or got_cos <= min_cos, (got_rel, got_cos)
