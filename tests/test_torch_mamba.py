"""The Mamba-1 mixer (falcon-mamba-7b) and jamba's hybrid layout in the port
against the JAX reference.

falcon-mamba-7b's smoke config (2 layers, d_inner 128, d_state 4, dt_rank
4): the reference's three ``TestMamba`` checks as twins on the port
(chunk invariance, prefill then decode against one pass, a split with the
state carried); ``mamba_apply`` and ``mamba_decode`` against the
reference's on the weights carried across, in float32 and at bf16; the
``ssm_a`` / ``ssm_dt`` initializers against the reference's formulas; and
the config served by both engines under ``fcfs`` and ``token_budget``,
which falls back to whole prompts (a Mamba state would absorb pad tokens,
so SSM configs refill one slot at a time and never chunk).
jamba-1.5-large-398b's smoke config (8 layers, one superblock: attention
at slot 4, Mamba elsewhere, MoE on odd slots) is served the same way after
``params_from_numpy`` unstacks its 8 slots.  Planted faults (``D``
dropped, the conv tail not carried, a refill batched with pads) fail the
limits.  ``D`` and ``conv_b`` are drawn away from their ones / zeros so
that a dropped term would show.  At the smoke widths ``x_proj`` (128 × 12)
is narrower than ``min_dim=16`` and stays float in both packages; the
chip run converts it (falcon-mamba-7b's 8192 × 288).  The port runs on
the CPU, where every kernel wrapper takes its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import mamba as ref_mamba
from repro.serve import engine as ref_engine
from repro.serve.scheduler import DECODING as REF_DECODING
from repro.sharding import partitioning as P
from repro_torch import configs, convert
from repro_torch.core import residency
from repro_torch.kernels import ops
from repro_torch.models import mamba
from repro_torch.models import model as model_lib
from repro_torch.serve import engine
from repro_torch.serve.scheduler import DECODING

from test_torch_mla import (STACK_IDS, STACKS, VOCAB, cfgs, max_rel_err, port_params,
                            ref_params, schedule)
from test_torch_serve import LOGIT_RTOL

ARCH = "falcon-mamba-7b"
HYBRID = "jamba-1.5-large-398b"
#: the reference's chunk-invariance tolerances (tests/test_models.py)
RTOL, ATOL = 1e-4, 1e-5


_PARAMS: dict = {}


def _ssm_params(arch=ARCH, dtype="float32"):
    """The reference's seeded parameters (``test_torch_mla.ref_params``) with
    each Mamba layer's ``D`` drawn around 1 and ``conv_b`` around 0."""
    key = arch, dtype
    if key not in _PARAMS:
        rng = np.random.default_rng(8)

        def leaf(path, a):
            a = np.asarray(a)
            if path[-1].key == "D":
                return jnp.asarray((1.0 + rng.normal(0.0, 0.3, a.shape)).astype(a.dtype))
            if path[-1].key == "conv_b":
                return jnp.asarray(rng.normal(0.0, 0.2, a.shape).astype(a.dtype))
            return jnp.asarray(a)

        _PARAMS[key] = jax.tree_util.tree_map_with_path(leaf, ref_params(arch, dtype))
    return _PARAMS[key]


def _mixers(dtype="float32", weights="bf16"):
    """Layer 0's Mamba mixer in both packages, the projections in ``weights``."""
    cfg_ref, cfg = cfgs(ARCH, dtype, vocab_size=VOCAB)
    rp = _ssm_params(dtype=dtype)
    ref_mix = jax.tree_util.tree_map(lambda a: a[0], rp["stack"]["slot0"])["mixer"]
    mix = port_params(ARCH, dtype, rp)["layers"][0]["mixer"]
    return (ref_engine.convert_params(ref_mix, cfg_ref, weights, min_dim=16),
            engine.convert_params(mix, cfg, weights, min_dim=16))


def _x(shape, dtype="float32", seed=0):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape), getattr(jnp, dtype))
    return x, torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# The reference's TestMamba, as twins on the port
# ---------------------------------------------------------------------------


def _setup():
    cfg = configs.get_smoke_config(ARCH)
    ref_cfg = ref_smoke_config(ARCH)
    params = P.materialize(ref_mamba.mamba_specs(ref_cfg), jax.random.PRNGKey(0))
    params = {k: convert._tensor(v, "cpu") for k, v in params.items()}
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 37, cfg.d_model))
                         .astype(np.float32))
    return cfg, params, x


def test_chunk_invariance():
    cfg, params, x = _setup()
    outs = [mamba.mamba_apply(params, x, cfg, chunk=c) for c in (1, 8, 16, 37, 64)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0].numpy(), o.numpy(), rtol=RTOL, atol=ATOL)


def test_prefill_then_decode_matches_full():
    cfg, params, x = _setup()
    full = mamba.mamba_apply(params, x, cfg, chunk=8)
    out_p, state = mamba.mamba_apply(params, x[:, :30], cfg, chunk=8, return_state=True)
    np.testing.assert_allclose(full[:, :30].numpy(), out_p.numpy(), rtol=RTOL, atol=ATOL)
    for t in range(30, 37):
        y, state = mamba.mamba_decode(params, x[:, t:t + 1], state, cfg)
        np.testing.assert_allclose(full[:, t].numpy(), y[:, 0].numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=f"step {t}")


def test_state_continuity_split():
    """Two halves with the state carried == one pass; ``init_mamba_state``
    is the zero state a prompt starts from."""
    cfg, params, x = _setup()
    full = mamba.mamba_apply(params, x, cfg, chunk=16)
    zero = mamba.init_mamba_state(cfg, 2, "cpu")
    assert zero["conv"].shape == (2, cfg.d_conv - 1, cfg.d_inner)
    assert zero["ssm"].shape == (2, cfg.d_inner, cfg.d_state)
    assert torch.equal(mamba.mamba_apply(params, x, cfg, chunk=16, state=zero), full)
    o1, st = mamba.mamba_apply(params, x[:, :20], cfg, chunk=16, return_state=True)
    o2, _ = mamba.mamba_apply(params, x[:, 20:], cfg, chunk=16, state=st, return_state=True)
    np.testing.assert_allclose(full.numpy(), torch.cat([o1, o2], 1).numpy(), rtol=RTOL,
                               atol=ATOL)


def test_log_depth_scan_equals_the_sequential_recurrence():
    """``_scan`` over 64 steps against the step-by-step recurrence h_t =
    a_t·h_{t-1} + b_t (float64: the two orders agree to rounding)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, size=(2, 64, 5, 3)))
    b = torch.from_numpy(rng.normal(size=(2, 64, 5, 3)))
    pa, pb = mamba._scan(a, b)
    h, prod = torch.zeros(2, 5, 3, dtype=torch.float64), torch.ones(2, 5, 3, dtype=torch.float64)
    for t in range(64):
        h, prod = a[:, t] * h + b[:, t], prod * a[:, t]
        torch.testing.assert_close(pb[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(pa[:, t], prod, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# Against the reference on the weights carried across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["bf16", "w8a8", "w8a16"])
def test_mamba_apply_and_decode_match_reference(weights):
    """A 37-step prefill (chunk 64, and chunk 8 with a padded last chunk)
    and 5 decode steps from its state, projections float or converted: the
    outputs and both state parts within the chunk-invariance tolerances of
    the reference's."""
    cfg_ref, cfg = cfgs(ARCH, vocab_size=VOCAB)
    ref_mix, mix = _mixers(weights=weights)
    if weights != "bf16":
        assert isinstance(mix["in_proj"], residency.QuantLinearState)
        assert mix["in_proj"].mode == ref_mix["in_proj"].mode == weights
    x, xt = _x((2, 37, cfg.d_model))
    for chunk in (64, 8):
        want, ref_state = ref_mamba.mamba_apply(ref_mix, x, cfg_ref, chunk=chunk,
                                                return_state=True)
        got, state = mamba.mamba_apply(mix, xt, cfg, chunk=chunk, return_state=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        for part in ("conv", "ssm"):
            assert state[part].dtype == torch.float32
            np.testing.assert_allclose(state[part].numpy(), np.asarray(ref_state[part]),
                                       rtol=RTOL, atol=ATOL)
    for t in range(5):
        x, xt = _x((2, 1, cfg.d_model), seed=t + 1)
        want, ref_state = ref_mamba.mamba_decode(ref_mix, x, ref_state, cfg_ref)
        got, state = mamba.mamba_decode(mix, xt, state, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(state["ssm"].numpy(), np.asarray(ref_state["ssm"]), rtol=RTOL,
                               atol=ATOL)


#: the Mamba block at bf16 on identical inputs, max |Δ| / max |ref|: the
#: packages cast to bf16 at the same points and differ by float32 summation
#: order (the log-depth scan's, the conv's, the products'), which can move
#: a bf16 rounding of the gated output (measured 2.8e-8 at most): one bf16
#: step of the largest
MAMBA_BF16_RTOL = 2.0 ** -8


def test_mamba_at_bf16():
    """The bf16 Mamba block, projections float and ``w8a16`` (path A's), a
    37-step prefill and 3 decode steps."""
    cfg_ref, cfg = cfgs(ARCH, "bfloat16", vocab_size=VOCAB)
    for weights in ("bf16", "w8a16"):
        ref_mix, mix = _mixers("bfloat16", weights)
        x, xt = _x((2, 37, cfg.d_model), "bfloat16")
        want, ref_state = ref_mamba.mamba_apply(ref_mix, x, cfg_ref, return_state=True)
        got, state = mamba.mamba_apply(mix, xt, cfg, return_state=True)
        pairs = [(want, got)]
        for t in range(3):
            x, xt = _x((2, 1, cfg.d_model), "bfloat16", seed=t + 1)
            want, ref_state = ref_mamba.mamba_decode(ref_mix, x, ref_state, cfg_ref)
            got, state = mamba.mamba_decode(mix, xt, state, cfg)
            pairs.append((want, got))
        for i, (want, got) in enumerate(pairs):
            want, got = np.asarray(want, np.float64), got.double().numpy()
            assert np.abs(got - want).max() <= MAMBA_BF16_RTOL * np.abs(want).max(), (weights, i)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def test_ssm_initializers_follow_the_reference():
    """``ssm_a`` is the reference's log(1..n) over channels, to one float32
    ulp (the port rounds log(n) once from float64; XLA's float32 log is one
    ulp off for one n of 1..16);
    ``ssm_dt`` is the softplus-inverse of U[1e-3, 1e-1] (softplus of it
    recovers the uniform draw); and ``draw`` gives every Mamba layer these,
    not random normals."""
    shape = (64, 16)
    want = np.asarray(P._INITIALIZERS["ssm_a"](
        jax.random.PRNGKey(0), P.ParamSpec(shape, jnp.float32, (None, None), "ssm_a")))
    got = model_lib._init(model_lib.ParamSpec(shape, torch.float32, "ssm_a"),
                          torch.Generator().manual_seed(0), "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -23, atol=0)
    dt = model_lib._init(model_lib.ParamSpec((100_000,), torch.float32, "ssm_dt"),
                         torch.Generator().manual_seed(0), "cpu")
    ref_dt = np.asarray(P._INITIALIZERS["ssm_dt"](
        jax.random.PRNGKey(0), P.ParamSpec((100_000,), jnp.float32, (None,), "ssm_dt")))
    for u in (torch.nn.functional.softplus(dt).numpy(), np.logaddexp(ref_dt, 0.0)):
        assert 1e-3 - 1e-6 <= u.min() and u.max() <= 1e-1 + 1e-6
        assert abs(u.mean() - 0.0505) < 1e-3 and abs(u.std() - 0.099 / 12 ** 0.5) < 1e-3
    cfg = configs.get_smoke_config(ARCH)
    params = model_lib.materialize(cfg, seed=0, device="cpu")
    for layer in params["layers"]:
        assert set(layer) == {"ln1", "mixer"}  # no ln2, no ffn
        mix = layer["mixer"]
        np.testing.assert_allclose(
            mix["A_log"].numpy(), np.broadcast_to(want[0, :cfg.d_state], mix["A_log"].shape),
            rtol=2.0 ** -23, atol=0)
        u = torch.nn.functional.softplus(mix["dt_b"])
        assert bool(((u >= 1e-3 - 1e-6) & (u <= 1e-1 + 1e-6)).all())
        assert torch.equal(mix["D"], torch.ones(cfg.d_inner))


# ---------------------------------------------------------------------------
# Serves
# ---------------------------------------------------------------------------

_SERVES: dict = {}


def reference_serve(arch, stack, sched):
    key = arch, stack, sched
    if key not in _SERVES:
        ref = ref_engine.ServeEngine(_ssm_params(arch), cfgs(arch, vocab_size=VOCAB)[0],
                                     slots=2, max_len=32, mode=stack[0],
                                     cache_format=stack[1], scheduler=sched, min_dim=16,
                                     trace_logits=True)
        _SERVES[key] = ref, schedule(ref)
    return _SERVES[key]


def port_serve(arch, stack, sched, params=None):
    eng = engine.ServeEngine(port_params(arch, params=_ssm_params(arch)) if params is None
                             else params, cfgs(arch, vocab_size=VOCAB)[1], slots=2,
                             max_len=32, mode=stack[0], cache_format=stack[1],
                             scheduler=sched, min_dim=16, trace_logits=True, device="cpu")
    return eng, schedule(eng)


SERVES = [(stack, sched) for stack in STACKS for sched in ("fcfs", "token_budget:budget=2")]
SERVE_IDS = [f"{i}-{s.split(':')[0]}" for i in STACK_IDS for s in ("fcfs", "token_budget")]


@pytest.mark.parametrize("stack, sched", SERVES, ids=SERVE_IDS)
@pytest.mark.parametrize("arch", [ARCH, HYBRID])
def test_serve_matches_reference(arch, stack, sched):
    """falcon-mamba-7b and jamba-1.5-large-398b served greedy by both
    engines, float32: the same trace and tokens, logits within LOGIT_RTOL of
    the largest, each refill a prefill of one slot (no pads), the Mamba
    projections in the reference's formats; no kernel launched on the CPU."""
    ref, ref_reqs = reference_serve(arch, stack, sched)
    eng, reqs = port_serve(arch, stack, sched)
    assert not eng._pad_ok and not ref._pad_ok
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert max_rel_err(ref, eng) < LOGIT_RTOL
    assert all(len(s) == 1 for k, s, _ in eng.logit_trace if k == "prefill")
    cfg = eng.cfg
    for i, layer in enumerate(eng.params["layers"]):
        if cfg.mixer_kind(i) == "mamba":
            j = i % cfg.block_period
            ref_mix = ref.params["stack"][f"slot{j}"]["mixer"]
            for name in ("in_proj", "out_proj"):
                assert layer["mixer"][name].mode == ref_mix[name].mode, (i, name)
            assert set(eng.caches[i]) == {"conv", "ssm"}
            assert eng.caches[i]["ssm"].shape == (2, cfg.d_inner, cfg.d_state)
        else:
            assert "pos_ids" in eng.caches[i]
    assert all(v == 0 for v in ops.launch_counts().values())


def test_hybrid_layout_and_unstacking():
    """jamba's 8 reference slots become layers 0-7: attention at layer 4,
    Mamba elsewhere, MoE on odd layers and a dense FFN on even ones, each
    leaf the reference's ``stack.slot{j}[0]``."""
    cfg = cfgs(HYBRID, vocab_size=VOCAB)[1]
    rp = jax.tree_util.tree_map(np.asarray, _ssm_params(HYBRID))
    params = port_params(HYBRID, params=_ssm_params(HYBRID))
    assert len(params["layers"]) == 8 and set(rp["stack"]) == {f"slot{j}" for j in range(8)}
    for i, layer in enumerate(params["layers"]):
        assert cfg.mixer_kind(i) == ("attn" if i == 4 else "mamba")
        assert cfg.ffn_kind(i) == ("moe" if i % 2 else "dense")
        assert ("wq" in layer["mixer"]) == (i == 4)
        assert ("router" in layer["ffn"]) == (i % 2 == 1)
        ref_layer = rp["stack"][f"slot{i}"]
        for part in ("mixer", "ffn"):
            for name, w in layer[part].items():
                np.testing.assert_array_equal(w.numpy(), ref_layer[part][name][0])


def test_token_budget_falls_back_to_whole_prompts():
    """Twin of the reference's ``test_ssm_hybrid_falls_back_to_whole_prompt``:
    on an SSM config ``token_budget:budget=2`` refills the whole 8-token
    prompt in its first step, in both packages."""
    cfg_ref, cfg = cfgs(ARCH, vocab_size=VOCAB)
    got = []
    for eng, decoding in (
            (engine.ServeEngine(port_params(ARCH), cfg, slots=1, max_len=16,
                                scheduler="token_budget:budget=2", device="cpu"), DECODING),
            (ref_engine.ServeEngine(ref_params(ARCH), cfg_ref, slots=1, max_len=16,
                                    scheduler="token_budget:budget=2"), REF_DECODING)):
        assert not eng._pad_ok
        r = eng.submit(np.arange(8, dtype=np.int32), 4)
        eng.step()
        assert r.prefilled == 8 and r.state == decoding and len(r.out) >= 1
        eng.run()
        assert r.done
        got.append(r.out)
    assert got[0] == got[1]


def _drop_d(params, monkeypatch):
    for layer in params["layers"]:
        if "D" in layer["mixer"]:
            layer["mixer"]["D"] = torch.zeros_like(layer["mixer"]["D"])


def _conv_tail_dropped(params, monkeypatch):
    conv = mamba._causal_conv
    monkeypatch.setattr(mamba, "_causal_conv",
                        lambda p, x_in, conv_state=None: conv(p, x_in, None))


def _refill_with_pads(params, monkeypatch):
    """Refills microbatched with left pads, as for an attention-only config."""
    init = engine.ServeEngine.__init__

    def padded(self, *a, **k):
        init(self, *a, **k)
        self._pad_ok = True

    monkeypatch.setattr(engine.ServeEngine, "__init__", padded)


#: faults planted in the port alone, falcon-mamba-7b on path B's stack under
#: fcfs (max |Δ logit| / max |logit|): D dropped 0.26, the conv tail not
#: carried 0.24, refills batched with left pads 0.21; the faultless serve
#: 2.4e-7
FAULTS = {"D_dropped": _drop_d, "conv_tail_dropped": _conv_tail_dropped,
          "refill_batched_with_pads": _refill_with_pads}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_the_limit(fault, monkeypatch):
    ref, _ = reference_serve(ARCH, STACKS[1], "fcfs")
    params = port_params(ARCH, params=_ssm_params(ARCH))
    FAULTS[fault](params, monkeypatch)
    eng, _ = port_serve(ARCH, STACKS[1], "fcfs", params=params)
    assert max_rel_err(ref, eng) > LOGIT_RTOL
