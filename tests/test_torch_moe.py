"""The sort-dispatch MoE in the port against the JAX reference.

deepseek-v2-lite-16b's smoke config (8 experts, top 2, one shared expert,
layer 0 dense): ``moe_apply``, ``moe_apply_einsum`` and ``moe_ref`` on
identical seeded inputs, with capacity drops and with drops that pad tokens
cause; every weight format's stacked apply (one grouped launch on the card)
against its per-expert loop and the reference's ``vmap``; the MoE layer at
bf16 on identical inputs under path A's formats; and the config served end
to end by both engines at the real capacity factor 1.25 (the smoke config's
8.0 never drops), where left-padded prefill rows and idle decode rows route
their pads and take capacity.  At the smoke widths every expert and shared
projection is 32 wide or more, so ``min_dim=16`` converts all of them.  The
port runs on the CPU, where every kernel wrapper takes its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import residency as ref_residency
from repro.models import moe as ref_moe
from repro.serve import engine as ref_engine
from repro_torch.core import residency
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.serve import engine

from test_torch_mla import (BF16_LIMITS, LOGIT_RTOL, STACK_IDS, STACKS, VOCAB, bf16_errors,
                            cfgs, max_rel_err, port_params, ref_params, schedule)

ARCH = "deepseek-v2-lite-16b"
#: the real config's capacity factor, at which the smoke serves drop tokens
CF = 1.25
#: MoE outputs, port against reference, max |Δ| / max |ref|: float32
#: rounding of the router's softmax and the expert matmuls (measured below
#: 5e-7); a wrong drop or a lost expert moves an output by its whole size
MOE_RTOL = 1e-5


def _cfgs(dtype="float32", cf=CF):
    return cfgs(ARCH, dtype, vocab_size=VOCAB, capacity_factor=cf)


#: the reference's functions compiled once (their eager dispatch of many
#: small ops is slower than the compile), the config and capacity static
REF_MOE = {name: jax.jit(getattr(ref_moe, name), static_argnums=(2,),
                         static_argnames=("capacity_factor",))
           for name in ("moe_apply", "moe_apply_einsum")}
REF_MOE["moe_ref"] = jax.jit(ref_moe.moe_ref, static_argnums=(2,))


def _ffn_params(dtype="float32"):
    """Layer 1's MoE parameters (float) in both packages."""
    rp = ref_params(ARCH, dtype)
    ref_ffn = jax.tree_util.tree_map(lambda a: a[0], rp["stack"]["slot0"])["ffn"]
    return ref_ffn, port_params(ARCH, dtype)["layers"][1]["ffn"]


def _both(fn_ref, fn, x, cfg_ref, cfg, **kw):
    want, want_aux = fn_ref(jnp.asarray(x), cfg_ref, **kw)
    got, got_aux = fn(torch.from_numpy(x), cfg, **kw)
    return np.asarray(want, np.float64), got.double().numpy(), float(want_aux), float(got_aux)


def _close(got, want, tol=MOE_RTOL):
    return np.abs(got - want).max() <= tol * np.abs(want).max()


def _kept(x, cfg, capacity_factor):
    """Per (row, token) the number of its k choices that found room."""
    params = _ffn_params()[1]
    idx, _, _ = moe._route(params, torch.from_numpy(x), cfg)
    b, s, k = idx.shape
    eid = idx.reshape(b, s * k)
    order = torch.argsort(eid, dim=1, stable=True)
    kept = torch.zeros(b, s * k, dtype=torch.int64)
    cap = moe.capacity(cfg, s, capacity_factor)
    for r in range(b):
        fill = {}
        for p in order[r].tolist():
            e = int(eid[r, p])
            fill[e] = fill.get(e, 0) + 1
            kept[r, p] = int(fill[e] <= cap)
    return kept.reshape(b, s, k).sum(-1).numpy()


@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["ample", "drops"])
@pytest.mark.parametrize("fn", ["moe_apply", "moe_apply_einsum"])
def test_dispatch_matches_reference(fn, cf):
    """Both dispatches equal the reference's, with ample capacity (then
    also the dense ``moe_ref``) and at capacity factor 1.0, where slots are
    dropped; the aux loss too."""
    ref_ffn, ffn = _ffn_params()
    cfg_ref, cfg = _cfgs()
    x = np.random.default_rng(21).normal(size=(3, 12, cfg.d_model)).astype(np.float32)
    want, got, want_aux, got_aux = _both(
        lambda a, c, **kw: REF_MOE[fn](ref_ffn, a, c, **kw),
        lambda a, c, **kw: getattr(moe, fn)(ffn, a, c, **kw), x, cfg_ref, cfg,
        capacity_factor=cf)
    assert _close(got, want) and abs(got_aux - want_aux) <= 1e-6 * abs(want_aux)
    dense, _ = moe.moe_ref(ffn, torch.from_numpy(x), cfg)
    dense_ref, _ = REF_MOE["moe_ref"](ref_ffn, jnp.asarray(x), cfg_ref)
    assert _close(dense.double().numpy(), np.asarray(dense_ref, np.float64))
    dropped = (_kept(x, cfg, cf) < cfg.experts_per_tok).sum()
    if cf == 8.0:
        assert dropped == 0 and _close(got, dense.double().numpy())
    else:
        assert dropped > 0 and not _close(got, dense.double().numpy(), 1e-2)


def test_pad_tokens_take_capacity_and_drop_a_real_token():
    """A row led by 5 copies of one pad vector, then a real token routed to
    the same experts: with capacity 3 the pads fill both experts and the
    real token is dropped by both packages alike (its output is then the
    shared expert's alone); without the pads it is not."""
    ref_ffn, ffn = _ffn_params()
    cfg_ref, cfg = _cfgs()
    rng = np.random.default_rng(22)
    pad = rng.normal(size=cfg.d_model).astype(np.float32)
    real = pad + 1e-3 * rng.normal(size=cfg.d_model).astype(np.float32)
    others = rng.normal(size=(6, cfg.d_model)).astype(np.float32)
    padded = np.concatenate([np.tile(pad, (5, 1)), real[None], others])[None]
    alone = np.concatenate([real[None], others, np.tile(pad, (5, 1))])[None]
    # S = 12, k = 2, E = 8, cf = 1.0: cap = 3
    kw = dict(capacity_factor=1.0)
    assert moe.capacity(cfg, 12, 1.0) == 3
    for x, real_at, kept in ((padded, 5, 0), (alone, 0, 2)):
        want, got, _, _ = _both(lambda a, c, **k: REF_MOE["moe_apply"](ref_ffn, a, c, **k),
                                lambda a, c, **k: moe.moe_apply(ffn, a, c, **k), x,
                                cfg_ref, cfg, **kw)
        assert _close(got, want)
        assert _kept(x, cfg, 1.0)[0, real_at] == kept
    shared = moe._shared(ffn, torch.from_numpy(padded), cfg)[0, 5].double().numpy()
    got = moe.moe_apply(ffn, torch.from_numpy(padded), cfg, **kw)[0][0, 5].double().numpy()
    np.testing.assert_allclose(got, shared, rtol=0, atol=1e-6 * np.abs(shared).max())


def _lifo_order(monkeypatch):
    """The planted fault: slots of one expert in reverse token order (a
    sort that is not stable), so capacity keeps the last tokens."""
    argsort = torch.argsort

    def lifo(t, dim=-1, stable=False):
        n = t.shape[dim]
        rev = torch.arange(n - 1, -1, -1, device=t.device)
        return argsort(t * n + rev, dim=dim, stable=True)

    monkeypatch.setattr(moe.torch, "argsort", lifo)


def test_non_stable_dispatch_order_fails_the_limit(monkeypatch):
    ref_ffn, ffn = _ffn_params()
    cfg_ref, cfg = _cfgs()
    x = np.random.default_rng(21).normal(size=(3, 12, cfg.d_model)).astype(np.float32)
    _lifo_order(monkeypatch)
    want, got, _, _ = _both(lambda a, c, **k: REF_MOE["moe_apply"](ref_ffn, a, c, **k),
                            lambda a, c, **k: moe.moe_apply(ffn, a, c, **k), x,
                            cfg_ref, cfg, capacity_factor=1.0)
    assert not _close(got, want, 1e-2)


# ---------------------------------------------------------------------------
# Stacked (expert) states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("mode", ["w8a16", "w8a8", "w4a8", "w4a4_bsdp", "bsdp", "bsdp_fused"])
def test_stacked_apply_matches_per_expert_loop_and_reference(mode, m):
    """A stacked ``[E, K, N]`` weight converts to one state, ``data [E, ...]``
    and ``scale [E, 1, N]``, bit-identical to converting each expert alone;
    its apply (the grouped launch's path) equals the per-expert loop bit for
    bit and the reference's ``vmap`` of ``apply`` bit for bit where the
    format quantizes the activations (w8a16: float32 summation order,
    within 1e-6 of the largest output)."""
    rng = np.random.default_rng(23)
    w = (rng.normal(size=(5, 64, 48)) * 0.2).astype(np.float32)
    x = rng.normal(size=(5, m, 64)).astype(np.float32)
    state = residency.from_float(torch.from_numpy(w), mode)
    assert state.data.shape[0] == 5 and state.scale.shape == (5, 1, 48)
    for e in range(5):
        one = residency.from_float(torch.from_numpy(w[e]), mode)
        assert torch.equal(state.expert(e).data, one.data)
        assert torch.equal(state.expert(e).scale, one.scale)
    got = residency.apply_stacked(state, torch.from_numpy(x))
    loop = torch.stack([residency.apply(state.expert(e), torch.from_numpy(x[e]))
                        for e in range(5)])
    assert torch.equal(got, loop)
    plain = residency.get_format(mode).apply_stacked_plain(state, torch.from_numpy(x))
    assert torch.equal(plain, loop)
    ref_state = ref_engine._convert_leaf(jnp.asarray(w), mode, 16)
    want = np.asarray(jax.vmap(ref_residency.apply)(ref_state, jnp.asarray(x)))
    if mode == "w8a16":
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_expert_leaves_convert_and_other_ranks_raise():
    """Under every quantizing format the stacked expert leaves convert (no
    silent float pass-through); a quantizable leaf of another rank raises."""
    cfg = _cfgs()[1]
    convert = engine.leaf_converter(residency.ResidencySpec.parse("ffn=bsdp_fused"), 16)
    w = torch.zeros((cfg.n_experts, cfg.d_model, 2 * cfg.moe_d_ff))
    got = convert(("layers", "1", "ffn", "w_in"), w)
    assert isinstance(got, residency.QuantLinearState)
    assert got.scale.shape == (cfg.n_experts, 1, 2 * cfg.moe_d_ff)
    with pytest.raises(ValueError, match="4-D"):
        convert(("layers", "1", "ffn", "w_in"), w[None])


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
def test_moe_layer_at_bf16(mode):
    """The MoE layer at bf16 on identical inputs (6 tokens a row, drops at
    capacity factor 1.25), experts float or ``w8a8``: the same routing and
    gates to the bit, the output within two bf16 steps (2^-6) of the
    largest (measured one step, 2^-7: the packages round the SwiGLU's
    product at other points).  ``bsdp_fused`` re-quantizes that step to
    int4 and is held in float32 above."""
    ref_ffn, ffn = _ffn_params("bfloat16")
    cfg_ref, cfg = _cfgs("bfloat16")
    ref_ffn = ref_engine.convert_params(ref_ffn, cfg_ref, mode, min_dim=16)
    ffn = engine.convert_params(ffn, cfg, mode, min_dim=16)
    x = jnp.asarray(np.random.default_rng(24).normal(size=(4, 6, cfg.d_model)), jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    for got, want in zip(moe._route(ffn, xt, cfg)[:2], ref_moe._route(ref_ffn, x, cfg_ref)[:2]):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    want = np.asarray(REF_MOE["moe_apply"](ref_ffn, x, cfg_ref)[0], np.float64)
    got = moe.moe_apply(ffn, xt, cfg)[0].double().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()


# ---------------------------------------------------------------------------
# Serves
# ---------------------------------------------------------------------------

_SERVES: dict = {}


def _reference_serve(stack, sched, dtype="float32", cf=CF):
    key = stack, sched, dtype, cf
    if key not in _SERVES:
        ref = ref_engine.ServeEngine(ref_params(ARCH, dtype), _cfgs(dtype, cf)[0], slots=2,
                                     max_len=32, mode=stack[0], cache_format=stack[1],
                                     scheduler=sched, min_dim=16, trace_logits=True)
        _SERVES[key] = ref, schedule(ref, forced=dtype != "float32")
    return _SERVES[key]


def _port_serve(stack, sched, dtype="float32", params=None, cf=CF):
    eng = engine.ServeEngine(port_params(ARCH, dtype) if params is None else params,
                             _cfgs(dtype, cf)[1], slots=2, max_len=32, mode=stack[0],
                             cache_format=stack[1], scheduler=sched, min_dim=16,
                             trace_logits=True, device="cpu")
    return eng, schedule(eng, forced=dtype != "float32")


#: (stack, scheduler) of the float32 serves: path A's stack under fcfs,
#: path B's under the chunking token_budget
SERVES = [(STACKS[0], "fcfs"), (STACKS[1], "token_budget:budget=2")]


@pytest.mark.parametrize("stack, sched", SERVES, ids=["A-fcfs", "B-token_budget"])
def test_serve_matches_reference(stack, sched):
    """deepseek-v2-lite-16b served greedy by both engines at capacity
    factor 1.25, float32: the same trace and tokens, logits within
    LOGIT_RTOL of the largest; the dense layer 0, the routed experts
    (stacked) and the shared expert in the reference's formats."""
    ref, ref_reqs = _reference_serve(stack, sched)
    eng, reqs = _port_serve(stack, sched)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert max_rel_err(ref, eng) < LOGIT_RTOL
    ref_layers = [ref.params["prefix"]["layer0"], ref.params["stack"]["slot0"]]
    for layer, ref_layer in zip(eng.params["layers"][:2], ref_layers):
        for name, w in layer["ffn"].items():
            if name == "router":
                assert w.dtype == torch.float32
                continue
            assert w.mode == ref_layer["ffn"][name].mode, name
            if name in ("w_in", "w_out"):
                assert (w.scale.ndim == 3) == (ref_layer is ref_layers[1])
    assert all(v == 0 for v in ops.launch_counts().values())


def test_bf16_serve_matches_reference():
    """Both engines in bf16 on path B's stack, teacher-forced, within
    ``BF16_LIMITS`` (tests/test_torch_mla.py gives the reasons, and why path
    A's stack is held layer by layer instead), at the smoke config's own
    capacity factor 8.0: at 1.25 one bf16 rounding difference in the
    router's input moves which tokens a full expert keeps (measured 0.33 /
    0.945, as far as the reference's own bf16 serve is from its float32
    one)."""
    max_rel, min_cos = BF16_LIMITS[ARCH, "B"]
    ref, ref_reqs = _reference_serve(STACKS[1], "fcfs", "bfloat16", cf=8.0)
    eng, reqs = _port_serve(STACKS[1], "fcfs", "bfloat16", cf=8.0)
    got_rel, got_cos = bf16_errors(ref, eng)
    assert got_rel < max_rel and got_cos > min_cos, (got_rel, got_cos)


def _drop_shared(params, monkeypatch):
    for layer in params["layers"][1:]:
        layer["ffn"]["shared_w_out"] = torch.zeros_like(layer["ffn"]["shared_w_out"])


#: faults planted in the port alone, against the B token_budget serve:
#: (max |Δ logit| / max |logit|, greedy) the shared expert dropped 1.76,
#: the LIFO dispatch order 1.68; the faultless serve 3e-7
FAULTS = {"shared_expert_dropped": _drop_shared,
          "non_stable_dispatch": lambda p, mp: _lifo_order(mp)}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_the_limit(fault, monkeypatch):
    ref, _ = _reference_serve(*SERVES[1])
    params = port_params(ARCH)
    FAULTS[fault](params, monkeypatch)
    eng, _ = _port_serve(*SERVES[1], params=params)
    assert max_rel_err(ref, eng) > LOGIT_RTOL


def test_bf16_limit_fails_a_dropped_shared_expert(monkeypatch):
    max_rel, min_cos = BF16_LIMITS[ARCH, "B"]
    ref, _ = _reference_serve(STACKS[1], "fcfs", "bfloat16", cf=8.0)
    params = port_params(ARCH, "bfloat16")
    _drop_shared(params, monkeypatch)
    eng, _ = _port_serve(STACKS[1], "fcfs", "bfloat16", params=params, cf=8.0)
    got_rel, got_cos = bf16_errors(ref, eng)
    assert got_rel >= max_rel or got_cos <= min_cos, (got_rel, got_cos)
