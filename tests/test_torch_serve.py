"""The port's serving slices against the JAX reference engine.

Same float weights (the reference's own, brought across with
``repro_torch.convert.params_from_numpy``), the same residency stack and
the teacher-forced schedule of ``tests/test_serve_bsdp.py``: slots=2, three
requests, one of which finishes early so its slot is re-prefilled while
decode continues.  The stacks: ``ffn=bsdp_fused,mixer=w8a16`` with the
``int4_bp_fused`` cache (the first slice), and the three of
:data:`SERVE_CONFIGS` — the reference launcher's default ``w8a8`` with the
config's ``bf16`` cache, ``ffn=bsdp,mixer=w4a8`` with ``int4_bp``, and
``w4a4_bsdp`` with ``int4_bp_fused``.  The port runs on the CPU, where every
kernel wrapper takes its plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import kvcache as ref_kvcache
from repro.core import residency as ref_residency
from repro.models import attention as ref_attention
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.sharding import partitioning as P
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import kvcache, residency
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention
from repro_torch.models import model as model_lib
from repro_torch.serve import engine

VOCAB = 128
MODE = "ffn=bsdp_fused,mixer=w8a16"
CACHE = "int4_bp_fused"
#: (weight residency, decode cache) of the further serving paths
SERVE_CONFIGS = [("w8a8", "bf16"), ("ffn=bsdp,mixer=w4a8", "int4_bp"),
                 ("w4a4_bsdp", "int4_bp_fused")]

# Logit tolerance, relative to the largest |logit| of the vector.  Integer
# payloads and BSDP sums are bit-identical between the two packages; the
# float parts (matmul summation order, exp/rsqrt/sin/cos, softmax) differ
# by float32 rounding: at most 7e-7 of the largest logit on this schedule.
# 1e-4 leaves room for a rounding difference that moves one activation
# across an int4 rounding boundary (one quantization step of one element,
# diluted through the layers) and still fails any semantic difference
# (a wrong scale, sign or mask moves logits by more than 1e-2).
LOGIT_RTOL = 1e-4


def _cfgs(dtype="float32"):
    ref_cfg = ref_smoke_config("qwen3-1.7b").scaled(
        n_layers=2, vocab_size=VOCAB, dtype=getattr(jnp, dtype))
    cfg = get_smoke_config("qwen3-1.7b").scaled(
        n_layers=2, vocab_size=VOCAB, dtype=getattr(torch, dtype))
    return ref_cfg, cfg


def _schedule(eng):
    rng = np.random.default_rng(0)
    lens, max_news = (5, 3, 7), (6, 2, 4)
    reqs = [
        eng.submit(rng.integers(0, VOCAB, size=(n,)).astype(np.int32), mn,
                   force=rng.integers(0, VOCAB, size=(mn,)).astype(np.int32))
        for n, mn in zip(lens, max_news)
    ]
    eng.run()
    return reqs


def _ref_params(dtype="float32"):
    return P.materialize(ref_model.specs(_cfgs(dtype)[0], 1), jax.random.PRNGKey(0))


def _port_params(ref_params, dtype="float32"):
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), _cfgs(dtype)[1], "cpu")


def _serve_ref(mode, cache, dtype="float32"):
    ref_params = _ref_params(dtype)
    ref = ref_engine.ServeEngine(ref_params, _cfgs(dtype)[0], slots=2, max_len=32,
                                 mode=mode, cache_format=cache, min_dim=16,
                                 trace_logits=True)
    return ref_params, ref, _schedule(ref)


def _serve_port(ref_params, mode, cache, dtype="float32", fault=None):
    """The port's serve on the reference's weights; ``fault(params)``, if
    given, edits the converted float weights first."""
    params = _port_params(ref_params, dtype)
    if fault is not None:
        fault(params)
    eng = engine.ServeEngine(params, _cfgs(dtype)[1], slots=2, max_len=32, mode=mode,
                             cache_format=cache, min_dim=16, trace_logits=True,
                             device="cpu")
    return eng, _schedule(eng)


def _serve_both(mode, cache, dtype="float32"):
    ref_params, ref, ref_reqs = _serve_ref(mode, cache, dtype)
    eng, reqs = _serve_port(ref_params, mode, cache, dtype)
    return ref, ref_reqs, eng, reqs


def _assert_same_trace_and_tokens(ref, ref_reqs, eng, reqs):
    kinds = [(k, s) for k, s, _ in ref.logit_trace]
    assert kinds == [(k, s) for k, s, _ in eng.logit_trace]
    assert sum(1 for k, _ in kinds if k == "prefill") == 3
    first_decode = kinds.index(("decode", (0, 1)))
    assert any(k == "prefill" for k, _ in kinds[first_decode + 1:])
    for a, b in zip(ref_reqs, reqs):
        assert a.out == b.out and a.done and b.done


def _assert_logits_close(ref, eng):
    for (_, _, lr), (_, _, lp) in zip(ref.logit_trace, eng.logit_trace):
        lr, lp = np.asarray(lr, np.float32), np.asarray(lp, np.float32)
        assert lr.shape == lp.shape
        err = np.abs(lr - lp).max() / (np.abs(lr).max() + 1e-6)
        assert err < LOGIT_RTOL, err


@pytest.fixture(scope="module")
def engines():
    return _serve_both(MODE, CACHE)


@pytest.fixture(scope="module", params=SERVE_CONFIGS, ids=lambda c: f"{c[0]}+{c[1]}")
def config_engines(request):
    return request.param, _serve_both(*request.param)


class TestServeSliceMatchesReference:
    def test_trace_structure_and_tokens_identical(self, engines):
        _assert_same_trace_and_tokens(*engines)

    def test_logits_within_tolerance(self, engines):
        ref, _, eng, _ = engines
        _assert_logits_close(ref, eng)

    def test_weights_converted_to_the_slice_formats(self, engines):
        _, _, eng, _ = engines
        layer = eng.params["layers"][0]
        assert layer["ffn"]["w_in"].mode == "bsdp_fused"
        assert layer["ffn"]["w_out"].mode == "bsdp_fused"
        for name in ("wq", "wk", "wv", "wo"):
            assert layer["mixer"][name].mode == "w8a16"
        assert eng.cache_format == CACHE
        assert engine.resident_bytes(eng.params) < engine.resident_bytes(
            model_lib.materialize(_cfgs()[1], device="cpu"))

    def test_cpu_run_launched_no_kernel(self, engines):
        # CPU tensors take the plain versions: nothing was launched
        assert all(v == 0 for v in ops.launch_counts().values())


class TestServeConfigsMatchReference:
    """Each further serving configuration against the JAX engine: identical
    tokens and schedule, logits within LOGIT_RTOL, every projection in the
    policy's format, and the plain versions taken (no launch) on the CPU."""

    def test_trace_structure_and_tokens_identical(self, config_engines):
        _, engines_ = config_engines
        _assert_same_trace_and_tokens(*engines_)

    def test_logits_within_tolerance(self, config_engines):
        _, (ref, _, eng, _) = config_engines
        _assert_logits_close(ref, eng)

    def test_weights_and_cache_in_the_configured_formats(self, config_engines):
        (mode, cache), (ref, _, eng, _) = config_engines
        layer = eng.params["layers"][0]
        ref_slot = ref.params["stack"]["slot0"]
        for group, names in (("ffn", ("w_in", "w_out")), ("mixer", ("wq", "wk", "wv", "wo"))):
            for name in names:
                assert layer[group][name].mode == ref_slot[group][name].mode
        assert eng.mode == ref.mode and eng.cache_format == cache == ref.cache_format
        assert all(v == 0 for v in ops.launch_counts().values())


#: bf16 serves, (weight residency, decode cache) → (max |Δ logit| / max |logit|,
#: min cosine) against the reference.  bf16 rounds at other places in the
#: two frameworks (norms, rope, residual adds, the casts around each matmul):
#: the plain bf16 stack alone differs by up to 1.0e-2 of the largest logit on
#: this schedule.  Path B (w8a8, bf16 cache) adds int8 re-quantization, which
#: the bf16 noise rarely moves by a step: measured 1.21e-2 and cosine
#: 0.99982, limit 3e-2 and 0.999.  Path A re-quantizes the FFN's activations
#: and the cache to int4, where one last-bit difference on a rounding
#: boundary (or on a row's max, which sets its scale) is a whole step of
#: 1/7 of the row's range at these narrow widths: measured 0.156 and cosine
#: 0.98699 (0.05-0.16 on every logit row), limit 0.3 and 0.97.  Path A's
#: limits therefore cannot see an error of 1e-2 end to end: they fail the
#: planted faults of test_bf16_limits_fail_planted_faults, and
#: test_bf16_layers_match_reference holds path A's pieces to 1e-2 and
#: better on identical bf16 inputs, where no rounding difference reaches a
#: re-quantization.
BF16_LIMITS = {(MODE, CACHE): (0.3, 0.97), ("w8a8", "bf16"): (3e-2, 0.999)}
_BF16_REFS: dict = {}


def _bf16_reference(stack):
    """The reference's bf16 serve of ``stack``, once per test process."""
    if stack not in _BF16_REFS:
        _BF16_REFS[stack] = _serve_ref(*stack, dtype="bfloat16")
    return _BF16_REFS[stack]


def _bf16_errors(ref, eng):
    """(max |Δ logit| / max |logit|, min cosine) over the logit trace."""
    max_rel, min_cos = 0.0, 1.0
    for (_, _, lr), (_, _, lp) in zip(ref.logit_trace, eng.logit_trace):
        lr, lp = np.asarray(lr, np.float64).ravel(), np.asarray(lp, np.float64).ravel()
        assert np.isfinite(lp).all()
        max_rel = max(max_rel, np.abs(lr - lp).max() / np.abs(lr).max())
        min_cos = min(min_cos, lr @ lp / (np.linalg.norm(lr) * np.linalg.norm(lp)))
    return max_rel, min_cos


@pytest.mark.parametrize("stack", list(BF16_LIMITS), ids=lambda c: f"{c[0]}+{c[1]}")
def test_bf16_serve_matches_reference(stack):
    """The main paths' working type: the same schedule and forced tokens
    as the float32 serves, with both engines in bf16."""
    max_rel, min_cos = BF16_LIMITS[stack]
    ref_params, ref, ref_reqs = _bf16_reference(stack)
    eng, reqs = _serve_port(ref_params, *stack, dtype="bfloat16")
    _assert_same_trace_and_tokens(ref, ref_reqs, eng, reqs)
    got_rel, got_cos = _bf16_errors(ref, eng)
    assert got_rel < max_rel and got_cos > min_cos, (got_rel, got_cos)


def _scale_ffn_by_2(params, monkeypatch):
    ffn = params["layers"][0]["ffn"]
    ffn["w_out"] = ffn["w_out"] * 2


def _flip_wo_sign(params, monkeypatch):
    mixer = params["layers"][1]["mixer"]
    mixer["wo"] = -mixer["wo"]


def _cache_mask_off(params, monkeypatch):
    decode = attention._decode_attention

    def unmasked(q, cache, **kw):  # every slot reads as position 0: all valid
        return decode(q, {**cache, "pos_ids": torch.zeros_like(cache["pos_ids"])}, **kw)

    monkeypatch.setattr(attention, "_decode_attention", unmasked)


#: faults planted in the port alone, and their readings (max_rel, min_cos)
#: on path A / path B: one layer's FFN scale ×2 0.311, 0.899 / 0.256, 0.903;
#: one layer's output projection negated 1.445, 0.268 / 1.357, 0.183; the
#: cache mask off 0.469, 0.843 / 0.365, 0.865.
FAULTS = {"ffn_scale_x2": _scale_ffn_by_2, "wo_sign": _flip_wo_sign,
          "mask_off": _cache_mask_off}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("stack", list(BF16_LIMITS), ids=lambda c: f"{c[0]}+{c[1]}")
def test_bf16_limits_fail_planted_faults(stack, fault, monkeypatch):
    """A wrong scale, sign or mask breaks at least one of the bf16 limits."""
    max_rel, min_cos = BF16_LIMITS[stack]
    ref_params, ref, _ = _bf16_reference(stack)
    eng, _ = _serve_port(ref_params, *stack, dtype="bfloat16",
                         fault=lambda p: FAULTS[fault](p, monkeypatch))
    got_rel, got_cos = _bf16_errors(ref, eng)
    assert got_rel >= max_rel or got_cos <= min_cos, (got_rel, got_cos)


@pytest.mark.parametrize("stack", list(BF16_LIMITS), ids=lambda c: f"{c[0]}+{c[1]}")
def test_bf16_layers_match_reference(stack):
    """Each piece of the stack at bf16 on identical inputs.  Every weight
    format's product within 1e-6 of its largest output (measured: 0 for
    the formats that quantize the activations, 4e-7 for w8a16, float32
    summation order), and the ring write of 12 tokens with left pads
    followed by decode attention over the cache within one bf16 step
    (2^-8) of the largest output (measured: 0).  Both fail an error of
    1e-2, which path A's end-to-end limits cannot see."""
    mode, cache = stack
    rng = np.random.default_rng(5)
    spec = residency.ResidencySpec.parse(mode)
    for fmt in (f for f in spec.modes() if f != "bf16"):  # bf16 keeps float weights
        for m in (1, 5):
            w = jnp.asarray(rng.normal(size=(256, 96)) * 0.05, jnp.bfloat16)
            x = jnp.asarray(rng.normal(size=(m, 256)), jnp.bfloat16)
            want = np.asarray(ref_residency.apply(ref_residency.from_float(w, fmt), x),
                              np.float64)
            got = residency.apply(residency.from_float(_bf16_tensor(w), fmt),
                                  _bf16_tensor(x)).double().numpy()
            assert np.abs(got - want).max() / np.abs(want).max() <= 1e-6, (fmt, m)

    ref_cfg, cfg = (dataclasses.replace(c, cache_format=cache) for c in _cfgs("bfloat16"))
    positions = np.stack([np.arange(12), np.arange(-3, 9)]).astype(np.int32)
    b, s = positions.shape
    q, k, v = (jnp.asarray(rng.normal(size=(b, s, h, cfg.d_head)), jnp.bfloat16)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    ref_fmt, fmt = ref_kvcache.format_for(ref_cfg), kvcache.format_for(cfg)
    ref_cache = ref_attention._ring_write(
        ref_attention.init_kv_cache(ref_cfg, b, 16, dtype=jnp.bfloat16), k, v,
        jnp.asarray(positions), ref_fmt)
    want = np.asarray(ref_attention._decode_attention(
        q, ref_cache, cur=jnp.asarray(positions), window=None, fmt=ref_fmt), np.float64)
    port_cache = attention.init_kv_cache(cfg, b, 16, dtype=torch.bfloat16, device="cpu")
    pos = torch.from_numpy(positions)
    attention._ring_write(port_cache, _bf16_tensor(k), _bf16_tensor(v), pos, fmt)
    got = attention._decode_attention(_bf16_tensor(q), port_cache, cur=pos,
                                      fmt=fmt).double().numpy()
    live = positions >= 0
    assert np.abs(got - want)[live].max() / np.abs(want[live]).max() <= 2.0 ** -8


def _bf16_tensor(a):
    """A jax bf16 array as the torch bf16 tensor of the same values."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def test_resident_bytes_match_reference_and_w4a8_is_below_w8a8():
    ref_cfg, cfg = _cfgs()
    ref_params = _ref_params()
    params = _port_params(ref_params)
    got = {}
    for mode in ("w8a8", "w4a8", "ffn=bsdp,mixer=w4a8"):
        got[mode] = engine.resident_bytes(engine.convert_params(params, cfg, mode, min_dim=16))
        assert got[mode] == ref_engine.resident_bytes(
            ref_engine.convert_params(ref_params, ref_cfg, mode, min_dim=16))
    assert got["w4a8"] < got["w8a8"]
    assert got["ffn=bsdp,mixer=w4a8"] < got["w8a8"]


class TestLauncherDefaults:
    def test_defaults_are_the_reference_launchers(self, capsys):
        """No --mode and no --cache-format: w8a8 weights and the config's own
        cache (bf16 for qwen3-1.7b), as ``repro.launch.serve`` serves."""
        launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                           "--min-dim", "16", "--requests", "2", "--max-new", "2"])
        out = capsys.readouterr().out
        assert "residency convert (w8a8)" in out
        assert "cache format: bf16" in out
        assert "served 2 requests / 4 tokens" in out
        assert "scheduler: fcfs" in out

    def test_scheduler_flag_serves_every_request_in_chunks(self, capsys):
        """``--scheduler token_budget:budget=4``: prompts of 4-15 tokens
        advance 4 tokens a step, and every request finishes."""
        launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                           "--min-dim", "16", "--scheduler", "token_budget:budget=4",
                           "--requests", "5", "--max-new", "3"])
        out = capsys.readouterr().out
        assert "scheduler: token_budget:budget=4" in out
        assert "served 5 requests / 15 tokens" in out

    def test_unknown_scheduler_is_refused_by_the_parser(self, capsys):
        with pytest.raises(SystemExit):
            launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                               "--scheduler", "nope"])
        assert "unknown scheduler" in capsys.readouterr().err


class TestEntryPointsNeedTheCard:
    def test_engine_without_device_raises_when_no_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = _cfgs()[1]
        params = model_lib.materialize(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.ServeEngine(params, cfg)

    def test_params_from_numpy_without_device_raises_when_no_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        tree = jax.tree_util.tree_map(np.asarray, _ref_params())
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.params_from_numpy(tree, _cfgs()[1])

    def test_materialize_without_device_raises_when_no_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            model_lib.materialize(_cfgs()[1])

    def test_init_kv_cache_without_device_raises_when_no_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = dataclasses.replace(_cfgs()[1], cache_format=CACHE)
        with pytest.raises(RuntimeError, match="CUDA"):
            attention.init_kv_cache(cfg, 2, 8)
        cache = attention.init_kv_cache(cfg, 2, 8, device="cpu")
        assert {t.device.type for t in cache.values()} == {"cpu"}

    @pytest.mark.parametrize("fmt", ["bf16", "int8", "int4_bp", "int4_bp_fused"])
    def test_cache_format_init_without_device_raises_when_no_gpu(self, monkeypatch, fmt):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cache_fmt = kvcache.get_cache_format(fmt)
        with pytest.raises(RuntimeError, match="CUDA"):
            cache_fmt.init(2, 8, (2,), 40)
        store = cache_fmt.init(2, 8, (2,), 40, device="cpu")
        assert set(store) == set(cache_fmt.suffixes)
        assert {t.device.type for t in store.values()} == {"cpu"}

    def test_plain_impl_matches_kernel_path_on_cpu(self):
        """``impl="plain"`` (the reference's ``impl="jnp"`` semantics) and the
        kernel wrappers' CPU path serve the same schedule to float rounding."""
        cfg = dataclasses.replace(_cfgs()[1])
        params = model_lib.materialize(cfg, seed=1, device="cpu")
        traces = []
        for impl in (None, "plain"):
            eng = engine.ServeEngine(params, cfg, slots=2, max_len=32, mode=MODE,
                                     cache_format=CACHE, min_dim=16,
                                     trace_logits=True, impl=impl, device="cpu")
            _schedule(eng)
            traces.append(eng.logit_trace)
        assert [(k, s) for k, s, _ in traces[0]] == [(k, s) for k, s, _ in traces[1]]
        for (_, _, a), (_, _, b) in zip(*traces):
            assert np.abs(a - b).max() / (np.abs(a).max() + 1e-6) < LOGIT_RTOL
