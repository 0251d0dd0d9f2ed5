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
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.sharding import partitioning as P
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import kvcache
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


def _cfgs():
    ref_cfg = ref_smoke_config("qwen3-1.7b").scaled(
        n_layers=2, vocab_size=VOCAB, dtype=jnp.float32)
    cfg = get_smoke_config("qwen3-1.7b").scaled(
        n_layers=2, vocab_size=VOCAB, dtype=torch.float32)
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


def _ref_params():
    return P.materialize(ref_model.specs(_cfgs()[0], 1), jax.random.PRNGKey(0))


def _port_params(ref_params):
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), _cfgs()[1], "cpu")


def _serve_both(mode, cache):
    ref_cfg, cfg = _cfgs()
    ref_params = _ref_params()
    ref = ref_engine.ServeEngine(ref_params, ref_cfg, slots=2, max_len=32, mode=mode,
                                 cache_format=cache, min_dim=16, trace_logits=True)
    ref_reqs = _schedule(ref)
    eng = engine.ServeEngine(_port_params(ref_params), cfg, slots=2, max_len=32,
                             mode=mode, cache_format=cache, min_dim=16,
                             trace_logits=True, device="cpu")
    reqs = _schedule(eng)
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

    @pytest.mark.parametrize("fmt", ["bf16", "int4_bp", "int4_bp_fused"])
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
