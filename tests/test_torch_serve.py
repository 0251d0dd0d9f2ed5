"""The port's serving slice against the JAX reference engine.

Same float weights (the reference's own, brought across with
``repro_torch.convert.params_from_numpy``), the same residency stack
(``ffn=bsdp_fused,mixer=w8a16``, cache ``int4_bp_fused``, ``fcfs``) and the
teacher-forced schedule of ``tests/test_serve_bsdp.py``: slots=2, three
requests, one of which finishes early so its slot is re-prefilled while
decode continues.  The port runs on the CPU, where every kernel wrapper
takes its plain version.
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
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib
from repro_torch.serve import engine

VOCAB = 128
MODE = "ffn=bsdp_fused,mixer=w8a16"
CACHE = "int4_bp_fused"

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


@pytest.fixture(scope="module")
def engines():
    ref_cfg, cfg = _cfgs()
    ref_params = P.materialize(ref_model.specs(ref_cfg, 1), jax.random.PRNGKey(0))
    ref = ref_engine.ServeEngine(ref_params, ref_cfg, slots=2, max_len=32, mode=MODE,
                                 cache_format=CACHE, min_dim=16, trace_logits=True)
    ref_reqs = _schedule(ref)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    eng = engine.ServeEngine(params, cfg, slots=2, max_len=32, mode=MODE,
                             cache_format=CACHE, min_dim=16, trace_logits=True,
                             device="cpu")
    reqs = _schedule(eng)
    return ref, ref_reqs, eng, reqs


class TestServeSliceMatchesReference:
    def test_trace_structure_and_tokens_identical(self, engines):
        ref, ref_reqs, eng, reqs = engines
        kinds = [(k, s) for k, s, _ in ref.logit_trace]
        assert kinds == [(k, s) for k, s, _ in eng.logit_trace]
        assert sum(1 for k, _ in kinds if k == "prefill") == 3
        first_decode = kinds.index(("decode", (0, 1)))
        assert any(k == "prefill" for k, _ in kinds[first_decode + 1:])
        for a, b in zip(ref_reqs, reqs):
            assert a.out == b.out and a.done and b.done

    def test_logits_within_tolerance(self, engines):
        ref, _, eng, _ = engines
        for (_, _, lr), (_, _, lp) in zip(ref.logit_trace, eng.logit_trace):
            lr, lp = np.asarray(lr, np.float32), np.asarray(lp, np.float32)
            assert lr.shape == lp.shape
            err = np.abs(lr - lp).max() / (np.abs(lr).max() + 1e-6)
            assert err < LOGIT_RTOL, err

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


class TestEntryPointsNeedTheCard:
    def test_engine_without_device_raises_when_no_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = _cfgs()[1]
        params = model_lib.materialize(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.ServeEngine(params, cfg)

    def test_materialize_without_device_raises_when_no_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            model_lib.materialize(_cfgs()[1])

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
