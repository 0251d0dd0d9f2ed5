"""The two further dense configs, qwen1.5-32b and starcoder2-3b, against the
JAX reference, and the registry pieces of the MLA and MoE configs
(minicpm3-4b, deepseek-v2-lite-16b): their fields, parameter transfer,
streamed materialization and launcher (their layers and serves are held in
tests/test_torch_mla.py and tests/test_torch_moe.py).

qwen1.5-32b adds float32 biases after the q, k and v projections;
starcoder2-3b LayerNorm (with a bias), the tanh GELU over an unfused
``w_in`` and 2 KV heads; both an untied head, which converts under the
residency policy like any projection (``embed.head``).  The reference
initialises the biases to zeros and the norm scales to ones, where a dropped
bias or scale would not show, so the serves here run on the reference's own
parameters with those leaves overwritten by seeded nonzero values (numpy)
before either package serves.  Smoke widths, float32, the teacher-forced
schedule of ``tests/test_torch_serve.py``; the port runs on the CPU, where
every kernel wrapper takes its plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import residency as ref_residency
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.sharding import partitioning as P
from repro_torch import configs, convert
from repro_torch.core import residency
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, layers
from repro_torch.models import model as model_lib
from repro_torch.serve import engine

from test_torch_serve import (LOGIT_RTOL, _assert_logits_close, _assert_same_trace_and_tokens,
                              _schedule)

ARCHS = ("qwen1.5-32b", "starcoder2-3b")
#: the further configs with every registry test: the dense ones and MLA / MoE
ALL_ARCHS = ARCHS + ("minicpm3-4b", "deepseek-v2-lite-16b")
#: path B's stack (the reference launcher's default) and path A's
STACKS = [("w8a8", "bf16"), ("ffn=bsdp_fused,mixer=w8a16", "int4_bp_fused")]
STACK_IDS = ["w8a8+bf16", "bsdp_fused+int4_bp_fused"]


def _cfgs(arch):
    return (ref_smoke_config(arch).scaled(dtype=jnp.float32),
            configs.get_smoke_config(arch).scaled(dtype=torch.float32))


def _nonzero_leaves(tree, seed=7):
    """The reference's parameters with every bias drawn around 0 and every
    norm scale around 1 (seeded), so that dropping either changes logits."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        a = np.asarray(a)
        if name in ("bq", "bk", "bv", "bias"):
            return jnp.asarray(rng.normal(0.0, 0.5, a.shape).astype(a.dtype))
        if name in ("scale", "q_norm", "k_norm", "kv_norm"):
            return jnp.asarray((1.0 + rng.normal(0.0, 0.3, a.shape)).astype(a.dtype))
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(leaf, tree)


_REF_PARAMS: dict = {}
_REF_SERVES: dict = {}


def _ref_params(arch):
    if arch not in _REF_PARAMS:
        params = P.materialize(ref_model.specs(_cfgs(arch)[0], 1), jax.random.PRNGKey(0))
        _REF_PARAMS[arch] = _nonzero_leaves(params)
    return _REF_PARAMS[arch]


def _port_params(arch):
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, _ref_params(arch)), _cfgs(arch)[1], "cpu")


def _reference_serve(arch, stack):
    """The reference engine's serve of ``stack``, once per test process."""
    if (arch, stack) not in _REF_SERVES:
        ref = ref_engine.ServeEngine(_ref_params(arch), _cfgs(arch)[0], slots=2, max_len=32,
                                     mode=stack[0], cache_format=stack[1], min_dim=16,
                                     trace_logits=True)
        _REF_SERVES[arch, stack] = ref, _schedule(ref)
    return _REF_SERVES[arch, stack]


def _port_serve(arch, stack, params=None):
    eng = engine.ServeEngine(_port_params(arch) if params is None else params,
                             _cfgs(arch)[1], slots=2, max_len=32, mode=stack[0],
                             cache_format=stack[1], min_dim=16, trace_logits=True,
                             device="cpu")
    return eng, _schedule(eng)


def _max_rel_err(ref, eng) -> float:
    return max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                     / np.abs(np.asarray(a, np.float64)).max())
               for (_, _, a), (_, _, b) in zip(ref.logit_trace, eng.logit_trace))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield ".".join(path), tree


@pytest.mark.parametrize("arch", ALL_ARCHS + ("llama-3.2-vision-11b", "seamless-m4t-medium"))
def test_configs_match_reference_field_for_field(arch):
    """CONFIG and SMOKE: every field the port keeps equals the reference's
    (dtypes by name), n_kv_heads=40 of qwen1.5-32b included; the
    cross-attention configs' cross and encoder fields too."""
    for port, ref in ((configs.get_config(arch), ref_get_config(arch)),
                      (configs.get_smoke_config(arch), ref_smoke_config(arch))):
        for field in dataclasses.fields(port):
            got, want = getattr(port, field.name), getattr(ref, field.name)
            if field.name == "dtype":
                got, want = str(got).removeprefix("torch."), jnp.dtype(want).name
            assert got == want, (arch, field.name, got, want)
    assert arch in configs.ARCH_NAMES


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _layernorm(rng):
    cfg_ref, cfg = _cfgs("starcoder2-3b")
    p = {"scale": 1 + _np(rng, 48, scale=0.3), "bias": _np(rng, 48, scale=0.5)}
    x = _np(rng, 2, 3, 48, scale=2.0) + 1.5  # a mean to take away
    want = ref_layers.norm_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                 cfg_ref)
    got = layers.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), cfg)
    return got, want


def _gelu_mlp(rng):
    cfg_ref, cfg = _cfgs("starcoder2-3b")
    w_in, w_out = _np(rng, 48, 96, scale=0.3), _np(rng, 96, 48, scale=0.2)
    x = _np(rng, 2, 3, 48)
    want = ref_layers.mlp_apply({"w_in": jnp.asarray(w_in), "w_out": jnp.asarray(w_out)},
                                jnp.asarray(x), cfg_ref)
    got = layers.mlp_apply({"w_in": torch.from_numpy(w_in), "w_out": torch.from_numpy(w_out)},
                           torch.from_numpy(x), cfg)
    return got, want


def _qkv_bias(rng):
    cfg_ref, cfg = _cfgs("qwen1.5-32b")
    p = {name: _np(rng, 64, 64, scale=0.125) for name in ("wq", "wk", "wv")}
    p.update({name: _np(rng, 64, scale=0.5) for name in ("bq", "bk", "bv")})
    x, pos = _np(rng, 2, 3, 64), np.tile(np.arange(3, dtype=np.int32), (2, 1))
    want = ref_attention._project_qkv({k: jnp.asarray(v) for k, v in p.items()},
                                      jnp.asarray(x), cfg_ref, 1, jnp.asarray(pos))
    got = attention._project_qkv({k: torch.from_numpy(v) for k, v in p.items()},
                                 torch.from_numpy(x), cfg, torch.from_numpy(pos))
    return torch.cat([t.flatten() for t in got]), jnp.concatenate([t.ravel() for t in want])


def _untied_head(rng, mode):
    cfg_ref, cfg = _cfgs("starcoder2-3b")
    head, x = _np(rng, 48, 256, scale=0.15), _np(rng, 2, 1, 48)
    want_head = ref_residency.from_float(jnp.asarray(head), mode) if mode else jnp.asarray(head)
    got_head = residency.from_float(torch.from_numpy(head), mode) if mode else torch.from_numpy(
        head)
    want = ref_layers.logits_apply({"embedding": None, "head": want_head}, jnp.asarray(x),
                                   cfg_ref)
    got = layers.logits_apply({"embedding": None, "head": got_head}, torch.from_numpy(x), cfg)
    return got, want


#: each new layer piece against the reference function on the same seeded
#: float32 inputs: (pieces, max |Δ| / max |ref|).  Float32 rounding only
#: (measured 2e-7 and below), where the erf GELU differs from
#: ``jax.nn.gelu``'s tanh form by ~1e-3; the untied head under w8a8 is
#: bit-exact integer sums with the same epilogue.
LAYER_CASES = {
    "layernorm": (_layernorm, 1e-6),
    "gelu_tanh_mlp": (_gelu_mlp, 1e-6),
    "qkv_bias": (_qkv_bias, 1e-6),
    "untied_head_float": (lambda rng: _untied_head(rng, None), 1e-6),
    "untied_head_w8a8": (lambda rng: _untied_head(rng, "w8a8"), 1e-6),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_pieces_match_reference(case):
    make, tol = LAYER_CASES[case]
    got, want = make(np.random.default_rng(11))
    got, want = got.double().numpy(), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), case


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_from_numpy_carries_every_leaf(arch):
    """Biases, LayerNorm biases, the MLA leaves, the router, the stacked
    experts and the untied head come across bit for bit, in the port's own
    tree (the shapes of ``model.specs``), deepseek's leading dense layer
    from ``prefix.layer0`` and its MoE layers from the stack after it; an
    unknown leaf raises."""
    ref_tree = jax.tree_util.tree_map(np.asarray, _ref_params(arch))
    params = convert.params_from_numpy(ref_tree, _cfgs(arch)[1], "cpu")
    drawn = dict(_leaves(model_lib.materialize(_cfgs(arch)[1], device="cpu")))
    got = dict(_leaves(params))
    assert got.keys() == drawn.keys()
    for path, t in got.items():
        assert (t.shape, t.dtype) == (drawn[path].shape, drawn[path].dtype), path
    np.testing.assert_array_equal(params["embed"]["head"].float().numpy(),
                                  ref_tree["embed"]["head"].astype(np.float32))
    slot = ref_tree["stack"]["slot0"]
    cfg = _cfgs(arch)[1]
    k0 = cfg.first_k_dense
    if arch == "qwen1.5-32b":
        np.testing.assert_array_equal(params["layers"][1]["mixer"]["bk"].numpy(),
                                      slot["mixer"]["bk"][1])
    elif arch == "starcoder2-3b":
        np.testing.assert_array_equal(params["layers"][1]["ln2"]["bias"].numpy(),
                                      slot["ln2"]["bias"][1])
        np.testing.assert_array_equal(params["final_norm"]["bias"].numpy(),
                                      ref_tree["final_norm"]["bias"])
    else:
        mixer = params["layers"][k0 + 1]["mixer"]
        for name in ("w_dkv", "kv_norm", "w_uk", "w_uv"):
            np.testing.assert_array_equal(mixer[name].float().numpy(),
                                          slot["mixer"][name][1].astype(np.float32))
    if k0:
        np.testing.assert_array_equal(params["layers"][0]["ffn"]["w_in"].float().numpy(),
                                      ref_tree["prefix"]["layer0"]["ffn"]["w_in"])
        for name in ("router", "w_in", "shared_w_out"):
            np.testing.assert_array_equal(params["layers"][k0]["ffn"][name].float().numpy(),
                                          slot["ffn"][name][0])
    slot["mixer"]["w_extra"] = slot["mixer"]["wo"]
    with pytest.raises(ValueError, match="w_extra"):
        convert.params_from_numpy(ref_tree, _cfgs(arch)[1], "cpu")


def _n_projections(cfg) -> int:
    """The quantizable projections of a config's layers: GQA's four or
    MLA's five or six, and the FFN's two, plus a MoE layer's shared
    expert's two (its routed experts are one stacked leaf each)."""
    n = 0
    for i in range(cfg.n_layers):
        n += (5 + bool(cfg.q_lora_rank)) if cfg.attn_type == "mla" else 4
        n += 4 if cfg.ffn_kind(i) == "moe" and cfg.n_shared_experts else 2
    return n


@pytest.mark.parametrize("stack", STACKS, ids=STACK_IDS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_streamed_materialization_is_bit_identical(arch, stack):
    """``materialize_converted`` equals ``convert_params(materialize(...))``
    leaf for leaf: payloads, scales and float leaves, bit for bit."""
    cfg = configs.get_smoke_config(arch)
    want = engine.convert_params(model_lib.materialize(cfg, seed=3, device="cpu"), cfg,
                                 stack[0], min_dim=16)
    got = engine.materialize_converted(cfg, stack[0], seed=3, device="cpu", min_dim=16)
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    converted = 0
    for path, w in want.items():
        g = got[path]
        if isinstance(w, residency.QuantLinearState):
            converted += 1
            assert (g.mode, g.k, g.n) == (w.mode, w.k, w.n), path
            assert torch.equal(g.data, w.data) and torch.equal(g.scale, w.scale), path
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), path
    head = got["embed.head"]
    if stack[0] == "w8a8":
        assert converted == _n_projections(cfg) + 1 and head.mode == "w8a8"
    else:  # path A's stack leaves the head at the model's dtype
        assert converted == _n_projections(cfg) and head.dtype == cfg.dtype


@pytest.mark.parametrize("mode", ["w8a16", "w8a8", "w4a8", "bsdp_fused"])
def test_conversion_by_columns_is_bit_identical(mode, monkeypatch):
    """A weight converted a few columns at a time (the bound on a large
    weight's temporaries) equals its whole conversion, odd K included."""
    rng = np.random.default_rng(12)
    w = torch.from_numpy(_np(rng, 67, 100)).to(torch.bfloat16)
    want = residency.get_format(mode).encode(w.to(torch.float32))
    monkeypatch.setattr(residency, "COLUMN_BLOCK", 67 * 7)  # blocks of 7 columns
    got = residency.from_float(w, mode, dtype=torch.float32)
    assert (got.mode, got.k, got.n) == (want.mode, want.k, want.n)
    assert torch.equal(got.data, want.data) and torch.equal(got.scale, want.scale)


@pytest.mark.parametrize("stack", STACKS, ids=STACK_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch, stack):
    """Both configs, both stacks, nonzero biases and norm leaves: the
    reference's trace and tokens, logits within LOGIT_RTOL of the largest,
    every projection and the head in the reference's format."""
    ref, ref_reqs = _reference_serve(arch, stack)
    eng, reqs = _port_serve(arch, stack)
    _assert_same_trace_and_tokens(ref, ref_reqs, eng, reqs)
    _assert_logits_close(ref, eng)
    ref_head, head = ref.params["embed"]["head"], eng.params["embed"]["head"]
    if isinstance(ref_head, ref_residency.QuantLinearState):
        assert head.mode == ref_head.mode == "w8a8"
    else:
        assert isinstance(head, torch.Tensor) and stack[0] != "w8a8"
    layer, ref_slot = eng.params["layers"][0], ref.params["stack"]["slot0"]
    for group, names in (("ffn", ("w_in", "w_out")), ("mixer", ("wq", "wk", "wv", "wo"))):
        for name in names:
            assert layer[group][name].mode == ref_slot[group][name].mode
    assert all(v == 0 for v in ops.launch_counts().values())


def _drop_bias(monkeypatch, params):
    for layer in params["layers"]:
        for name in ("bq", "bk", "bv"):
            layer["mixer"][name] = torch.zeros_like(layer["mixer"][name])


def _erf_gelu(monkeypatch, params):
    monkeypatch.setattr(layers, "gelu", lambda h: F.gelu(h))


#: faults planted in the port alone, each on the config it belongs to, and
#: their readings (max |Δ logit| / max |logit|) under w8a8 / path A's stack:
#: the dropped bias 0.96 / 1.17, the erf GELU 1.1e-2 / 0.10; the faultless
#: serves read 2e-7 to 5e-7.
FAULTS = {"dropped_qkv_bias": ("qwen1.5-32b", _drop_bias),
          "erf_gelu": ("starcoder2-3b", _erf_gelu)}


@pytest.mark.parametrize("stack", STACKS, ids=STACK_IDS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_the_limit(fault, stack, monkeypatch):
    """A dropped q/k/v bias and the erf GELU each move some logit by more
    than LOGIT_RTOL of the largest."""
    arch, plant = FAULTS[fault]
    ref, _ = _reference_serve(arch, stack)
    params = _port_params(arch)
    plant(monkeypatch, params)
    eng, _ = _port_serve(arch, stack, params)
    assert _max_rel_err(ref, eng) > LOGIT_RTOL


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_launcher_serves_the_smoke_config(arch, capsys):
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--min-dim", "16",
                       "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "residency convert (w8a8)" in out
    assert "served 2 requests / 6 tokens" in out
