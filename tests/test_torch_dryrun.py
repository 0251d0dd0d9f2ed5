"""The port's single-card dry-run (``repro_torch.launch.dryrun``) against the
JAX reference's analytic half (``repro.launch.dryrun``).

On the same configs, integer counts must be equal and float terms agree to
a relative 1e-9: resident weight bytes at every config's full published
size under four policies, ``residency_qbytes`` for every format (and the
``min_dim`` floor), ``abstract_quant`` leaf for leaf against the port's
``convert_params``, the formats' meta ``abstract_state`` against ``encode``
and ``init``, decode-cache bytes for every attention config under every
cache format and against a live engine, ``model.init_cache`` against a
real prefill, parameter counts, model FLOPs, traffic and the serving model
for every arch × applicable shape, the roofline at the H100's figures, the
traced byte gauges, and the command line.  Everything is arithmetic over
meta tensors but the smoke serves and prefills on the CPU.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import applicable_shapes as ref_applicable_shapes
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import kvcache as ref_kvcache
from repro.core import residency as ref_residency
from repro.models import model as ref_model
from repro.sharding import partitioning as RP
from repro_torch import obs
from repro_torch.configs import ARCH_NAMES, SHAPES, applicable_shapes, get_config, get_smoke_config
from repro_torch.core import kvcache, residency
from repro_torch.distributed.mesh import CollectiveEvent
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.models import model
from repro_torch.serve import engine

# The reference's dry run sets XLA_FLAGS for its 512-device mesh when it is
# imported: initialise JAX's backend first (with the harness's flags), and
# put the variable back afterwards.
jax.device_count()
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402
from repro.launch import hlo_stats as ref_hlo_stats  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

RTOL = 1e-9
STACK_A = "ffn=bsdp_fused,mixer=w8a16"
STACK_C = "ffn=bsdp,mixer=w4a8"
POLICIES = ["bf16", "w8a8", STACK_A, STACK_C]
#: path A's resident weight bytes at full published size (the card's, PERF.md §4)
PATH_A_BYTES = {"qwen3-1.7b": 2_128_252_928, "qwen1.5-32b": 24_873_160_704,
                "mixtral-8x7b": 24_717_312_000, "jamba-1.5-large-398b": 217_710_671_744}
CELLS = [(a, s) for a in ARCH_NAMES for s in applicable_shapes(get_config(a))]
VOCAB = 128


def _cfgs(arch, *, smoke=False, **over):
    """(reference config, port config) of ``arch``."""
    if smoke:
        return (ref_smoke_config(arch).scaled(**over), get_smoke_config(arch).scaled(**over))
    return (dataclasses.replace(ref_get_config(arch), **over),
            dataclasses.replace(get_config(arch), **over))


def _close(a, b, rtol=RTOL):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k], rtol)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=rtol, abs=0.0)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# Shape cells and the roofline
# ---------------------------------------------------------------------------


def test_shape_cells_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for arch in ARCH_NAMES:
        assert applicable_shapes(get_config(arch)) == ref_applicable_shapes(ref_get_config(arch))
        assert get_config(arch).supports_long_context() == \
            ref_get_config(arch).supports_long_context()
    assert len(CELLS) == 33
    assert {a for a, s in CELLS if s == "long_500k"} == {
        "mixtral-8x7b", "falcon-mamba-7b", "jamba-1.5-large-398b"}


def test_roofline_dominant_at_h100_figures():
    """The twin of the reference's ``test_roofline_dominant``: one second of
    bf16 compute dominates; two seconds of HBM traffic dominate."""
    t = hlo_stats.roofline_terms(989.4e12, 10e9, 1e9)
    assert t["dominant"] == "compute" and t["t_compute"] == pytest.approx(1.0)
    t = hlo_stats.roofline_terms(1e12, 3.35e12 * 2, 1e9)
    assert t["dominant"] == "memory" and t["step_lower_bound"] == pytest.approx(2.0)
    t = hlo_stats.roofline_terms(1e12, 1e9, 450e9 * 3)
    assert t["dominant"] == "collective" and t["t_collective"] == pytest.approx(3.0)
    t = hlo_stats.roofline_terms(1978.9e12, 0.0, 0.0, int8_fraction=1.0)
    assert t["t_compute"] == pytest.approx(1.0)


def test_roofline_terms_are_the_reference_formula_at_equal_figures(monkeypatch):
    """At the reference's figures (its int8 rate twice its bf16 rate, one
    link), the port's three terms are the reference's."""
    for key, ref_key in (("bf16_flops", "bf16_flops"), ("hbm_bw", "hbm_bw"),
                         ("nvlink_bw", "ici_link_bw")):
        monkeypatch.setitem(hlo_stats.HW, key, ref_hlo_stats.HW[ref_key])
    monkeypatch.setitem(hlo_stats.HW, "int8_ops", 2 * ref_hlo_stats.HW["bf16_flops"])
    for args, frac in (((3e14, 2e9, 5e8), 0.0), ((3e14, 2e9, 5e8), 0.4), ((1e9, 8e11, 0.0), 0.0)):
        _close(hlo_stats.roofline_terms(*args, int8_fraction=frac),
               ref_hlo_stats.roofline_terms(*args, int8_fraction=frac))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", POLICIES, ids=["bf16", "w8a8", "A", "C"])
def test_weight_bytes_match_reference_at_full_size(spec):
    for arch in ARCH_NAMES:
        ref_cfg, cfg = _cfgs(arch)
        got = dryrun.analytic_weight_bytes(cfg, spec)
        assert got == ref_dryrun.analytic_weight_bytes(ref_cfg, spec), arch
        if spec == STACK_A and arch in PATH_A_BYTES:
            assert got == PATH_A_BYTES[arch]


@pytest.mark.parametrize("mode", residency.formats())
def test_abstract_state_is_encode_on_the_meta_device(mode):
    """The twin of ``test_resident_bytes_identical_real_vs_abstract``: the
    meta state has ``encode``'s shapes and dtypes and counts its bytes, and
    the reference's abstract state the same bytes; at odd K too."""
    fmt, ref_fmt = residency.get_format(mode), ref_residency.get_format(mode)
    for k, n in ((67, 40), (256, 128)):
        real = fmt.encode(torch.randn(k, n, generator=torch.Generator().manual_seed(1)))
        ab = fmt.abstract_state(k, n)
        assert ab.data.device.type == "meta" and ab.scale.device.type == "meta"
        for t_real, t_ab in ((real.data, ab.data), (real.scale, ab.scale)):
            assert t_real.shape == t_ab.shape and t_real.dtype == t_ab.dtype
        assert (ab.mode, ab.k, ab.n) == (mode, k, n)
        assert fmt.resident_bytes(ab) == fmt.resident_bytes(real) == \
            ref_fmt.resident_bytes(ref_fmt.abstract_state(k, n))
        assert fmt.qbytes(k, n) == ref_fmt.qbytes(k, n)
    assert fmt.qbytes() == ref_fmt.qbytes()


@pytest.mark.parametrize("mode", residency.formats())
def test_residency_qbytes_match_reference(mode):
    """The twin of ``test_qbytes_matches_dryrun_accounting``: at the smoke
    config every quantizable leaf is aligned, so the walk collapses to the
    format's rate; at the ``min_dim`` floor every leaf stays bf16; and at
    full size the port's walk is the reference's."""
    ref_cfg, cfg = _cfgs("qwen3-1.7b", smoke=True)
    wq = dryrun.residency_qbytes(cfg, mode, min_dim=16)
    assert wq == ref_dryrun.residency_qbytes(ref_cfg, 1, mode, min_dim=16)
    assert wq == pytest.approx(residency.get_format(mode).qbytes())
    assert dryrun.residency_qbytes(cfg, mode, min_dim=10**9) == 2.0
    for arch in ARCH_NAMES:
        ref_cfg, cfg = _cfgs(arch)
        assert dryrun.residency_qbytes(cfg, mode) == \
            ref_dryrun.residency_qbytes(ref_cfg, 1, mode), arch


def _states(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, residency.QuantLinearState):
            out[".".join(path)] = t
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))

    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b", "falcon-mamba-7b",
                                  "seamless-m4t-medium"])
def test_abstract_quant_matches_convert_params(arch):
    """The twin of ``test_dryrun_abstract_tree_matches_real_convert``: the
    same leaves converted (the ``min_dim`` 48 floor leaves the smoke
    config's narrow projections float), each with the real state's mode,
    shapes and dtypes, a MoE layer's experts one stacked state; and the
    bytes of the whole tree equal the real tree's."""
    spec = {"ffn": "bsdp", "mixer": "w8a16", "default": "w8a8"}
    cfg = get_smoke_config(arch).scaled(vocab_size=VOCAB)
    real = engine.convert_params(model.materialize(cfg, device="cpu"), cfg, spec, min_dim=48)
    qtree = dryrun.abstract_quant(model.specs(cfg), spec, min_dim=48)
    rs, ab = _states(real), _states(qtree)
    assert rs and set(rs) == set(ab)
    floored = {p for p, s in dryrun.tree_lib.flatten(qtree)
               if isinstance(s, model.ParamSpec) and p[-1] in engine.QUANTIZABLE_KEYS}
    narrow = {p for p, s in dryrun.tree_lib.flatten(model.specs(cfg))
              if p[-1] in engine.QUANTIZABLE_KEYS and min(s.shape[-2:]) < 48}
    assert floored == narrow
    assert narrow or arch != "qwen3-1.7b"  # its 32-wide kv projections stay float
    for path, st in rs.items():
        a = ab[path]
        assert (st.mode, st.k, st.n) == (a.mode, a.k, a.n), path
        for t_real, t_ab in ((st.data, a.data), (st.scale, a.scale)):
            assert t_real.shape == t_ab.shape and t_real.dtype == t_ab.dtype, path
    assert engine.resident_bytes(real) == dryrun.analytic_weight_bytes(cfg, spec, min_dim=48)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt_name", kvcache.formats())
def test_cache_abstract_state_is_init_on_the_meta_device(fmt_name):
    fmt, ref_fmt = kvcache.get_cache_format(fmt_name), ref_kvcache.get_cache_format(fmt_name)
    for lead, feat in (((3,), 40), ((), 24)):
        real = fmt.init(2, 20, lead, feat, device="cpu")
        ab = fmt.abstract_state(2, 20, lead, feat)
        assert set(real) == set(ab)
        for k in real:
            assert ab[k].device.type == "meta"
            assert real[k].shape == ab[k].shape and real[k].dtype == ab[k].dtype
        assert fmt.resident_bytes(ab) == kvcache.cache_resident_bytes(real) == \
            ref_fmt.resident_bytes(ref_fmt.abstract_state(2, 20, lead, feat))
        assert fmt.slot_bytes(lead, feat) == ref_fmt.slot_bytes(lead, feat)


def _raises_or(fn):
    try:
        return fn()
    except NotImplementedError:
        return "raises"


@pytest.mark.parametrize("fmt_name", kvcache.formats())
def test_analytic_cache_bytes_match_reference(fmt_name):
    """Every config at full size (an attention config counts; the SSM,
    hybrid and VLM configs raise in both), at (2, 20) and (4, 512)."""
    counted = 0
    for arch in ARCH_NAMES:
        ref_cfg, cfg = _cfgs(arch, cache_format=fmt_name)
        for batch, cache_len in ((2, 20), (4, 512)):
            got = _raises_or(lambda: dryrun.analytic_cache_bytes(cfg, batch, cache_len))
            assert got == _raises_or(
                lambda: ref_dryrun.analytic_cache_bytes(ref_cfg, batch, cache_len)), arch
            counted += got != "raises"
    assert counted == 2 * 7
    cfg = get_config("falcon-mamba-7b")
    with pytest.raises(NotImplementedError, match="attention"):
        dryrun.analytic_cache_bytes(cfg, 2, 16)


def test_path_a_cache_bytes():
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), cache_format="int4_bp_fused")
    assert dryrun.analytic_cache_bytes(cfg, 4, 512) == 62_619_648


def _smoke_serve(arch, fmt, mode="w8a8", slots=2, max_len=20):
    cfg = get_smoke_config(arch).scaled(n_layers=2, vocab_size=VOCAB)
    eng = engine.ServeEngine(model.materialize(cfg, device="cpu"), cfg, slots=slots,
                             max_len=max_len, mode=mode, cache_format=fmt, min_dim=16,
                             device="cpu")
    assert eng.resident_bytes()["cache"] == 0  # no refill yet
    rng = np.random.default_rng(0)
    for n in (5, 7, 3):
        eng.submit(rng.integers(0, VOCAB, size=(n,)).astype(np.int32), 2)
    eng.run()
    return eng


LIVE = [("qwen3-1.7b", f) for f in kvcache.formats()] + [
    ("minicpm3-4b", "int4_bp"), ("minicpm3-4b", "paged_int8"), ("minicpm3-4b", "paged_int4_bp"),
    ("mixtral-8x7b", "int4_bp_fused"), ("deepseek-v2-lite-16b", "paged_bf16")]


@pytest.mark.parametrize("arch,fmt", LIVE)
def test_cache_and_weight_bytes_equal_live_engine(arch, fmt):
    """The twins of ``test_byte_exact_vs_live_engine`` and
    ``test_engine_resident_breakdown_matches_dryrun_bytes``: max_len 20 is
    not a page multiple, so the page-rounded ring counts."""
    eng = _smoke_serve(arch, fmt)
    got = eng.resident_bytes()
    assert got["cache"] > 0 and got["total"] == got["weights"] + got["cache"]
    assert got["cache"] == dryrun.analytic_cache_bytes(eng.cfg, 2, 20)
    ref_cfg = ref_smoke_config(arch).scaled(n_layers=2, vocab_size=VOCAB, cache_format=fmt)
    assert got["cache"] == ref_dryrun.analytic_cache_bytes(ref_cfg, 2, 20)
    assert got["weights"] == dryrun.analytic_weight_bytes(eng.cfg, "w8a8", min_dim=16) == \
        ref_dryrun.analytic_weight_bytes(ref_cfg, "w8a8", min_dim=16)
    assert got["cache"] == kvcache.cache_resident_bytes(
        model.init_cache(eng.cfg, 2, 20, device="meta"))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (str(i),))]
    return [(path, tuple(tree.shape), tree.dtype)]


INIT = [("qwen3-1.7b", "int4_bp"), ("qwen3-1.7b", "paged_int8"), ("minicpm3-4b", "int8"),
        ("mixtral-8x7b", "bf16"), ("falcon-mamba-7b", "bf16"),
        ("jamba-1.5-large-398b", "int4_bp_fused"), ("llama-3.2-vision-11b", "int4_bp"),
        ("seamless-m4t-medium", "paged_int4_bp_fused")]


@pytest.mark.parametrize("arch,fmt", INIT)
def test_init_cache_equals_a_real_prefill(arch, fmt):
    """The twin of ``test_dryrun_cache_bytes_equal_real``: the meta cache
    has a real prefill's leaves (shapes, dtypes) for every mixer kind, the
    contexts included, and the bytes of the reference's stacked
    ``init_cache``; the smoke window (mixtral's 32) cuts the ring."""
    cfg = get_smoke_config(arch).scaled(vocab_size=VOCAB, cache_format=fmt)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, VOCAB, (3, 7))).long()}
    ctx = torch.from_numpy(rng.normal(size=(3, cfg.encoder_tokens, cfg.d_model))
                           .astype(np.float32))
    if cfg.is_enc_dec:
        batch["enc_embeds"] = ctx
    elif cfg.family == "vlm":
        batch["ctx_embeds"] = ctx
    max_len = 40 if cfg.sliding_window else 24
    _, caches = model.prefill(model.materialize(cfg, device="cpu"), batch, cfg, max_len=max_len)
    abstract = model.init_cache(cfg, 3, max_len, device="meta")
    assert all(t.device.type == "meta" for layer in abstract for t in _flat(layer))
    assert _leaves(abstract) == _leaves(caches)
    got = kvcache.cache_resident_bytes(abstract)
    assert got == kvcache.cache_resident_bytes(caches)
    ref_cfg = ref_smoke_config(arch).scaled(vocab_size=VOCAB, cache_format=fmt)
    assert got == ref_kvcache.cache_resident_bytes(
        jax.eval_shape(lambda: ref_model.init_cache(ref_cfg, 3, max_len, tp=1)))


def _flat(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    return [tree]


@pytest.mark.parametrize("fmt_name", ["bf16", "int4_bp_fused", "paged_int8"])
def test_init_cache_bytes_match_reference_at_full_size(fmt_name):
    for arch in ARCH_NAMES:
        ref_cfg, cfg = _cfgs(arch, cache_format=fmt_name)
        got = kvcache.cache_resident_bytes(model.init_cache(cfg, 4, 4160, device="meta"))
        assert got == ref_kvcache.cache_resident_bytes(
            jax.eval_shape(lambda: ref_model.init_cache(ref_cfg, 4, 4160, tp=1))), arch


# ---------------------------------------------------------------------------
# Counts, traffic and the serving model
# ---------------------------------------------------------------------------


def test_param_counts_and_flops_match_reference():
    for arch, shape in CELLS:
        ref_cfg, cfg = _cfgs(arch)
        _close(dryrun.param_counts(cfg), ref_dryrun.param_counts(ref_cfg, 1))
        _close(dryrun.model_flops(cfg, SHAPES[shape]),
               ref_dryrun.model_flops(ref_cfg, REF_SHAPES[shape], 1))


@pytest.mark.parametrize("fmt_name", [None, "int8", "int4_bp_fused", "paged_int4_bp"])
def test_traffic_matches_reference(fmt_name):
    over = {} if fmt_name is None else {"cache_format": fmt_name}
    for arch, shape in CELLS:
        ref_cfg, cfg = _cfgs(arch, **over)
        cell, ref_cell = SHAPES[shape], REF_SHAPES[shape]
        for qmode in ("bf16", STACK_A):
            _close(dryrun.analytic_traffic(cfg, cell, qmode),
                   ref_dryrun.analytic_traffic(ref_cfg, ref_cell, 1, {}, 1, qmode))
        _close(dryrun._cache_bytes_local(cfg, cell),
               ref_dryrun._cache_bytes_local(ref_cfg, ref_cell, 1, {}))


def test_decode_step_traffic_of_path_a():
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), cache_format="int4_bp_fused")
    traffic = dryrun.analytic_traffic(cfg, dryrun.ShapeCell("d", 512, 4, "decode"), STACK_A)
    assert traffic["total"] == 1_141_419_648.0
    t = hlo_stats.roofline_terms(0.0, traffic["total"], 0.0)
    assert t["step_lower_bound"] * 1e3 == pytest.approx(0.3407222829850746, rel=RTOL)


def test_serving_model_matches_reference(monkeypatch):
    """The twin of ``test_dryrun_serving_model_record``, and every
    scheduler's summary equal to the reference's at the same HBM rate."""
    monkeypatch.setitem(ref_hlo_stats.HW, "hbm_bw", hlo_stats.HW["hbm_bw"])
    ref_cfg, cfg = _cfgs("qwen3-1.7b", smoke=True, n_kv_heads=8, d_head=128)
    cases = [(cfg, ref_cfg, dryrun.ShapeCell("d", 256, 8, "decode"))]
    for arch, shape in (("qwen3-1.7b", "decode_32k"), ("deepseek-v2-lite-16b", "decode_32k"),
                        ("falcon-mamba-7b", "long_500k")):
        ref_full, full = _cfgs(arch)
        cases.append((full, ref_full, SHAPES[shape]))
    for c, rc, cell in cases:
        rec = dryrun.analytic_serving(c, cell, "w8a8", slots=4)
        assert rec["t_call_s"] > 0 and rec["t_token_s"] > 0
        assert set(rec["schedulers"]) >= {"fcfs", "sjf"}
        for summary in rec["schedulers"].values():
            assert summary["tokens"] > 0 and summary["ttft_s_p95"] > 0
        ref = ref_dryrun.analytic_serving(rc, ref_dryrun.ShapeCell(*dataclasses.astuple(cell)),
                                          1, {}, "w8a8", slots=4)
        _close(rec, ref)


# ---------------------------------------------------------------------------
# The engine's gauges, the record and the command line
# ---------------------------------------------------------------------------


def test_traced_byte_gauges_equal_both_twins():
    """The twin of ``test_resident_byte_gauges_exact_vs_dryrun_twins``: a
    traced path-A-stack serve under ``prefix_cache`` gauges the bytes the
    engine counts, and both packages' dry runs count the same."""
    mode = "ffn=bsdp_fused,mixer=w8a16,default=w8a8"
    cfg = get_smoke_config("qwen3-1.7b").scaled(n_layers=2, vocab_size=64)
    obs.clear_sinks()
    obs.reset_metrics()
    eng = engine.ServeEngine(model.materialize(cfg, device="cpu"), cfg, slots=2, max_len=32,
                             mode=mode, cache_format="int4_bp_fused", scheduler="prefix_cache",
                             min_dim=16, trace=True, device="cpu")
    rng = np.random.default_rng(0)
    try:
        for n in (9, 9, 5, 7):
            eng.submit(rng.integers(0, 64, size=(n,)).astype(np.int32), 4)
        eng.run()
        gauges = obs.gauge_value("bytes.cache"), obs.gauge_value("bytes.weights")
    finally:
        obs.clear_sinks()
        obs.reset_metrics()
    ref_cfg = ref_smoke_config("qwen3-1.7b").scaled(n_layers=2, vocab_size=64,
                                                    cache_format="int4_bp_fused")
    cache_twin = dryrun.analytic_cache_bytes(eng.cfg, 2, 32)
    weight_twin = dryrun.analytic_weight_bytes(eng.cfg, mode, min_dim=16)
    assert cache_twin == ref_dryrun.analytic_cache_bytes(ref_cfg, 2, 32)
    assert weight_twin == ref_dryrun.analytic_weight_bytes(ref_cfg, mode, min_dim=16)
    assert gauges == (cache_twin, weight_twin)
    assert eng.resident_bytes() == {"weights": weight_twin, "cache": cache_twin,
                                    "total": weight_twin + cache_twin}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama-3.2-vision-11b", "seamless-m4t-medium"])
def test_batch_specs_match_reference(arch):
    from repro.sharding import partitioning as P

    ref_cfg, cfg = _cfgs(arch)
    for shape in ("train_4k", "decode_32k"):
        got = dryrun.batch_specs(cfg, SHAPES[shape])
        want, _ = ref_dryrun.batch_specs(ref_cfg, REF_SHAPES[shape], P.base_rules())
        assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for k, t in got.items()} \
            == {k: (tuple(a.shape), str(a.dtype)) for k, a in want.items()}
        assert all(t.device.type == "meta" for t in got.values())


def test_analyze_cell_records():
    rec = dryrun.analyze_cell("qwen3-1.7b", "decode_32k", qmode=STACK_A,
                              cache_format="int4_bp_fused")
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), cache_format="int4_bp_fused")
    one = rec["one_card"]
    assert one["weight_bytes"] == PATH_A_BYTES["qwen3-1.7b"]
    assert one["cache_bytes"] == dryrun.analytic_cache_bytes(cfg, 128, 32_768 + 64)
    assert one["batch_bytes"] == 128 * 32_768 * 4
    assert one["total_bytes"] == one["weight_bytes"] + one["cache_bytes"] + one["batch_bytes"]
    assert one["fits"] == (one["total_bytes"] <= 80e9)
    roof = rec["roofline"]
    assert roof["hbm_bytes_analytic"] == dryrun.analytic_traffic(
        cfg, SHAPES["decode_32k"], STACK_A)["total"]
    assert roof["dominant"] == "memory" and "serving_model" in rec
    assert rec["model_flops"] == dryrun.model_flops(cfg, SHAPES["decode_32k"])

    train = dryrun.analyze_cell("qwen3-1.7b", "train_4k")
    state = train["one_card"]["train_state_bytes"]
    n = dryrun.param_counts(get_config("qwen3-1.7b"))["total"]
    # the optimizer's leaves: the reference's layout, a stacked leaf's layers under one moment
    n_leaves = len(dryrun.tree_lib.leaves(dryrun.convert.reference_layout(
        model.specs(get_config("qwen3-1.7b")), get_config("qwen3-1.7b"))))
    assert state["grads"] == 4 * n
    assert state["moments"] == 2 * (2 * n + 4 * n_leaves) + 4  # bf16 moments, their scales, step
    assert train["one_card"]["fits"] is True and "serving_model" not in train

    jamba = dryrun.analyze_cell("jamba-1.5-large-398b", "long_500k", qmode=STACK_A)
    assert jamba["one_card"]["weight_bytes"] == PATH_A_BYTES["jamba-1.5-large-398b"]
    assert jamba["one_card"]["fits"] is False


def test_cli_writes_every_cell(tmp_path, capsys):
    assert dryrun.main(["--all", "--qmode", STACK_A, "--cache-format", "int4_bp_fused",
                        "--scheduler", "fcfs", "--out", str(tmp_path)]) == 0
    files = sorted(tmp_path.iterdir())
    assert len(files) == 33
    recs = [json.loads(f.read_text()) for f in files]
    assert all(r["status"] == "ok" for r in recs)
    assert {(r["arch"], r["shape"]) for r in recs} == set(CELLS)
    assert all(not r["one_card"]["fits"] for r in recs if r["arch"] == "jamba-1.5-large-398b")
    assert all(list(r["serving_model"]["schedulers"]) == ["fcfs"]
               for r in recs if r["kind"] == "decode")
    assert "dry-run complete: 33 ok, 0 failed" in capsys.readouterr().out


def test_cli_refuses_unregistered_names(capsys):
    for argv in (["--qmode", "w3a3"], ["--cache-format", "int2"], ["--scheduler", "lifo"],
                 ["--arch", "gpt-5"]):
        with pytest.raises(SystemExit) as e:
            dryrun.main(argv)
        assert e.value.code == 2
    assert "registered" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# At a mesh: tp, a rank's bytes, the collectives, the probes
# ---------------------------------------------------------------------------

TPS = (1, 2, 4, 16)
#: the acceptance's tolerance on floats at tp (integers are equal)
MESH_RTOL = 1e-12
STACK_B = "w8a8"


def _mesh_axes(tp):
    return {"data": 16 // tp, "model": tp}


@pytest.mark.parametrize("tp", TPS)
def test_restored_functions_match_reference_at_tp(tp, monkeypatch):
    """``param_counts``, ``model_flops``, ``residency_qbytes``,
    ``analytic_traffic`` (with ``mb``), ``analytic_serving``,
    ``analytic_cache_bytes``, ``analytic_weight_bytes`` and
    ``_cache_bytes_local`` at ``tp`` on a (16/tp, tp) mesh, every arch at
    full size, both main stacks: the reference's values, integers equal,
    floats to 1e-12; where the reference raises (a Mamba layer's cache), the
    port raises."""
    monkeypatch.setitem(ref_hlo_stats.HW, "hbm_bw", hlo_stats.HW["hbm_bw"])
    axes = _mesh_axes(tp)
    for arch in ARCH_NAMES:
        ref_cfg, cfg = _cfgs(arch)
        _close(dryrun.param_counts(cfg, tp), ref_dryrun.param_counts(ref_cfg, tp), MESH_RTOL)
        for q in (STACK_A, STACK_B):
            _close(dryrun.residency_qbytes(cfg, q, tp=tp),
                   ref_dryrun.residency_qbytes(ref_cfg, tp, q), MESH_RTOL)
            assert dryrun.analytic_weight_bytes(cfg, q, tp=tp) == \
                ref_dryrun.analytic_weight_bytes(ref_cfg, q, tp=tp, rules=RP.base_rules()), arch
        for shape in applicable_shapes(cfg):
            cell, ref_cell = SHAPES[shape], REF_SHAPES[shape]
            _close(dryrun.model_flops(cfg, cell, tp),
                   ref_dryrun.model_flops(ref_cfg, ref_cell, tp), MESH_RTOL)
            _close(dryrun._cache_bytes_local(cfg, cell, tp=tp, mesh_axes=axes),
                   ref_dryrun._cache_bytes_local(ref_cfg, ref_cell, tp, axes), MESH_RTOL)
            for q in (STACK_A, STACK_B):
                _close(dryrun.analytic_traffic(cfg, cell, q, tp=tp, mesh_axes=axes, mb=2),
                       ref_dryrun.analytic_traffic(ref_cfg, ref_cell, tp, axes, 2, q), MESH_RTOL)
        got = _raises_or(lambda: dryrun.analytic_cache_bytes(cfg, 4, 512, tp=tp))
        assert got == _raises_or(lambda: ref_dryrun.analytic_cache_bytes(ref_cfg, 4, 512,
                                                                        tp=tp)), arch
    for arch in ("qwen3-1.7b", "deepseek-v2-lite-16b"):
        ref_cfg, cfg = _cfgs(arch)
        _close(dryrun.analytic_serving(cfg, SHAPES["decode_32k"], STACK_B, tp=tp, mesh_axes=axes),
               ref_dryrun.analytic_serving(ref_cfg, REF_SHAPES["decode_32k"], tp, axes, STACK_B),
               MESH_RTOL)


def test_rank_bytes_on_one_card_are_the_one_card_counts():
    """At one device ``rank_bytes`` is the one-card record: the weights'
    ``analytic_weight_bytes``, the cache's ``model.init_cache`` bytes (every
    mixer kind), the train state's ``train_state_bytes``, the batch's."""
    for arch, shape in (("qwen3-1.7b", "decode_32k"), ("jamba-1.5-large-398b", "long_500k"),
                        ("seamless-m4t-medium", "prefill_32k"), ("qwen1.5-32b", "train_4k")):
        rec = dryrun.analyze_cell(arch, shape, qmode=STACK_A, skip_probes=True)
        one, mine = rec["one_card"], rec["rank"]
        assert mine["total"] == one["total_bytes"] and mine["even"] and mine["fits"] == one["fits"]
        assert mine.get("weights") == one.get("weight_bytes")
        assert mine.get("cache") == one.get("cache_bytes")
        assert mine["batch"] == one["batch_bytes"]


def test_rank_bytes_cut_by_the_rules():
    """At (data=2, model=4) a serve rank holds a quarter of every sharded
    leaf (the bit-plane ``w_out`` whole, the tied embedding's vocab rows a
    quarter), its slots' half of the cache; uneven slots count the largest
    rank; a train rank's FSDP shards are the data axis's share again."""
    cfg = get_config("qwen3-1.7b")
    axes = {"data": 2, "model": 4}
    whole = dryrun.rank_bytes(cfg, "decode", qmode=STACK_A, batch=8, cache_len=512)
    mine = dryrun.rank_bytes(cfg, "decode", mesh_axes=axes, qmode=STACK_A, batch=8, cache_len=512)
    assert whole["weights"] == dryrun.analytic_weight_bytes(cfg, STACK_A)
    assert whole["weights"] / 4 < mine["weights"] < whole["weights"] / 2
    pos = 8 * 512 * 4 * cfg.n_layers  # pos_ids: the slots' half on each model rank, whole
    assert mine["cache"] == (whole["cache"] - pos) // 8 + pos // 2
    odd = dryrun.rank_bytes(cfg, "decode", mesh_axes=axes, qmode=STACK_A, batch=3, cache_len=512)
    assert not odd["even"] and odd["batch"] == 2 * 1 * 4  # the larger rank's two rows
    train = dryrun.rank_bytes(cfg, "train", mesh_axes=axes, batch=8, seq_len=16)
    full = dryrun.train_state_bytes(cfg)
    assert train["params"] < full["params"] / 4 and train["grads"] < full["grads"] / 4
    assert train["batch"] == 2 * 4 * 16 * 4  # tokens and labels of 4 rows


def _hlo_text(events) -> str:
    """One HLO line a collective event, as XLA prints them: the result's
    shape (bytes as u8), the kind, and the replica groups or the permute's
    pairs."""
    lines = []
    for i, ev in enumerate(events):
        t = f"u8[{ev.bytes}]{{0}}"
        if ev.kind == "collective-permute":
            tail = "source_target_pairs={{0,1},{1,0}}"
        else:
            tail = "replica_groups={{" + ",".join(str(j) for j in range(ev.group)) + "}}"
        lines.append(f"  %c{i} = {t} {ev.kind}({t} %p{i}), {tail}")
    return "\n".join(lines)


def test_collective_stats_matches_reference_on_hlo_text():
    """The port's ``collective_stats`` over events equals the reference's
    over HLO text of the same kinds, sizes and groups: a deepseek decode
    step and a qwen3 prefill at tp, a train step over (pod, data, model),
    an all-to-all, a permute and a group of one."""
    ev = dryrun.call_collectives(get_config("deepseek-v2-lite-16b"), STACK_B, "decode", batch=8,
                                 seq=1, tp=16)
    ev += dryrun.call_collectives(get_config("qwen3-1.7b"), STACK_A, "prefill", batch=2, seq=64,
                                  tp=4)
    cut = get_config("qwen3-1.7b").scaled(n_layers=2)
    ev += dryrun.train_step_collectives(cut, mesh_axes={"pod": 2, "data": 2, "model": 2},
                                        rows=2, seq=16, compress_pod_grads=True, moments="int8")
    ev += [CollectiveEvent("all-to-all", 4096, 4),
           CollectiveEvent("collective-permute", 512, 2),
           CollectiveEvent("all-reduce", 64, 1)]
    got = hlo_stats.collective_stats(ev)
    want = ref_hlo_stats.collective_stats(_hlo_text(ev))
    assert set(got.by_kind) == set(hlo_stats.KINDS)
    _close(got.by_kind, want.by_kind, MESH_RTOL)
    assert got.count == want.count == len(ev)
    assert got.wire_bytes == pytest.approx(want.wire_bytes, rel=MESH_RTOL)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (16, 16)], ids=["card", "pod"])
def test_corrected_totals_equal_the_direct_count(mesh_shape):
    """The probes at depth 1 and 2 (and encoder depth 2), differenced as the
    reference does, give back the direct full-depth count of every cost
    key: the port counts every layer."""
    for arch in ("qwen3-1.7b", "starcoder2-3b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b",
                 "seamless-m4t-medium"):
        for shape in applicable_shapes(get_config(arch)):
            rec = dryrun.analyze_cell(arch, shape, qmode=STACK_A, mesh_shape=mesh_shape)
            for key in dryrun._COST_KEYS:
                if rec[key] is None:
                    assert rec["corrected"][key] is None and rec["unsupported"]
                else:
                    assert rec["corrected"][key] == pytest.approx(rec[key], rel=MESH_RTOL), \
                        (arch, shape, key)


def test_a_count_of_one_superblock_fails_the_correction(monkeypatch):
    """Planted: a direct count that counts the per-layer terms once (as
    XLA's cost analysis counts a scanned body once) leaves the corrected
    totals above it."""
    lower = dryrun.lower_cell

    def scanned(arch, shape, *, probe=None, **kw):
        return lower(arch, shape, probe=probe or (1, 1), **kw)

    monkeypatch.setattr(dryrun, "lower_cell", scanned)
    rec = dryrun.analyze_cell("qwen3-1.7b", "train_4k", mesh_shape=(16, 16))
    for key in dryrun._COST_KEYS:
        assert rec["corrected"][key] > 1.5 * rec[key], key


def test_mesh_records():
    """The pod record of a served cell: 256 devices, the tp = 16 plan, wire
    bytes from the collectives, the rank's bytes as ``argument_size``, the
    collective term in the roofline; the cells the port does not run at a
    mesh hold ``collectives: null`` and the check that raises."""
    rec = dryrun.analyze_cell("qwen3-1.7b", "decode_32k", qmode=STACK_A,
                              cache_format="int4_bp_fused", mesh="pod")
    assert rec["devices"] == 256 and rec["mesh_shape"] == {"data": 16, "model": 16}
    assert set(rec["collectives"]) == {"all-reduce", "all-gather"}
    assert rec["collective_wire_bytes"] > 0 and rec["unsupported"] is None
    assert rec["memory"]["argument_size_in_bytes"] == rec["rank"]["total"]
    assert rec["roofline"]["t_collective"] == pytest.approx(
        rec["corrected"]["collective_wire_bytes"] / hlo_stats.HW["nvlink_bw"])
    assert "one_card" not in rec and set(dryrun.XLA_KEYS) >= {"flops_per_device"}
    for arch, shape, check in (("falcon-mamba-7b", "decode_32k", "check_tp"),
                               ("minicpm3-4b", "train_4k", "check_tp"),
                               ("mixtral-8x7b", "long_500k", "plan")):
        rec = dryrun.analyze_cell(arch, shape, mesh="multipod", skip_probes=True)
        assert rec["devices"] == 512 and rec["collectives"] is None
        assert rec["collective_wire_bytes"] is None and rec["unsupported"].startswith(check)
    moe = dryrun.analyze_cell("deepseek-v2-lite-16b", "train_4k", mesh_shape=(16, 1),
                              skip_probes=True)
    assert moe["unsupported"].startswith("check_mesh")
    jamba = dryrun.analyze_cell("jamba-1.5-large-398b", "decode_32k", qmode=STACK_A,
                                mesh_shape=(1, 4), skip_probes=True)
    assert jamba["unsupported"].startswith("check_tp") and jamba["rank"]["total"] > 0


def test_cli_writes_every_cell_at_both_meshes(tmp_path, capsys):
    """``--mesh both``: a record for every arch × shape at the pod and the
    multi-pod mesh, each with wire bytes or ``collectives: null`` and the
    check that raises; ``--mesh-shape`` names its own."""
    assert dryrun.main(["--all", "--mesh", "both", "--skip-probes", "--qmode", STACK_A,
                        "--scheduler", "fcfs", "--out", str(tmp_path)]) == 0
    recs = [json.loads(f.read_text()) for f in sorted(tmp_path.iterdir())]
    assert len(recs) == 2 * 33
    assert {(r["arch"], r["shape"], r["devices"]) for r in recs} == \
        {(a, s, n) for a, s in CELLS for n in (256, 512)}
    for r in recs:
        assert r["status"] == "ok"
        assert (r["collectives"] is None) == (r["collective_wire_bytes"] is None) == \
            (r["unsupported"] is not None)
        assert r["unsupported"] is None or r["unsupported"].split(":")[0] in (
            "check_tp", "check_mesh", "plan")
    assert sum(r["collectives"] is not None for r in recs) > 20
    assert "dry-run complete: 66 ok, 0 failed" in capsys.readouterr().out
    assert dryrun.main(["--arch", "jamba-1.5-large-398b", "--shape", "decode_32k",
                        "--mesh-shape", "1", "4", "--skip-probes", "--out", str(tmp_path)]) == 0
    assert (tmp_path / "jamba-1.5-large-398b__decode_32k__d1m4__bf16.json").exists()
