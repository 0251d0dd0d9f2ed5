"""The port's partitioning, padding, mesh plans and transfer helpers against
the reference's (no process is spawned; tests/test_torch_tp.py runs ranks).

Held, entry for entry: ``base_rules`` for every flag combination;
``spec_for`` on every leaf of ``specs(cfg, tp)`` (the port's per-layer
leaves in the reference's stacked layout) for all ten configs at tp 1, 2,
3 and 16 with FSDP on and off, with the leaves' shapes; ``attn_dims``,
``padded_vocab`` and ``valid_dim0`` (the port zeroes the pad rows it draws,
as the reference's ``_init_normal`` does for a spec that sets it); every
weight format's ``data_axes`` / ``scale_axes`` and every cache format's
``data_axes`` / ``flat_cache_axes``, paged ones included; ``cache_axes_table``
and the cache's partition entries; ``plan()`` for every config and shape
cell on the production, multi-pod and pipeline mesh shapes (stand-in meshes
for both packages); each rank's leaf bytes against ``NamedSharding(...)
.shard_shape`` on Auto-typed (1, 2) and (2, 4) meshes of the forced CPU
devices, converted states included; ``balanced_feed_order`` and
``streamed_weight_bytes``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding

from repro.configs import ARCH_NAMES as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import kvcache as ref_kvcache
from repro.core import residency as ref_residency
from repro.core import transfer as ref_transfer
from repro.launch import mesh as ref_mesh
from repro.models import attention as ref_attention
from repro.models import model as ref_model
from repro.sharding import partitioning as RP
from repro_torch import configs, convert
from repro_torch import tree as tree_lib
from repro_torch.core import kvcache, residency, transfer
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention
from repro_torch.models import model as model_lib
from repro_torch.sharding import partitioning as P

TPS = (1, 2, 3, 16)


def _entries(pspec) -> tuple:
    return tuple(pspec)


class StandIn:
    """A mesh of ``shape`` with ``names``: what ``plan`` and the byte
    counts read (``axis_names``, ``devices.shape``)."""

    def __init__(self, shape, names, devices=None):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, object) if devices is None else devices


@pytest.mark.parametrize("fsdp,shard_kv,shard_experts,seq", list(itertools.product(
    (False, True), (False, True), (False, True), (None, "data", ("pod", "data")))))
@pytest.mark.parametrize("data_axes", [("pod", "data"), ("data",), ()])
def test_base_rules_match_reference(fsdp, shard_kv, shard_experts, seq, data_axes):
    kw = dict(fsdp=fsdp, data_axes=data_axes, shard_kv_heads=shard_kv,
              shard_experts=shard_experts, seq_axis=seq)
    assert P.base_rules(**kw) == RP.base_rules(**kw)


def _ref_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _port_in_ref_layout(cfg, tp):
    """The port's ``specs(cfg, tp)`` leaves in the reference's layout:
    ``path → (shape, axes)`` with the stacked leaves' ``layers`` axis."""
    out = {}
    for path, leaf in tree_lib.flatten(convert.reference_layout(model_lib.specs(cfg, tp), cfg)):
        if isinstance(leaf, convert.Stacked):
            out[path] = (leaf.shape, ("layers",) + tuple(leaf[0].axes))
        else:
            out[path] = (tuple(leaf.shape), tuple(leaf.axes))
    return out


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_specs_and_spec_for_match_reference(arch, tp):
    """Every leaf: shape, logical axes, and its partition entries under the
    rules with FSDP off and on."""
    ref_cfg, cfg = ref_get_config(arch), configs.get_config(arch)
    want = {path: s for path, s in _ref_leaves(ref_model.specs(ref_cfg, tp))}
    got = _port_in_ref_layout(cfg, tp)
    assert sorted(got) == sorted(want)
    shard_kv = ref_attention.attn_dims(ref_cfg, tp)[2]
    for fsdp in (False, True):
        rules = RP.base_rules(fsdp=fsdp, shard_kv_heads=shard_kv)
        for path, spec in want.items():
            shape, axes = got[path]
            assert (shape, axes) == (tuple(spec.shape), tuple(spec.axes)), path
            assert P.spec_for(axes, rules) == _entries(RP.spec_for(spec.axes, rules)), path


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_attn_dims_and_padded_vocab_match_reference(arch, tp):
    ref_cfg, cfg = ref_get_config(arch), configs.get_config(arch)
    assert attention.attn_dims(cfg, tp) == ref_attention.attn_dims(ref_cfg, tp)
    assert attention.mla_dims(cfg, tp) == ref_attention.mla_dims(ref_cfg, tp)
    assert model_lib.padded_vocab(cfg, tp) == ref_model.padded_vocab(ref_cfg, tp)
    assert P.pad_dim(cfg.vocab_size, tp) == RP.pad_dim(ref_cfg.vocab_size, tp)
    assert P.maybe_pad_heads(cfg.n_heads, tp) == RP.maybe_pad_heads(ref_cfg.n_heads, tp)


def test_shard_info_matches_reference():
    for shape in ({}, {"model": 4}, {"pod": 2, "data": 16, "model": 16}):
        assert P.shard_info(shape) == RP.shard_info(shape)


def test_valid_dim0_pads_heads_and_vocab():
    """qwen3-1.7b's smoke config at tp = 3: ``wo``'s rows past the 4 real
    heads and the embedding's past the 512 real ids are marked and drawn as
    zeros, the rows the reference's ``_init_normal`` zeroes for the same
    ``valid_dim0``; at tp = 2 nothing pads."""
    cfg = configs.get_smoke_config("qwen3-1.7b").scaled(dtype=torch.float32)
    spec = model_lib.specs(cfg, 3)
    wo = spec["layers"][0]["mixer"]["wo"]
    emb = spec["embed"]["embedding"]
    assert (wo.shape, wo.valid_dim0) == ((6 * cfg.d_head, cfg.d_model), 4 * cfg.d_head)
    assert (emb.shape, emb.valid_dim0) == ((513, cfg.d_model), 512)
    assert all(s.valid_dim0 is None for _, s in tree_lib.flatten(model_lib.specs(cfg, 2)))
    drawn = model_lib.materialize(cfg, device="cpu", tp=3)
    ref = RP._INITIALIZERS["normal"](jax.random.PRNGKey(1), RP.ParamSpec(
        wo.shape, jnp.float32, ("heads", "embed"), valid_dim0=wo.valid_dim0))
    for got in (drawn["layers"][0]["mixer"]["wo"], drawn["layers"][1]["mixer"]["wo"]):
        assert np.array_equal(got.numpy() == 0, np.asarray(ref) == 0)
    assert not drawn["embed"]["embedding"][512].any() and drawn["embed"]["embedding"][511].any()


@pytest.mark.parametrize("mode", list(residency.formats()))
def test_weight_format_axes_match_reference(mode):
    fmt, ref = residency.get_format(mode), ref_residency.get_format(mode)
    for k_ax, n_ax in (("embed", "heads"), ("heads", "embed"), ("mlp", "embed"), (None, "mlp")):
        assert fmt.data_axes(k_ax, n_ax) == tuple(ref.data_axes(k_ax, n_ax))
        assert fmt.scale_axes(n_ax) == tuple(ref.scale_axes(n_ax))
        assert len(fmt.data_axes(k_ax, n_ax)) == fmt.abstract_state(64, 64).data.ndim


@pytest.mark.parametrize("name", list(kvcache.formats()))
def test_cache_format_axes_match_reference(name):
    fmt, ref = kvcache.get_cache_format(name), ref_kvcache.get_cache_format(name)
    for lead in (("kv_heads_cache",), ()):
        assert fmt.data_axes(lead) == {k: tuple(v) for k, v in ref.data_axes(lead).items()}
        for prefix in ("k", "v", "c_kv"):
            assert fmt.flat_cache_axes(prefix, lead) == {
                k: tuple(v) for k, v in ref.flat_cache_axes(prefix, lead).items()}


@pytest.mark.parametrize("name", list(kvcache.formats()))
def test_cache_axes_table_and_pspecs_match_reference(name):
    """The table, and the partition entries of every leaf of qwen3-1.7b's
    smoke cache at tp = 2 (the port's per-layer leaves against the
    reference's stacked ones, whose leading layer entry is None)."""
    ref_cfg = ref_smoke_config("qwen3-1.7b").scaled(cache_format=name)
    cfg = configs.get_smoke_config("qwen3-1.7b").scaled(cache_format=name)
    assert P.cache_axes_table(cfg) == {k: tuple(v)
                                       for k, v in RP.cache_axes_table(ref_cfg).items()}
    assert P.cache_axes_table() == {k: tuple(v) for k, v in RP.cache_axes_table().items()}
    rules = RP.base_rules(data_axes=("data",))
    want = RP.cache_pspecs(jax.eval_shape(lambda: ref_model.init_cache(ref_cfg, 2, 16, tp=2)),
                           rules, True, ref_cfg)
    want = {path[-1]: _entries(s) for path, s in _ref_leaves(want["stack"]["slot0"])}
    caches = model_lib.init_cache(cfg, 2, 16, device="meta", tp=2, local=False)
    got = P.cache_pspecs(caches, P.base_rules(data_axes=("data",)), True, cfg)
    for layer in got:
        assert {k: (None,) + v for k, v in layer.items()} == want


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_plan_matches_reference(arch):
    ref_cfg, cfg = ref_get_config(arch), configs.get_config(arch)
    meshes = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
              ((2, 16, 16), ("pipe", "data", "model"))]
    for shape, names in meshes:
        for cell in REF_SHAPES:
            want = ref_mesh.plan(ref_cfg, REF_SHAPES[cell], StandIn(shape, names))
            got = mesh_lib.plan(cfg, configs.SHAPES[cell], StandIn(shape, names))
            assert (got.rules, got.tp, got.microbatches, got.notes) == (
                want.rules, want.tp, want.microbatches, want.notes), (shape, cell)


def test_mesh_builders_name_the_world_they_need():
    """In a process group of one rank the builders refuse, naming the world
    size each mesh needs."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="world of 256 ranks"):
            mesh_lib.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="world of 512 ranks"):
            mesh_lib.make_production_mesh(multi_pod=True, device="cpu")
        with pytest.raises(ValueError, match="world of 512 ranks"):
            mesh_lib.make_pp_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _auto_mesh(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:int(np.prod(shape))])


def _ref_shard_bytes(sharding, shape, itemsize):
    return int(np.prod(sharding.shard_shape(tuple(shape)))) * itemsize


@pytest.mark.parametrize("fsdp", (False, True))
@pytest.mark.parametrize("shape", [(1, 2), (2, 4)])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "starcoder2-3b", "qwen1.5-32b", "mixtral-8x7b",
                                  "deepseek-v2-lite-16b", "falcon-mamba-7b"])
def test_rank_bytes_match_named_sharding(arch, shape, fsdp):
    """Each leaf's bytes a rank (``local_shape``) against the reference's
    ``NamedSharding.shard_shape`` for the same entries, on meta tensors of
    the full config's shapes; a dim that does not divide raises in both."""
    ref_cfg, cfg = ref_get_config(arch), configs.get_config(arch)
    tp = shape[1]
    mesh = _auto_mesh(shape)
    rules = RP.base_rules(data_axes=("data",), fsdp=fsdp,
                          shard_kv_heads=ref_attention.attn_dims(ref_cfg, tp)[2])
    sizes = dict(zip(("data", "model"), shape))
    for path, spec in tree_lib.flatten(model_lib.specs(cfg, tp)):
        entries = P.spec_for(spec.axes, rules)
        sharding = NamedSharding(mesh, RP.spec_for(spec.axes, rules))
        try:
            want = _ref_shard_bytes(sharding, spec.shape, 1)
        except ValueError:
            with pytest.raises(ValueError):
                P.local_shape(spec.shape, entries, sizes)
            continue
        assert int(np.prod(P.local_shape(spec.shape, entries, sizes))) == want, path


@pytest.mark.parametrize("mode", ["w8a8", "ffn=bsdp_fused,mixer=w8a16", "ffn=bsdp,mixer=w4a8"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 4)])
def test_converted_rank_bytes_match_named_sharding(mode, shape):
    """qwen3-1.7b converted (meta states): a rank's bytes (``local_bytes``)
    against the reference's shard shapes of each payload and scale under
    its format's ``partition_spec`` / ``scale_axes``."""
    cfg = configs.get_config("qwen3-1.7b")
    spec_tree = model_lib.specs(cfg, shape[1])
    meta = dryrun.serve_params_meta(cfg, mode, tp=shape[1])
    mesh = _auto_mesh(shape)
    rules = RP.base_rules(data_axes=("data",))
    want = 0
    for (path, leaf), (_, spec) in zip(tree_lib.flatten(meta), tree_lib.flatten(spec_tree)):
        if isinstance(leaf, residency.QuantLinearState):
            fmt = ref_residency.get_format(leaf.mode)
            k_ax, n_ax = spec.axes
            parts = ((leaf.data, fmt.partition_spec(k_ax, n_ax, rules)),
                     (leaf.scale, RP.spec_for(fmt.scale_axes(n_ax), rules)))
        else:
            parts = ((leaf, RP.spec_for(spec.axes, rules)),)
        for t, pspec in parts:
            want += _ref_shard_bytes(NamedSharding(mesh, pspec), t.shape, t.element_size())
    assert P.local_bytes(meta, spec_tree, StandIn(shape, ("data", "model")), rules) == want


class _Dev:
    def __init__(self, i, host):
        self.id, self.process_index = i, host


def test_balanced_feed_order_matches_reference():
    """16 devices on 4 hosts, laid out host-major and interleaved."""
    for hosts in ([i // 4 for i in range(16)], [i % 4 for i in range(16)]):
        devs = np.array([_Dev(i, h) for i, h in enumerate(hosts)], object).reshape(4, 4)
        mesh = StandIn((4, 4), ("data", "model"), devs)
        assert transfer.balanced_feed_order(mesh) == ref_transfer.balanced_feed_order(mesh)


def test_streamed_weight_bytes_matches_reference():
    ref_cfg = ref_smoke_config("qwen3-1.7b").scaled(dtype=jnp.float32)
    cfg = configs.get_smoke_config("qwen3-1.7b").scaled(dtype=torch.float32)
    ref_params = RP.materialize(ref_model.specs(ref_cfg, 1), jax.random.PRNGKey(0))
    port = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    assert transfer.streamed_weight_bytes(port) == ref_transfer.streamed_weight_bytes(ref_params)
    from repro_torch.serve import engine
    from repro.serve import engine as ref_engine

    conv = engine.convert_params(port, cfg, "w8a8", min_dim=16)
    ref_conv = ref_engine.convert_params(ref_params, ref_cfg, "w8a8", min_dim=16)
    assert transfer.streamed_weight_bytes(conv) == ref_transfer.streamed_weight_bytes(ref_conv)


def test_placements_name_the_sharded_dims():
    from torch.distributed.tensor import Replicate, Shard

    mesh = StandIn((2, 2, 4), ("pod", "data", "model"))
    assert P.placements((("pod", "data"), "model"), mesh) == [Shard(0), Shard(0), Shard(1)]
    assert P.placements((None, None), mesh) == [Replicate()] * 3


def test_engine_and_models_refuse_what_tensor_parallelism_does_not_cover():
    """tp > 1 without a mesh or on a mesh whose model axis is another size
    raises; a data axis serves (``tests/test_torch_data_axis.py``), a paged
    cache format and the ``prefix_cache`` scheduler included
    (``tests/test_torch_paged_data.py``), but for what the engine refuses
    there: slots the data ways do not divide, rules whose ``kv_seq`` is
    set, and a mesh axis the rules do not name (a mesh is never ignored, at
    tp = 1 too); the dry run counts a sequence-parallel decode of every
    mixer, MLA, cross and paged layers included (one MAX and one SUM a
    ring, none a cross-only or Mamba layer), and training MLA, MoE, Mamba or cross
    layers (a Mamba layer where the model axis divides its d_inner); at tp
    = 1 nothing is checked."""
    from repro_torch.configs import SHAPES
    from repro_torch.distributed.mesh import TensorParallel
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve import engine

    cfg = configs.get_smoke_config("qwen3-1.7b").scaled(dtype=torch.float32)
    params = model_lib.materialize(cfg, device="cpu", tp=2)
    with pytest.raises(ValueError, match="needs a mesh"):
        engine.ServeEngine(params, cfg, tp=2, device="cpu")
    for tp, shape in ((2, (2, 2)), (1, (2, 1))):
        mesh = StandIn(shape, ("data", "model"))
        with pytest.raises(ValueError, match="do not divide .* Known differences"):
            engine.ServeEngine(params, cfg, tp=tp, mesh=mesh, slots=3, device="cpu")
        for fmt in ("paged_int4_bp_fused", "paged_bf16", None):  # the pool whole on each rank
            paged = cfg.scaled(cache_format=fmt)
            assert engine._mesh_plan(paged, tp, None, mesh, slots=4)[1:] == (("data",), 2)
        rules = mesh_lib.plan(cfg, SHAPES["long_500k"], mesh).rules
        assert rules["kv_seq"] == ("data",) and rules["batch"] == ()
        with pytest.raises(NotImplementedError, match="kv_seq .* Known differences"):
            engine.ServeEngine(params, cfg, tp=tp, mesh=mesh, rules=rules, device="cpu")
        with pytest.raises(ValueError, match="shard nothing"):
            engine.ServeEngine(params, cfg, tp=tp, mesh=mesh, device="cpu",
                               rules=P.base_rules(data_axes=()))
    with pytest.raises(ValueError, match="model axis"):
        engine.ServeEngine(params, cfg, tp=2, mesh=StandIn((1, 4), ("data", "model")),
                           device="cpu")
    with pytest.raises(ValueError, match="model axis"):
        engine.ServeEngine(params, cfg, mesh=StandIn((2, 2), ("data", "model")), device="cpu")
    seq_rules = mesh_lib.plan(cfg, SHAPES["long_500k"], StandIn((2, 1), ("data", "model"))).rules
    for arch in ("minicpm3-4b", "deepseek-v2-lite-16b", "llama-3.2-vision-11b",
                 "seamless-m4t-medium", "qwen3-1.7b", "mixtral-8x7b", "falcon-mamba-7b",
                 "jamba-1.5-large-398b"):  # MLA's latent ring, cross layers, paged rings
        for fmt in (None, "paged_int8"):
            one = configs.get_smoke_config(arch).scaled(cache_format=fmt)
            rings = sum(one.mixer_kind(i) in ("attn", "attn_cross") for i in range(one.n_layers))
            ev = dryrun.call_collectives(one, "bf16", "decode", batch=1, seq=1, tp=1,
                                         rules=seq_rules, mesh_axes={"data": 2, "model": 1})
            assert [e.kind for e in ev] == ["all-reduce"] * 2 * rings, arch
    for arch in ("minicpm3-4b", "deepseek-v2-lite-16b", "falcon-mamba-7b",
                 "llama-3.2-vision-11b", "seamless-m4t-medium", "mixtral-8x7b",
                 "jamba-1.5-large-398b"):
        other = configs.get_smoke_config(arch)
        model_lib.check_tp(other, None)
        model_lib.check_tp(other, TensorParallel(size=1, rank=0))
        model_lib.check_tp(other, TensorParallel(size=2, rank=0))  # serves and trains
        if arch in ("falcon-mamba-7b", "jamba-1.5-large-398b"):
            with pytest.raises(ValueError, match="d_inner"):
                model_lib.check_tp(other, TensorParallel(size=3, rank=0))
    einsum = configs.get_smoke_config("mixtral-8x7b").scaled(moe_impl="einsum")
    with pytest.raises(NotImplementedError, match="einsum"):
        model_lib.check_tp(einsum, TensorParallel(size=2, rank=0))
    model_lib.check_tp(cfg, TensorParallel(size=2, rank=0))
