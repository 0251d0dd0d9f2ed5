"""Production meshes and per-architecture parallelism plans.

Counterpart of :mod:`repro.launch.mesh`.  :func:`make_production_mesh`
and :func:`make_pp_mesh` are functions (importing this module touches no
device and no process group): they build a ``DeviceMesh`` of the
reference's shapes and axis names over the default process group, and
raise naming the world size they need when the group is another size.
The reference's 16 x 16 pod is TPU v5e's; the shapes are kept as the
reference's so that :func:`plan` decides as it does.

:func:`stand_in_mesh` gives the same shapes with no device and no process
group (:class:`StandInMesh`: the axis names and shape alone), which is all
that :func:`plan` and the dry run read.

``plan(cfg, cell, mesh)`` centralizes the per-architecture decisions: the
rule table (tensor parallelism everywhere; FSDP over ``data`` on the train
path; KV-head sharding only when the GQA group structure survives padding;
expert sharding only when the experts divide the model axis), sequence
sharding for long-context decode (a batch smaller than the data ways
shards the KV sequence instead), and the microbatch count.  It reads only
``axis_names`` and ``devices.shape`` of anything else (a stand-in mesh of
256 or 512 devices), or a ``DeviceMesh``'s names and shape.

The reference's ``set_mesh``, ``jit_shardings`` and ``cost_analysis`` are
shims over JAX versions; they have no counterpart here.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models.attention import attn_dims
from repro_torch.sharding import partitioning as P


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The 16 x 16 ``(data, model)`` mesh, or 2 x 16 x 16 ``(pod, data,
    model)`` with ``multi_pod``, over the default process group."""
    from repro_torch.distributed.mesh import device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return device_mesh(device, shape, axes)


@dataclasses.dataclass(frozen=True)
class _Devices:
    shape: tuple

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass(frozen=True)
class StandInMesh:
    """A mesh's ``axis_names`` and shape (``devices.shape``, ``devices.size``)
    with no device behind it: what :func:`plan` and the dry run read."""

    axis_names: tuple
    shape: tuple

    @property
    def devices(self) -> _Devices:
        return _Devices(tuple(self.shape))


def stand_in_mesh(*, multi_pod: bool = False, mesh_shape=None) -> StandInMesh:
    """The production mesh's names and shape (16 x 16 ``(data, model)``, or
    2 x 16 x 16 ``(pod, data, model)`` with ``multi_pod``), or a ``(data,
    model)`` mesh of ``mesh_shape``, as a :class:`StandInMesh`."""
    if mesh_shape is not None:
        return StandInMesh(("data", "model"), tuple(mesh_shape))
    if multi_pod:
        return StandInMesh(("pod", "data", "model"), (2, 16, 16))
    return StandInMesh(("data", "model"), (16, 16))


def make_pp_mesh(*, stages: int = 2, data: int = 16, model: int = 16, device="cuda"):
    """The ``(pipe, data, model)`` mesh over the default process group."""
    from repro_torch.distributed.mesh import device_mesh

    return device_mesh(device, (stages, data, model), ("pipe", "data", "model"))


@dataclasses.dataclass(frozen=True)
class Plan:
    rules: dict
    tp: int
    microbatches: int
    notes: str


def plan(cfg: ModelConfig, cell: ShapeCell, mesh) -> Plan:
    axes = P.mesh_sizes(mesh)
    tp = axes.get("model", 1)
    data_axes = tuple(a for a in ("pod", "data") if a in axes)

    _, _, shard_kv = attn_dims(cfg, tp)
    shard_experts = bool(cfg.n_experts) and cfg.n_experts % tp == 0

    seq_axis = None
    notes = []
    if cell.kind == "decode" and cell.global_batch < _data_ways(axes):
        # long-context single-sequence decode: shard the KV sequence axis
        # instead of the (too small) batch axis; every data-like axis moves
        # to the sequence dim
        seq_axis = data_axes
        data_axes = ()
        notes.append("seq-parallel KV (flash-decoding combine)")

    fsdp = cell.kind == "train"
    if fsdp:
        notes.append("FSDP over data axis (params+grads+moments sharded)")

    rules = P.base_rules(
        fsdp=fsdp,
        data_axes=data_axes or (),
        model_axis="model",
        shard_kv_heads=shard_kv,
        shard_experts=shard_experts,
        seq_axis=seq_axis,
    )

    mb = 1
    if cell.kind == "train":
        mb = _pick_microbatches(cfg, cell, axes)
        notes.append(f"microbatches={mb}")
    return Plan(rules=rules, tp=tp, microbatches=mb, notes="; ".join(notes))


def _data_ways(axes: dict) -> int:
    return axes.get("pod", 1) * axes.get("data", 1)


def _pick_microbatches(cfg: ModelConfig, cell: ShapeCell, axes: dict) -> int:
    """Keep a device's live activation tokens within a ~2 GB budget: live
    activations with superblock remat ≈ tokens/device × d_model ×
    block_period × 2 B × ~4 residual copies (the reference's arithmetic)."""
    dev_batch = max(1, cell.global_batch // _data_ways(axes))
    tokens = dev_batch * cell.seq_len
    budget = int(2e9)
    per_token = cfg.d_model * max(cfg.block_period, 1) * 2 * 4
    mb = 1
    while tokens // mb * per_token > budget and mb < dev_batch:
        mb *= 2
    return min(mb, dev_batch)
