"""Logical-axis partitioning: sharding rules, per-rank shards, padding.

Counterpart of :mod:`repro.sharding.partitioning`.  The models never name
mesh axes: every parameter's :class:`~repro_torch.models.model.ParamSpec`
carries *logical* axis names (``"embed"``, ``"heads"``, ``"mlp"``,
``"vocab"``, ``"expert"`` ...), and a rule table (:func:`base_rules`) maps
them to mesh axes.  :func:`spec_for` turns a leaf's axes into its
partition entries, one per tensor dim: ``None`` (replicated), a mesh axis
name, or a tuple of names (sharded over their product, the first the
outermost).  The entries are plain tuples here, the reference's
``PartitionSpec`` with the same entries.

Where the reference hands the entries to GSPMD, which places shards and
inserts the collectives, the port cuts the shards itself:
:func:`shard_tree` gives each rank its own slice of every leaf (a plain
slice of the global tensor, so no rank funnels the whole tensor through
another), and the model code (:mod:`repro_torch.models`) issues the
collectives that the reference's global semantics imply.
:func:`placements` gives the same layout as DTensor placements.
:func:`constrain` is therefore the identity: the explicit layer code fixes
every activation's layout.  The inverse, :func:`gather_tree`, puts every
rank's shards back into the global tree (checkpoints, tests), and
:func:`gather_on_use` gathers a tree's FSDP shards for the compute that
uses them, differentiably (the gradient reduce-scattered back to the
shards); :func:`flat_index` places a shard's elements in its global
leaf's row-major order (the int8 optimizer moments' chunk grid).

A leaf whose last axis fuses equal blocks (SwiGLU's ``[gate; up]``,
Mamba's ``[x; z]``; ``ParamSpec.fused``) is cut block by block, so each
rank's gate and up columns stay paired.  GSPMD cuts the global axis in
one piece and reshuffles at the split; the port's layout differs, its bytes
a rank do not.

Padding-to-shardable (:func:`pad_dim`, :func:`maybe_pad_heads`): head and
vocab dims that do not divide the model axis pad up to a multiple of it;
:mod:`repro_torch.models` zeroes the pad rows it draws (``valid_dim0``)
and masks the pad logits.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import torch

Axes = tuple[Optional[str], ...]
MeshAxes = Union[None, str, tuple[str, ...]]
Entry = Union[None, str, tuple[str, ...]]


def base_rules(
    *,
    fsdp: bool = False,
    data_axes: tuple[str, ...] = ("pod", "data"),
    model_axis: str = "model",
    shard_kv_heads: bool = True,
    shard_experts: bool = True,
    seq_axis: Optional[str] = None,
) -> dict[str, MeshAxes]:
    """Logical-name → mesh-axes rule table (the reference's, entry for
    entry).  ``fsdp=True`` also shards the large replicated weight axes over
    ``data`` (ZeRO-3 style)."""
    fsdp_axis = "data" if fsdp else None
    return {
        # activations
        "batch": data_axes,
        "seq": seq_axis,  # context parallelism when set
        "kv_seq": seq_axis,
        "act_embed": None,
        "act_heads": model_axis,
        "act_mlp": model_axis,
        "act_vocab": model_axis,
        # parameters
        "embed": fsdp_axis,  # contraction dim of most projections
        "heads": model_axis,
        "kv_heads": model_axis if shard_kv_heads else None,
        "head_dim": None,
        "mlp": model_axis,
        "moe_mlp": model_axis if not shard_experts else None,
        "vocab": model_axis,
        "expert": model_axis if shard_experts else None,
        "kv_lora": None,
        "layers": None,  # the reference's scan axis: never sharded
        "conv": None,
        "ssm_state": None,
        "dt_rank": None,
        "norm": None,
    }


def spec_for(axes: Axes, rules: Mapping[str, MeshAxes]) -> tuple[Entry, ...]:
    """Logical axes → one partition entry a dim, dropping duplicate mesh axes.

    A mesh axis appears at most once: when two logical axes map to the same
    mesh axis, the later occurrence is dropped (replicated), as t5x does."""
    used: set[str] = set()
    entries: list[Entry] = []
    for name in axes:
        if name is None:
            entries.append(None)
            continue
        if name not in rules:
            raise KeyError(f"no sharding rule for logical axis {name!r}")
        target = rules[name]
        if target is None:
            entries.append(None)
            continue
        tgt = (target,) if isinstance(target, str) else tuple(target)
        tgt = tuple(t for t in tgt if t not in used)
        used.update(tgt)
        if not tgt:
            entries.append(None)
        elif len(tgt) == 1:
            entries.append(tgt[0])
        else:
            entries.append(tgt)
    return tuple(entries)


def constrain(x: torch.Tensor, axes: Axes, rules: Mapping[str, MeshAxes]) -> torch.Tensor:
    """The identity.  The reference's ``with_sharding_constraint`` asks GSPMD
    for a layout; here the layer code that made ``x`` already holds it in the
    layout its collectives produce."""
    del axes, rules
    return x


# ---------------------------------------------------------------------------
# Meshes: the sizes and this rank's coordinates
# ---------------------------------------------------------------------------


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name → size, of a ``DeviceMesh`` or of anything with
    ``axis_names`` and ``devices.shape`` (a stand-in mesh, the reference's
    ``Mesh``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def mesh_coords(mesh) -> dict[str, int]:
    """Axis name → this rank's coordinate on a ``DeviceMesh``."""
    coords = mesh.get_coordinate()
    if coords is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coords))


def _part(entry: Entry, sizes: Mapping[str, int],
          coords: Mapping[str, int]) -> tuple[int, int]:
    """(parts, index) of one dim's entry: a tuple entry shards over the
    product of its axes, the first the outermost (pod-major)."""
    if entry is None:
        return 1, 0
    names = (entry,) if isinstance(entry, str) else entry
    parts, index = 1, 0
    for name in names:
        parts, index = parts * sizes[name], index * sizes[name] + coords[name]
    return parts, index


def local_shape(shape: Sequence[int], spec: Sequence[Entry],
                sizes: Mapping[str, int]) -> tuple[int, ...]:
    """A rank's shard shape of a ``shape`` leaf partitioned by ``spec``."""
    out = []
    for n, entry in zip(shape, spec):
        parts, _ = _part(entry, sizes, {k: 0 for k in sizes})
        if n % parts:
            raise ValueError(f"dim of {n} does not divide {parts} ways ({entry!r})")
        out.append(n // parts)
    return tuple(out)


def shard_index(shape: Sequence[int], spec: Sequence[Entry], sizes: Mapping[str, int],
                coords: Mapping[str, int], *, fused_dim: int = -1, fused: int = 1) -> tuple:
    """Index of this rank's shard of a ``shape`` leaf partitioned by
    ``spec``: a slice a dim, except that a dim ``fused_dim`` made of
    ``fused`` equal blocks gets an index tensor taking the rank's share of
    each block."""
    fused_dim %= len(shape) if shape else 1
    idx: list = []
    for d, (n, entry) in enumerate(zip(shape, spec)):
        parts, index = _part(entry, sizes, coords)
        blocks = fused if d == fused_dim else 1
        if n % (parts * blocks):
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide {parts} ways "
                             f"({entry!r})")
        if blocks > 1 and parts > 1:
            block, part = n // blocks, n // blocks // parts
            idx.append(torch.cat([torch.arange(b * block + index * part,
                                               b * block + (index + 1) * part)
                                  for b in range(blocks)]))
        else:
            step = n // parts
            idx.append(slice(index * step, (index + 1) * step))
    return tuple(idx)


def take_index(t: torch.Tensor, index: tuple) -> torch.Tensor:
    """``t`` at a :func:`shard_index` index (the slices as a view; an index
    tensor, if any, copies)."""
    out = t[tuple(slice(None) if isinstance(i, torch.Tensor) else i for i in index)]
    for d, i in enumerate(index):
        if isinstance(i, torch.Tensor):
            out = out.index_select(d, i.to(t.device))
    return out


def placements(spec: Sequence[Entry], mesh) -> list:
    """DTensor placements of a :func:`spec_for` result over ``mesh``: for each
    mesh dim, ``Shard(d)`` for the tensor dim ``d`` it shards, else
    ``Replicate()``.  A tensor dim sharded over several mesh axes (``("pod",
    "data")``) is ``Shard(d)`` on each of them; DTensor nests them in mesh
    order, which is pod-major for the reference's meshes, as JAX's tuple
    entry."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_sizes(mesh))
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(name)] = Shard(d)
    return out


# ---------------------------------------------------------------------------
# Whole trees
# ---------------------------------------------------------------------------


def leaf_entries(leaf, spec, rules: Mapping[str, MeshAxes]) -> dict[str, tuple]:
    """Partition entries of one parameter leaf: ``{"": ...}`` for a tensor;
    ``{"data": ..., "scale": ...}`` for a residency state, from its format's
    ``data_axes`` / ``scale_axes`` over the float leaf's (K, N) axes (a
    stacked expert state keeps its leading axis)."""
    from repro_torch.core import residency

    if isinstance(leaf, residency.QuantLinearState):
        fmt = residency.get_format(leaf.mode)
        lead, (k_ax, n_ax) = tuple(spec.axes[:-2]), spec.axes[-2:]
        return {"data": spec_for(lead + tuple(fmt.data_axes(k_ax, n_ax)), rules),
                "scale": spec_for(lead + tuple(fmt.scale_axes(n_ax)), rules)}
    return {"": spec_for(spec.axes, rules)}


def shard_leaf(leaf, spec, sizes: Mapping[str, int], coords: Mapping[str, int],
               rules: Mapping[str, MeshAxes], place=None):
    """This rank's shard of one parameter leaf.  ``place(t, index)`` moves the
    shard at ``index`` of the global tensor ``t`` to the rank's device
    (default: :func:`take_index`, on ``t``'s device).  A residency state's
    ``k`` / ``n`` become the shard's."""
    from repro_torch.core import residency

    place = place or take_index
    entries = leaf_entries(leaf, spec, rules)
    if not isinstance(leaf, residency.QuantLinearState):
        return place(leaf, shard_index(leaf.shape, entries[""], sizes, coords,
                                       fused=spec.fused))
    fmt = residency.get_format(leaf.mode)
    lead = len(spec.axes) - 2
    data_spec, scale_spec = entries["data"], entries["scale"]
    data = place(leaf.data, shard_index(leaf.data.shape, data_spec, sizes, coords,
                                        fused_dim=lead + fmt.data_n_axis, fused=spec.fused))
    scale = place(leaf.scale, shard_index(leaf.scale.shape, scale_spec, sizes, coords,
                                          fused=spec.fused))
    k = leaf.k
    if fmt.data_n_axis == 1:  # the payload's K rows shard with the float's K axis
        k //= _part(data_spec[lead], sizes, coords)[0]
    return residency.QuantLinearState(data=data, scale=scale, mode=leaf.mode, k=k,
                                      n=leaf.n // _part(scale_spec[-1], sizes, coords)[0])


def shard_tree(tree, spec_tree, mesh, rules: Mapping[str, MeshAxes], *, place=None):
    """This rank's shards of a parameter tree (float tensors and residency
    states alike) laid out by ``spec_tree`` (the ParamSpecs of
    ``model.specs(cfg, tp)``), the rank's place on the ``DeviceMesh``
    ``mesh`` its coordinates; ``place`` as for :func:`shard_leaf`."""
    sizes, coords = mesh_sizes(mesh), mesh_coords(mesh)
    return map_specs(tree, spec_tree,
                  lambda leaf, spec: shard_leaf(leaf, spec, sizes, coords, rules, place))


def local_bytes(tree, spec_tree, mesh, rules: Mapping[str, MeshAxes]) -> int:
    """A rank's bytes of a parameter tree of real or meta tensors and states
    (every rank's are equal: every dim divides its parts), without cutting
    anything."""
    from repro_torch.core import residency

    sizes = mesh_sizes(mesh)

    def one(leaf, spec):
        entries = leaf_entries(leaf, spec, rules)
        if isinstance(leaf, residency.QuantLinearState):
            parts = ((leaf.data, entries["data"]), (leaf.scale, entries["scale"]))
        else:
            parts = ((leaf, entries[""]),)
        total = 0
        for t, entry in parts:
            n = 1
            for s in local_shape(t.shape, entry, sizes):
                n *= s
            total += n * t.element_size()
        return total

    leaves: list = []
    map_specs(tree, spec_tree, lambda leaf, spec: leaves.append(one(leaf, spec)))
    return sum(leaves)


def sharded_dims(spec, rules: Mapping[str, MeshAxes],
                 sizes: Mapping[str, int]) -> list[tuple[int, str]]:
    """(dim, mesh axis) of every mesh axis above size 1 that shards a dim of
    a parameter of ParamSpec ``spec``, the outermost of a tuple entry
    first; empty for a leaf every rank holds whole."""
    out = []
    for d, entry in enumerate(spec_for(spec.axes, rules)):
        for name in () if entry is None else ((entry,) if isinstance(entry, str) else entry):
            if sizes.get(name, 1) > 1:
                out.append((d, name))
    return out


def gather_leaf(t: torch.Tensor, spec, view, rules: Mapping[str, MeshAxes]) -> torch.Tensor:
    """The global tensor of a float parameter of ``spec`` from every rank's
    shard ``t`` (the inverse of :func:`shard_leaf`; a collective over each
    axis that shards it, on every rank of ``view``, a
    :class:`~repro_torch.distributed.mesh.MeshView`).  Not differentiable."""
    entries = spec_for(spec.axes, rules)
    sizes = view.sizes
    axes = [name for _, name in sharded_dims(spec, rules, sizes)]
    if not axes:
        return t
    # every rank's shard, keyed by its coordinates on the sharding axes
    parts = t[None]
    for name in axes:
        parts = torch.stack(view.axes[name].all_gather_list(parts), dim=0)
    parts = parts.reshape((-1,) + tuple(t.shape))
    out = t.new_empty(tuple(spec.shape))
    combos = [()]
    for name in axes:  # row-major over the axes: the order of the gathers, reversed
        combos = [c + (r,) for r in range(sizes[name]) for c in combos]
    for part, combo in zip(parts, combos):
        coords = dict(view.coords, **dict(zip(axes, combo)))
        index = shard_index(spec.shape, entries, sizes, coords, fused=spec.fused)
        block = out[tuple(slice(None) if isinstance(i, torch.Tensor) else i for i in index)]
        fancy = [(d, i) for d, i in enumerate(index) if isinstance(i, torch.Tensor)]
        if fancy:  # a fused axis: the rank's share of each block
            block.index_copy_(fancy[0][0], fancy[0][1].to(out.device), part)
        else:
            block.copy_(part)
    return out


def gather_tree(tree, spec_tree, view, rules: Mapping[str, MeshAxes]):
    """The global tree of float parameters (or gradients, or moments shaped
    like them) from every rank's shards: :func:`gather_leaf` leaf by leaf,
    on every rank."""
    return map_specs(tree, spec_tree, lambda leaf, spec: gather_leaf(leaf, spec, view, rules))


def gather_on_use(tree, spec_tree, view, rules: Mapping[str, MeshAxes]):
    """A tree of the rank's shards gathered over every axis that shards it
    but ``model`` (FSDP's ``data``: the model axis's shards stay with the
    tensor-parallel code), through ``gather_from``: all-gather forward, the
    gradient reduce-scattered back to the shard."""
    from repro_torch.distributed.mesh import gather_from

    sizes = view.sizes

    def one(leaf, spec):
        for d, name in sharded_dims(spec, rules, sizes):
            if name != "model":
                if spec.fused > 1 and d == len(spec.shape) - 1:
                    raise NotImplementedError(f"{spec.axes}: a fused last axis sharded over "
                                              f"{name!r} is not gathered block by block")
                leaf = gather_from(view.axes[name], leaf, d)
        return leaf

    return map_specs(tree, spec_tree, one)


def flat_index(shape: Sequence[int], index: tuple, device=None) -> torch.Tensor:
    """The positions, in the row-major flattening of a ``shape`` tensor, of
    the elements of its shard at ``index`` (:func:`shard_index`), in the
    shard's own row-major order (int64)."""
    out = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        i = index[d]
        ids = (torch.arange(i.start, i.stop, device=device) if isinstance(i, slice)
               else i.to(device=device, dtype=torch.int64))
        view = [1] * len(shape)
        view[d] = -1
        out = out + ids.reshape(view) * stride
        stride *= shape[d]
    return out.reshape(-1)


def map_specs(tree, spec_tree, fn):
    """``fn(leaf, its ParamSpec)`` over a parameter tree and its spec tree,
    keeping the dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_specs(v, spec_tree[k], fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(v, s, fn) for v, s in zip(tree, spec_tree)]
    return fn(tree, spec_tree)


# ---------------------------------------------------------------------------
# Decode-cache sharding (from the cache formats)
# ---------------------------------------------------------------------------

#: format-independent cache leaves → logical axes
_STATIC_CACHE_AXES = {
    "pos_ids": ("batch", "kv_seq"),
    "k_rope": ("batch", "kv_seq", None),
    "ck": ("batch", None, "kv_heads_cache", None),
    "cv": ("batch", None, "kv_heads_cache", None),
    "conv": ("batch", None, "act_mlp"),
    "ssm": ("batch", "act_mlp", None),
}


def cache_axes_table(cfg=None) -> dict[str, Axes]:
    """Cache-leaf name → logical axes, the K/V channels' (and the MLA
    latent's) from the cache format's ``flat_cache_axes``; ``cfg=None``
    reads the ``bf16`` format."""
    from repro_torch.core import kvcache

    fmt = kvcache.format_for(cfg) if cfg is not None else kvcache.get_cache_format("bf16")
    table = dict(_STATIC_CACHE_AXES)
    for prefix, lead in (("k", ("kv_heads_cache",)), ("v", ("kv_heads_cache",)),
                         ("c_kv", ())):
        table.update(fmt.flat_cache_axes(prefix, lead))
    return table


#: a paged format's per-slot ring leaves, whole over ``kv_seq``
_PAGED_WHOLE = {"pos_ids": ("batch", None), "k_rope": ("batch", None, None)}


def cache_pspecs(caches, rules: Mapping[str, MeshAxes], shard_kv: bool, cfg=None):
    """Partition entries of every leaf of the port's per-layer caches
    (``shard_kv`` gates the KV-head rule, as ``attn_dims`` decides it); a
    leaf the table does not name is replicated.  The port's caches are not
    stacked, so no leading layer axis is added.  Under a paged format
    ``pos_ids`` and MLA's ``k_rope`` stay whole over ``kv_seq``, where the
    reference cuts them by ring slot: a rank's block of the pool's pages
    may hold any ring slot, so it reads every slot's position."""
    from repro_torch.core import kvcache, paging

    local_rules = dict(rules)
    local_rules["kv_heads_cache"] = rules["kv_heads"] if shard_kv else None
    table = cache_axes_table(cfg)
    if cfg is not None and isinstance(kvcache.format_for(cfg), paging.PagedCacheFormat):
        table.update(_PAGED_WHOLE)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if name not in table:
            return ()
        return spec_for(tuple(table[name])[: tree.ndim], local_rules)

    return walk(caches)


def shard_caches(caches, mesh, rules: Mapping[str, MeshAxes], shard_kv: bool, cfg=None):
    """This rank's shard of a whole decode cache, each leaf cut by its
    :func:`cache_pspecs` entries over every mesh axis but ``model``, as the
    reference's ``jax.device_put(caches, cache_pspecs(...))`` places it: a
    prompt prefilled on one device (or by the model axis's ranks, whose KV
    heads are their shard already) reaches the ranks
    of a sequence-parallel decode (rules whose ``kv_seq`` is set), each
    ring cut to its contiguous block of slots.  ``mesh`` is a
    ``DeviceMesh`` or anything with ``mesh_dim_names``, ``mesh.shape`` and
    ``get_coordinate()``.  Each block is a copy: the whole cache can be
    dropped."""
    sizes = dict(mesh_sizes(mesh), model=1)
    coords = dict(mesh_coords(mesh), model=0)

    def cut(leaf, entries):
        if isinstance(leaf, dict):
            return {k: cut(v, entries[k]) for k, v in leaf.items()}
        if isinstance(leaf, list):
            return [cut(v, e) for v, e in zip(leaf, entries)]
        entries = tuple(entries) + (None,) * (leaf.ndim - len(entries))
        return take_index(leaf, shard_index(leaf.shape, entries, sizes, coords)).clone(
            memory_format=torch.contiguous_format)

    return cut(caches, cache_pspecs(caches, rules, shard_kv, cfg))


# ---------------------------------------------------------------------------
# Pad-to-shardable
# ---------------------------------------------------------------------------


def pad_dim(n: int, multiple: int) -> int:
    """Smallest padded size ≥ n divisible by ``multiple``."""
    return -(-n // multiple) * multiple


def maybe_pad_heads(n_heads: int, tp: int) -> int:
    return pad_dim(n_heads, tp) if n_heads % tp else n_heads


def shard_info(mesh_shape: Mapping[str, int]) -> dict[str, int]:
    """Sizes of the canonical axes (absent axes = 1)."""
    return {
        "pod": mesh_shape.get("pod", 1),
        "data": mesh_shape.get("data", 1),
        "model": mesh_shape.get("model", 1),
    }

