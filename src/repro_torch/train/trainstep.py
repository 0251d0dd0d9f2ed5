"""The train step: microbatched gradient accumulation, remat, AdamW, over a
mesh or on one device.

Counterpart of :mod:`repro.train.trainstep`.  With ``microbatches=m`` the
batch's rows are cut into m consecutive slices, each slice's gradients
taken by autograd and accumulated in float32, and the loss and metrics
averaged (``tokens`` summed), as the reference's ``lax.scan`` does;
``remat`` recomputes each layer in the backward pass
(:func:`repro_torch.models.stack.stack_apply`).  The optimizer walks the
reference's layout of the parameters and gradients
(:func:`repro_torch.convert.reference_layout`), so its int8 moments are
chunked over the reference's stacked leaves.  The step updates the
parameters and the optimizer state in place (the reference's jit donates
both) and returns them.

Over a mesh (``mesh``: a ``DeviceMesh`` of ``pod`` / ``data`` / ``model``
axes, or a :class:`TrainMesh`), where the reference leaves everything to
GSPMD, each rank holds its shards of the parameters and of the optimizer
state (``rules``, by default ``base_rules(fsdp=True)``: the ``embed`` axis
over ``data``, the heads, FFN, experts and vocab over ``model``) and its
rows of the batch:

* each layer's shards are gathered over ``data`` when the layer runs, and
  again in remat's recompute (``partitioning.gather_on_use``); their
  gradients are reduce-scattered back in the backward pass;
* the loss is the global batch's: each rank divides its sums by the token
  count all-reduced over the batch axes, so the gradients are summed over
  them; a microbatch's sums are divided by the count of the reference's
  microbatch (the same slice of the global batch);
* a MoE layer's load-balancing loss is the global batch's too: each rank
  takes its share, over the top-1 counts all-reduced over the batch axes;
  with several microbatches those counts are the reference microbatch's,
  whose rows other slices of this rank and other ranks hold, so a forward
  without gradients first counts every slice's (:func:`_route_tables`);
* the gradients of the leaves no data rank shards (the norms) are
  all-reduced over ``data``, and every gradient over ``pod``, in one
  bucket each;
* ``compress_pod_grads`` then runs the int8 cross-pod hop
  (:mod:`repro_torch.distributed.collectives`) over the global stacked
  leaves, as the reference's ``compressed_psum_tree`` sees them after
  GSPMD's reduction: the dequantized quantization of the global gradient;
* each rank updates its own shards (:mod:`repro_torch.optim.adamw` with
  the step's :class:`~repro_torch.optim.adamw.LeafShard` tree).

``probe`` is accepted and changes nothing: the reference's probe programs
collapse its scans so that XLA's cost analysis counts every layer, and the
port has no scan and no compiled program to count.  The dry run
(:mod:`repro_torch.launch.dryrun`) counts a step's collectives from these
code paths (``train_step_collectives``) and probes by depth itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.convert import Stacked
from repro_torch.distributed.mesh import MeshView, TensorParallel
from repro_torch.models import attention
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw as optim_lib
from repro_torch.sharding import partitioning as P

METRICS = ("ce", "aux", "z", "tokens")


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    remat: bool = True
    compress_pod_grads: bool = False  # int8 cross-pod gradient sync
    aux_weight: float = 0.01
    z_weight: float = 1e-4
    probe: bool = False  # the reference's cost-counting probe: a no-op here


# ---------------------------------------------------------------------------
# The rank's place in the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainMesh:
    """One rank's place in a training mesh: the axes' views (``view``, with
    their collective counts), the ``rules``, the tensor-parallel width
    ``tp``, the global parameter specs ``spec`` (``model.specs(cfg, tp)``)
    and the optimizer's :class:`~repro_torch.optim.adamw.LeafShard` tree
    over the reference's layout (``shards``)."""

    view: MeshView
    rules: dict
    tp: int
    spec: dict
    shards: dict

    @property
    def model(self) -> Optional[TensorParallel]:
        """The model axis's view, or None at one rank."""
        return self.view.axis("model")

    @property
    def batch_axes(self) -> tuple:
        return model_lib.batch_axes(self.rules)

    @property
    def batch_ways(self) -> int:
        return math.prod(self.view.size(a) for a in self.batch_axes)

    @property
    def batch_index(self) -> int:
        """The rank's block of the global batch's rows (the batch axes
        row-major, the first outermost)."""
        index = 0
        for a in self.batch_axes:
            index = index * self.view.size(a) + self.view.coord(a)
        return index

    def shard(self, tree: dict) -> dict:
        """The rank's shards of a global tree of the port's layout (each a
        contiguous copy, so the global tensors can be freed)."""
        return _shard_tree(tree, self.spec, self.view, self.rules)

    def shard_leaf(self, path: tuple, t: torch.Tensor) -> torch.Tensor:
        """The rank's shard of the global leaf ``t`` at key ``path`` of the
        port's layout (as :func:`model.draw` names it)."""
        spec = self.spec
        for k in path:
            spec = spec[int(k)] if isinstance(spec, list) else spec[k]
        return _shard_tree(t, spec, self.view, self.rules)

    def gather(self, tree: dict) -> dict:
        """The global tree of the port's layout from every rank's shards (a
        collective: every rank calls it)."""
        return P.gather_tree(tree, self.spec, self.view, self.rules)


def _own(t: torch.Tensor, index: tuple) -> torch.Tensor:
    return P.take_index(t, index).clone(memory_format=torch.contiguous_format)


def _shard_tree(tree, spec_tree, view: MeshView, rules) -> dict:
    sizes, coords = view.sizes, view.coords

    def one(leaf, spec):
        entries = P.spec_for(spec.axes, rules)
        return _own(leaf, P.shard_index(leaf.shape, entries, sizes, coords, fused=spec.fused))

    return P.map_specs(tree, spec_tree, one)


def leaf_shards(cfg, spec: dict, view: MeshView, rules) -> dict:
    """The :class:`~repro_torch.optim.adamw.LeafShard` of every leaf of the
    reference's layout of ``spec`` for this rank."""
    sizes, coords = view.sizes, view.coords

    def one(leaf):
        pieces = tuple(leaf) if isinstance(leaf, Stacked) else (leaf,)
        per = math.prod(pieces[0].shape)
        entries = P.spec_for(pieces[0].axes, rules)
        sharding = {name for _, name in P.sharded_dims(pieces[0], rules, sizes)}
        counted = all(coords[a] == 0 for a, n in sizes.items() if n > 1 and a not in sharding)
        return optim_lib.LeafShard(
            numel=per * len(pieces), shapes=tuple(p.shape for p in pieces),
            indices=tuple(P.shard_index(p.shape, entries, sizes, coords, fused=p.fused)
                          for p in pieces),
            offsets=tuple(i * per for i in range(len(pieces))), counted=counted)

    return tree_lib.map_leaves(one, convert.reference_layout(spec, cfg))


def default_rules(cfg, data_axes: tuple, tp: int) -> dict:
    """``base_rules(fsdp=True)`` over the batch axes ``data_axes``, with a MoE
    layer's experts over the model axis where they divide its ``tp`` ways,
    else their hidden width (``moe_mlp``)."""
    return P.base_rules(fsdp=True, data_axes=data_axes,
                        shard_experts=not cfg.n_experts or cfg.n_experts % tp == 0)


def train_mesh(cfg, mesh, *, tp: int = 1, rules=None) -> TrainMesh:
    """This rank's :class:`TrainMesh` on the ``DeviceMesh`` ``mesh``; ``rules``
    default to :func:`default_rules` over the mesh's ``pod`` / ``data``
    axes.  The mesh's model axis must be ``tp`` ways."""
    if isinstance(mesh, TrainMesh):
        return mesh
    view = MeshView.from_mesh(mesh, shard_kv=attention.attn_dims(cfg, tp)[2])
    if view.size("model") != tp:
        raise ValueError(f"tp={tp}, but the mesh's model axis is {view.size('model')} ways")
    if rules is None:
        rules = default_rules(cfg, tuple(a for a in ("pod", "data") if a in view.axes), tp)
    model_lib.check_tp(cfg, view.axis("model"))
    spec = model_lib.specs(cfg, tp)
    return TrainMesh(view=view, rules=rules, tp=tp, spec=spec,
                     shards=leaf_shards(cfg, spec, view, rules))


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


def init_opt_state(opt: optim_lib.Optimizer, params: dict, cfg,
                   tm: Optional[TrainMesh] = None) -> optim_lib.AdamState:
    """``opt``'s zero state for the port's parameters (a rank's shards under
    ``tm``), over the reference's layout."""
    layout = convert.reference_layout(params, cfg)
    return opt.init(layout) if tm is None else opt.init(layout, tm.shards)


def value_and_grad(params: dict, batch: dict, cfg, step_cfg: TrainStepConfig = TrainStepConfig(),
                   tm: Optional[TrainMesh] = None, denom=None, counts=None):
    """``model.loss_fn`` on one (micro)batch and its gradient with respect to
    every parameter → (loss, metrics, grads: the parameters' tree, each
    leaf in its parameter's dtype).  Under ``tm``, the rank's share of the
    loss (``denom``: the microbatch's global token count; ``counts``: its
    MoE layers' global top-1 counts) and the gradient of its shards,
    reduce-scattered over the axes that shard them."""
    flat: list = []

    def track(p):
        flat.append(p.detach().requires_grad_(True))
        return flat[-1]

    mesh_kw = {} if tm is None else dict(tp=tm.model, rules=tm.rules, mesh=tm.view,
                                         denom=denom, counts=counts)
    with torch.enable_grad():
        live = tree_lib.map_leaves(track, params)
        loss, metrics = model_lib.loss_fn(live, batch, cfg, remat=step_cfg.remat,
                                          aux_weight=step_cfg.aux_weight,
                                          z_weight=step_cfg.z_weight, **mesh_kw)
        grads = list(torch.autograd.grad(loss, flat, allow_unused=True))
    for i, (g, p) in enumerate(zip(grads, flat)):
        if g is None:  # a parameter the loss does not reach
            grads[i] = torch.zeros_like(p)
    it = iter(grads)
    grads = tree_lib.map_leaves(lambda _: next(it), live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _microbatch_counts(batch: dict, m: int, tm: TrainMesh) -> torch.Tensor:
    """The global token count of each of the reference's ``m`` microbatches
    that the rank's ``m`` slices fall in: slice j of batch block d is the
    global batch's ``(d·m + j)``-th ``1/(ways·m)``, in microbatch
    ``(d·m + j) // ways``."""
    labels = batch["labels"]
    per = labels.shape[0] // m
    ways = tm.batch_ways
    counts = torch.zeros(ways * m, dtype=torch.float32, device=labels.device)
    for j in range(m):
        counts[tm.batch_index * m + j] = (labels[j * per:(j + 1) * per] >= 0).sum()
    counts = tm.view.all_reduce_sum(counts, tm.batch_axes)
    return counts.reshape(m, ways).sum(dim=1)[
        (tm.batch_index * m + torch.arange(m, device=labels.device)) // ways]


def _route_tables(params: dict, batch: dict, cfg, m: int, tm: TrainMesh) -> list:
    """The global top-1 counts ``[n_layers, E]`` of the reference microbatch
    each of the rank's ``m`` slices falls in (:func:`_microbatch_counts`'
    map): every slice's own counts from a forward without gradients, placed
    at the slice's index of the global batch, all-reduced over the batch
    axes and summed by microbatch."""
    per = batch["labels"].shape[0] // m
    ways = tm.batch_ways
    device = batch["labels"].device
    table = torch.zeros((ways * m, cfg.n_layers, cfg.n_experts), dtype=torch.float32,
                        device=device)
    for j in range(m):
        row = table[tm.batch_index * m + j]

        def record(i, local, row=row):
            row[i] = local
            return local, ways

        mb = {k: v[j * per:(j + 1) * per] for k, v in batch.items()}
        with torch.no_grad():
            model_lib.forward(params, mb, cfg, tp=tm.model, rules=tm.rules, mesh=tm.view,
                              global_counts=record)
    table = tm.view.all_reduce_sum(table, tm.batch_axes)
    table = table.reshape(m, ways, cfg.n_layers, cfg.n_experts).sum(dim=1)
    return [table[(tm.batch_index * m + j) // ways] for j in range(m)]


def compute_grads(params: dict, batch: dict, cfg, step_cfg: TrainStepConfig = TrainStepConfig(),
                  tm: Optional[TrainMesh] = None):
    """The step's float32 gradients over ``step_cfg.microbatches`` slices of
    the batch → (mean loss, metrics, grads).  Under ``tm``: the rank's rows
    and shards; the loss and the ``ce`` / ``aux`` / ``z`` metrics are the rank's
    shares (their sum over the batch axes the global values), ``tokens``
    the global count, and the gradients not yet summed over the batch axes
    but through the reduce-scatters of the shards' gathers
    (:func:`sync_grads` does the rest)."""
    m = step_cfg.microbatches
    rows = next(iter(batch.values())).shape[0]
    if rows % m:
        raise ValueError(f"batch of {rows} rows is not a multiple of microbatches={m}")
    denoms = None if tm is None or m == 1 else _microbatch_counts(batch, m, tm)
    tables = [None] * m
    if denoms is not None and tm.batch_ways > 1 and cfg.n_experts:
        tables = _route_tables(params, batch, cfg, m, tm)
    if m == 1:
        loss, metrics, grads = value_and_grad(params, batch, cfg, step_cfg, tm)
        return loss, metrics, tree_lib.map_leaves(lambda g: g.to(torch.float32), grads)
    per = rows // m
    gacc = tree_lib.map_leaves(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)
    device = tree_lib.leaves(params)[0].device
    lacc = torch.zeros((), dtype=torch.float32, device=device)
    macc = {k: torch.zeros((), dtype=torch.float32, device=device) for k in METRICS}
    for i in range(m):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss, metrics, grads = value_and_grad(params, mb, cfg, step_cfg, tm,
                                              None if denoms is None else denoms[i], tables[i])
        gacc = tree_lib.map_leaves(lambda a, g: a + g.to(torch.float32), gacc, grads)
        del grads
        lacc = lacc + loss
        macc = {k: macc[k] + metrics[k].to(torch.float32) for k in METRICS}
    grads = tree_lib.map_leaves(lambda g: g / m, gacc)
    metrics = {k: v / m for k, v in macc.items()}
    metrics["tokens"] = metrics["tokens"] * m
    if denoms is not None:  # each slice reported its microbatch's count: the batch's
        metrics["tokens"] = tm.view.all_reduce_sum(
            (batch["labels"] >= 0).sum().to(torch.float32), tm.batch_axes)
    return lacc / m, metrics, grads


def _bucket_sum(axis, grads: list) -> None:
    """All-reduce (sum) of float32 tensors over ``axis`` as one flat buffer,
    written back in place."""
    if axis is None or not grads:
        return
    flat = axis.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].reshape(g.shape))
        at += g.numel()


def sync_grads(grads: dict, tm: TrainMesh) -> dict:
    """The global gradient of the rank's shards: the leaves the data axis
    does not shard summed over ``data``, every leaf over ``pod`` (the
    batch axes the loss's shares are over)."""
    sizes = tm.view.sizes
    for name in tm.batch_axes:
        axis = tm.view.axis(name)
        if axis is None:
            continue
        todo = []

        def pick(g, spec):
            if name not in {a for _, a in P.sharded_dims(spec, tm.rules, sizes)}:
                todo.append(g)
            return g

        P.map_specs(grads, tm.spec, pick)
        _bucket_sum(axis, todo)
    return grads


def compress_pod(grads: dict, cfg, tm: TrainMesh) -> dict:
    """The int8 cross-pod hop on the global gradient: every leaf gathered to
    the reference's global stacked leaf, :func:`compressed_psum_tree` over
    ``pod``, and the rank's shards taken back."""
    from repro_torch.distributed import collectives

    glob = tree_lib.map_leaves(torch.clone, tm.gather(grads))  # written in place below
    layout = convert.reference_layout(glob, cfg)  # its Stacked hold glob's tensors
    stacked = tree_lib.map_leaves(
        lambda t: torch.stack(tuple(t)) if isinstance(t, Stacked) else t, layout)
    out = collectives.compressed_psum_tree(stacked, tm.view, "pod")
    for leaf, new in zip(tree_lib.leaves(layout), tree_lib.leaves(out)):
        pieces = tuple(leaf) if isinstance(leaf, Stacked) else (leaf,)
        for piece, value in zip(pieces, new.unbind(0) if isinstance(leaf, Stacked) else (new,)):
            piece.copy_(value)
    return tm.shard(glob)


def apply_grads(opt: optim_lib.Optimizer, params: dict, opt_state, grads: dict, cfg,
                tm: Optional[TrainMesh] = None):
    """One optimizer update of ``params`` (in place) from float32 ``grads``
    → (the new optimizer state, the gradients' global norm); under ``tm``
    each rank updates its shards."""
    layout_p = convert.reference_layout(params, cfg)
    layout_g = convert.reference_layout(grads, cfg)
    if tm is None:
        updates, opt_state = opt.update(layout_g, opt_state, layout_p)
        gnorm = optim_lib.global_norm(layout_g)
    else:
        updates, opt_state = opt.update(layout_g, opt_state, layout_p, tm.shards, tm.view)
        gnorm = optim_lib.global_norm(layout_g, tm.shards, tm.view)
    optim_lib.apply_updates(layout_p, updates)
    return opt_state, gnorm


def make_train_step(cfg, opt: optim_lib.Optimizer, *, tp: int = 1, rules=None,
                    step_cfg: TrainStepConfig = TrainStepConfig(), mesh=None) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: params and state updated in place; metrics ``ce``, ``aux``,
    ``z``, ``tokens``, ``loss`` and ``grad_norm`` as 0-dim tensors on the
    device, the global batch's on every rank.  Over ``mesh`` (a
    ``DeviceMesh`` whose model axis is ``tp`` ways, or a :class:`TrainMesh`)
    the step takes the rank's shards and rows; its :class:`TrainMesh` is
    ``train_step.mesh`` (None on one device).  ``step_cfg.probe`` runs the
    same step (see the module docstring)."""
    if mesh is None and tp != 1:
        raise ValueError(f"tp={tp} needs a mesh")
    tm = None if mesh is None else train_mesh(cfg, mesh, tp=tp, rules=rules)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, batch, cfg, step_cfg, tm)
        if tm is not None:
            grads = sync_grads(grads, tm)
            if step_cfg.compress_pod_grads and "pod" in tm.view.axes:
                grads = compress_pod(grads, cfg, tm)
            shares = torch.stack([loss, metrics["ce"], metrics["aux"], metrics["z"]])
            loss, ce, aux, z = tm.view.all_reduce_sum(shares, tm.batch_axes).unbind(0)
            metrics = dict(metrics, ce=ce, aux=aux, z=z)
        opt_state, gnorm = apply_grads(opt, params, opt_state, grads, cfg, tm)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    train_step.mesh = tm
    return train_step
