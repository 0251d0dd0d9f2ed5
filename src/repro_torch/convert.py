"""Bring the JAX package's float parameters across to the port.

``params_from_numpy(tree, cfg, device=None)`` takes the reference's parameter
tree with every leaf as a numpy array (``jax.tree.map(np.asarray,
params)``) and returns the port's layout: the reference stacks each layer
leaf ``[n_superblocks, ...]`` under ``stack.slot{j}`` (``block_period``
slots a superblock: jamba's 8) and keeps its leading dense layers
(``first_k_dense``, deepseek's layer 0) apart as ``prefix.layer{i}``; the
port keeps one dict per layer, ``prefix.layer{i}`` as layer ``i`` and
``stack.slot{j}[s]`` as layer ``first_k_dense + s·block_period + j``; an
encoder-decoder's ``encoder.stack.slot0[i]`` becomes ``encoder.layers[i]``
beside ``encoder.final_norm``.  Every leaf must be one of
:func:`repro_torch.models.model.specs` (norm scales and biases, the q/k/v
biases, the MLA projections and norms, the Mamba mixer's leaves, the
cross-attention projections, ``ln_x`` and the scalar ``gate``, the router,
the stacked expert weights and the shared experts, the untied
``embed.head``); any other raises.  With the same float weights both packages then convert
to residency and compute the same thing.  bfloat16 arrays (numpy's
``ml_dtypes.bfloat16``) cross bit for bit.  Like every entry point of the
port, it puts the tensors on the card unless the caller names a device.
A leaf may also be a tensor (a checkpoint the port's reader restored).

The other direction: :func:`reference_layout` holds any tree of the port's
shape (parameters, gradients) in the reference's layout, each stacked leaf
a :class:`Stacked` of the port's per-layer tensors (no copy), and
:func:`params_to_numpy` stacks it into numpy arrays, the exact inverse of
:func:`params_from_numpy`.  The optimizer walks that layout (its int8
moments are chunked over the reference's stacked leaves) and the
checkpoint writer stores it, so both see the reference's leaves in the
reference's order.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.models import model as model_lib


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree, spec, fn, path):
    """``fn`` on every leaf of ``tree``, whose dicts must hold exactly the
    keys of the port's ``spec``."""
    if not isinstance(tree, dict):
        return fn(tree)
    if not isinstance(spec, dict) or set(tree) != set(spec):
        want = sorted(spec) if isinstance(spec, dict) else "a leaf"
        raise ValueError(f"params_from_numpy: {'.'.join(path)} holds {sorted(tree)}, "
                         f"the port's parameters {want}")
    return {k: _map(v, spec[k], fn, path + (k,)) for k, v in tree.items()}


def params_from_numpy(tree: dict, cfg, device=None, tp: int = 1) -> dict:
    """Reference parameter tree (numpy leaves) → port parameters on
    ``device`` (default: the card; raises when there is none).  ``tp`` names
    the tensor-parallel width the tree was made for (``specs(cfg, tp)``:
    padded heads and vocab)."""
    device = resolve_device(device)
    k0 = cfg.first_k_dense
    allowed = {"embed", "final_norm", "stack"} | ({"prefix"} if k0 else set()) | (
        {"encoder"} if cfg.is_enc_dec else set())
    unknown = set(tree) - allowed
    if unknown:
        raise ValueError(f"params_from_numpy: unsupported subtrees {sorted(unknown)}")
    spec = model_lib.specs(cfg, tp)

    def one(a):
        return _tensor(a, device)

    def unstack(slots, spec_layers, period, first, where):
        """Layers ``first ..`` of ``spec_layers`` from ``slots`` (``slot{j}``
        stacked ``[n_superblocks, ...]``, ``period`` slots a superblock)."""
        if set(slots) != {f"slot{j}" for j in range(period)}:
            raise ValueError(f"params_from_numpy: {where} holds {sorted(slots)}, expected "
                             f"{period} slot(s) a superblock")

        def layer(i):
            sb, j = divmod(i - first, period)
            return _map(slots[f"slot{j}"], spec_layers[i],
                        lambda a: _tensor(a[sb] if isinstance(a, torch.Tensor)
                                          else np.asarray(a)[sb], device),
                        (where, f"slot{j}"))

        return [layer(i) for i in range(first, len(spec_layers))]

    prefix = tree.get("prefix", {})
    if set(prefix) != {f"layer{i}" for i in range(k0)}:
        raise ValueError(f"params_from_numpy: prefix holds {sorted(prefix)}, expected "
                         f"{k0} leading layers")
    out = {
        "embed": _map(tree["embed"], spec["embed"], one, ("embed",)),
        "final_norm": _map(tree["final_norm"], spec["final_norm"], one, ("final_norm",)),
        "layers": [_map(prefix[f"layer{i}"], spec["layers"][i], one, ("prefix", f"layer{i}"))
                   for i in range(k0)]
        + unstack(tree["stack"], spec["layers"], cfg.block_period, k0, "stack"),
    }
    if cfg.is_enc_dec:
        enc = tree["encoder"]
        if set(enc) != {"stack", "final_norm"}:
            raise ValueError(f"params_from_numpy: encoder holds {sorted(enc)}")
        out["encoder"] = {
            "layers": unstack(enc["stack"], spec["encoder"]["layers"], 1, 0, "encoder.stack"),
            "final_norm": _map(enc["final_norm"], spec["encoder"]["final_norm"], one,
                               ("encoder", "final_norm")),
        }
    return out


class Stacked(tuple):
    """One leaf of the reference's layout, stacked ``[n, ...]`` over the
    superblocks: the port's per-layer tensors (or specs) it stacks, in
    layer order."""

    @property
    def shape(self) -> tuple:
        return (len(self),) + tuple(self[0].shape)

    @property
    def dtype(self):
        return self[0].dtype


def _restack(layers: list, period: int) -> dict:
    """``slot{j}``: layers ``j, j + period, ...`` stacked leaf by leaf."""

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return Stacked(items)

    return {f"slot{j}": stack(layers[j::period]) for j in range(period)}


def reference_layout(tree: dict, cfg) -> dict:
    """A tree of the port's shape (``embed``, ``final_norm``, ``layers``,
    ``encoder``) in the reference's: leading dense layers as
    ``prefix.layer{i}``, the rest as ``stack.slot{j}`` (each leaf a
    :class:`Stacked`), the encoder's layers as ``encoder.stack.slot0``."""
    k0 = cfg.first_k_dense
    layers = tree["layers"]
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"],
           "stack": _restack(layers[k0:], cfg.block_period)}
    if k0:
        out["prefix"] = {f"layer{i}": layers[i] for i in range(k0)}
    if cfg.is_enc_dec:
        out["encoder"] = {"stack": _restack(tree["encoder"]["layers"], 1),
                          "final_norm": tree["encoder"]["final_norm"]}
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 as numpy's
    ``ml_dtypes.bfloat16``, bit for bit."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: dict, cfg) -> dict:
    """Port parameters → the reference's parameter tree with numpy leaves
    (stacked leaves ``[n_superblocks, ...]``): the inverse of
    :func:`params_from_numpy`."""

    def one(leaf):
        if isinstance(leaf, Stacked):
            return np.stack([_to_numpy(t) for t in leaf])
        return _to_numpy(leaf)

    return tree_lib.map_leaves(one, reference_layout(params, cfg))
