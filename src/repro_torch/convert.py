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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import model as model_lib


def _tensor(a, device) -> torch.Tensor:
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


def params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """Reference parameter tree (numpy leaves) → port parameters on
    ``device`` (default: the card; raises when there is none)."""
    device = resolve_device(device)
    k0 = cfg.first_k_dense
    allowed = {"embed", "final_norm", "stack"} | ({"prefix"} if k0 else set()) | (
        {"encoder"} if cfg.is_enc_dec else set())
    unknown = set(tree) - allowed
    if unknown:
        raise ValueError(f"params_from_numpy: unsupported subtrees {sorted(unknown)}")
    spec = model_lib.specs(cfg)

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
                        lambda a: _tensor(np.asarray(a)[sb], device), (where, f"slot{j}"))

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
