"""The train step: microbatched gradient accumulation, remat, AdamW.

Counterpart of :mod:`repro.train.trainstep` on one device.  With
``microbatches=m`` the batch's rows are cut into m consecutive slices,
each slice's gradients taken by autograd and accumulated in float32, and
the loss and metrics averaged (``tokens`` summed), as the reference's
``lax.scan`` does; ``remat`` recomputes each layer in the backward pass
(:func:`repro_torch.models.stack.stack_apply`).  The optimizer walks the
reference's layout of the parameters and gradients
(:func:`repro_torch.convert.reference_layout`), so its int8 moments are
chunked over the reference's stacked leaves.  The step updates the
parameters and the optimizer state in place (the reference's jit donates
both) and returns them.  ``compress_pod_grads`` (the int8 cross-pod
gradient sync) and ``probe`` (the dry-run's cost counting) wait for the
sharding and dry-run modules.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw as optim_lib

METRICS = ("ce", "aux", "z", "tokens")


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    remat: bool = True
    compress_pod_grads: bool = False  # int8 cross-pod gradient sync
    aux_weight: float = 0.01
    z_weight: float = 1e-4
    probe: bool = False  # dry-run cost counting


def init_opt_state(opt: optim_lib.Optimizer, params: dict, cfg) -> optim_lib.AdamState:
    """``opt``'s zero state for the port's parameters, over the reference's
    layout."""
    return opt.init(convert.reference_layout(params, cfg))


def value_and_grad(params: dict, batch: dict, cfg, step_cfg: TrainStepConfig = TrainStepConfig()):
    """``model.loss_fn`` on one (micro)batch and its gradient with respect to
    every parameter → (loss, metrics, grads: the parameters' tree, each
    leaf in its parameter's dtype)."""
    flat: list = []

    def track(p):
        flat.append(p.detach().requires_grad_(True))
        return flat[-1]

    with torch.enable_grad():
        live = tree_lib.map_leaves(track, params)
        loss, metrics = model_lib.loss_fn(live, batch, cfg, remat=step_cfg.remat,
                                          aux_weight=step_cfg.aux_weight,
                                          z_weight=step_cfg.z_weight)
        grads = list(torch.autograd.grad(loss, flat, allow_unused=True))
    for i, (g, p) in enumerate(zip(grads, flat)):
        if g is None:  # a parameter the loss does not reach
            grads[i] = torch.zeros_like(p)
    it = iter(grads)
    grads = tree_lib.map_leaves(lambda _: next(it), live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def compute_grads(params: dict, batch: dict, cfg, step_cfg: TrainStepConfig = TrainStepConfig()):
    """The step's float32 gradients over ``step_cfg.microbatches`` slices of
    the batch → (mean loss, metrics, grads)."""
    m = step_cfg.microbatches
    if m == 1:
        loss, metrics, grads = value_and_grad(params, batch, cfg, step_cfg)
        return loss, metrics, tree_lib.map_leaves(lambda g: g.to(torch.float32), grads)
    rows = next(iter(batch.values())).shape[0]
    if rows % m:
        raise ValueError(f"global batch {rows} is not a multiple of microbatches={m}")
    per = rows // m
    gacc = tree_lib.map_leaves(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)
    device = tree_lib.leaves(params)[0].device
    lacc = torch.zeros((), dtype=torch.float32, device=device)
    macc = {k: torch.zeros((), dtype=torch.float32, device=device) for k in METRICS}
    for i in range(m):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss, metrics, grads = value_and_grad(params, mb, cfg, step_cfg)
        gacc = tree_lib.map_leaves(lambda a, g: a + g.to(torch.float32), gacc, grads)
        del grads
        lacc = lacc + loss
        macc = {k: macc[k] + metrics[k].to(torch.float32) for k in METRICS}
    grads = tree_lib.map_leaves(lambda g: g / m, gacc)
    metrics = {k: v / m for k, v in macc.items()}
    metrics["tokens"] = metrics["tokens"] * m
    return lacc / m, metrics, grads


def apply_grads(opt: optim_lib.Optimizer, params: dict, opt_state, grads: dict, cfg):
    """One optimizer update of ``params`` (in place) from float32 ``grads``
    → (the new optimizer state, the gradients' global norm)."""
    layout_p = convert.reference_layout(params, cfg)
    layout_g = convert.reference_layout(grads, cfg)
    updates, opt_state = opt.update(layout_g, opt_state, layout_p)
    optim_lib.apply_updates(layout_p, updates)
    return opt_state, optim_lib.global_norm(layout_g)


def make_train_step(cfg, opt: optim_lib.Optimizer, *,
                    step_cfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: params and state updated in place; metrics ``ce``, ``aux``,
    ``z``, ``tokens``, ``loss`` and ``grad_norm`` as 0-dim tensors on the
    device."""
    if step_cfg.compress_pod_grads:
        raise NotImplementedError("compress_pod_grads: the int8 cross-pod gradient sync "
                                  "waits for the sharding and distributed modules")
    if step_cfg.probe:
        raise NotImplementedError("probe: the dry-run's cost counting waits for the "
                                  "dry-run modules")

    def train_step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, batch, cfg, step_cfg)
        opt_state, gnorm = apply_grads(opt, params, opt_state, grads, cfg)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step
