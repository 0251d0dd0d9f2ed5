"""Trainer: the long-running loop with checkpoints, watchdog and restart.

Counterpart of :mod:`repro.train.trainer` on one device: the synthetic
data stream → the train step (microbatched, remat) → an asynchronous
checkpoint every ``ckpt_every`` steps and a last one at the end → the
watchdog's step-time telemetry → on a (simulated) failure, a restart from
the latest checkpoint, up to ``max_restarts`` times.  Parameters are drawn
with :func:`repro_torch.models.model.draw` on the device (default the
card; ``device="cpu"`` runs the plain path).  A step's time is measured
with CUDA events on the card and with the host clock on the CPU.

Checkpoints hold the reference trainer's tree ``{"params", "opt_state":
{"step", "mu", "nu"}}`` in the reference's layout (stacked leaves, each
moment ``{"payload", "scale"}``), so the reference's checkpoints restore
here and the port's hold the same leaves.

Over a mesh (``Trainer(mesh=, rules=, tp=)``, the rank's ``DeviceMesh``),
each rank draws the parameters leaf by leaf and keeps its shards, takes
its rows of every batch (:func:`~repro_torch.data.pipeline.shard_batch`)
and runs the sharded train step.  A checkpoint holds the global tree:
every rank takes part in gathering it, rank 0 alone writes it, so its
files are the same at any mesh; a restart restores it onto the trainer's
own mesh, which may differ from the one that wrote it (the elastic path).
After a failure the ranks wait for each other before they restore.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch import convert, resolve_device
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.convert import Stacked
from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch, to_device
from repro_torch.distributed.resilience import FailureSim, SimulatedFailure, StepWatchdog
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw as optim_lib
from repro_torch.sharding import partitioning as P
from repro_torch.train.trainstep import TrainStepConfig, init_opt_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    seed: int = 0
    peak_lr: float = 3e-4
    warmup: int = 20
    moment_dtype: str = "f32"
    microbatches: int = 1
    max_restarts: int = 3


class Trainer:
    def __init__(self, cfg, data_cfg: DataConfig, tcfg: TrainerConfig, *, mesh=None,
                 rules=None, tp: int = 1, failure_sim: Optional[FailureSim] = None,
                 device=None):
        self.cfg, self.data_cfg, self.tcfg = cfg, data_cfg, tcfg
        self.tp = tp
        self.device = resolve_device(device)
        self.failure_sim = failure_sim
        self.watchdog = StepWatchdog()
        self.opt = optim_lib.adamw(
            optim_lib.cosine_schedule(tcfg.peak_lr, tcfg.warmup, tcfg.steps),
            moment_dtype=tcfg.moment_dtype,
        )
        self.step_fn = make_train_step(
            cfg, self.opt, tp=tp, rules=rules, mesh=mesh,
            step_cfg=TrainStepConfig(microbatches=tcfg.microbatches))
        self.mesh = self.step_fn.mesh  # the rank's TrainMesh, or None
        self.rank = 0 if self.mesh is None else torch.distributed.get_rank()
        self.ckpt = ckpt_lib.AsyncCheckpointer()
        self.history: list[dict] = []

    # -- state ---------------------------------------------------------

    def init_state(self):
        tm = self.mesh
        leaf = None if tm is None else (lambda path, t: tm.shard_leaf(path, t))
        params = model_lib.draw(self.cfg, self.tcfg.seed, self.device, leaf=leaf, tp=self.tp)
        return params, init_opt_state(self.opt, params, self.cfg, tm), 0

    def restore_state(self):
        d = self.tcfg.ckpt_dir
        step = ckpt_lib.latest_step(d) if d else None
        if step is None:
            return self.init_state()
        tree, extra = ckpt_lib.restore(d, step, paths=checkpoint_paths(self.cfg, self.tp))
        params, opt_state = state_from_tree(tree, self.cfg, self.device,
                                            self.tcfg.moment_dtype, self.mesh)
        return params, opt_state, extra.get("step", step)

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.view.all_reduce_sum(torch.zeros(1, device=self.device))

    def _save(self, params, opt_state, step: int, sync: bool = False) -> None:
        """Every rank gathers the global tree; rank 0 writes it."""
        tree = state_tree(params, opt_state, self.cfg, self.mesh)
        if self.rank != 0:
            return
        if sync:
            ckpt_lib.save(tree, self.tcfg.ckpt_dir, step, extra={"step": step})
        else:
            self.ckpt.save(tree, self.tcfg.ckpt_dir, step, extra={"step": step})

    # -- loop ----------------------------------------------------------

    def run(self) -> dict:
        restarts = 0
        while True:
            try:
                return self._run_once()
            except SimulatedFailure:
                restarts += 1
                if restarts > self.tcfg.max_restarts:
                    raise
                self.ckpt.wait()
                self._barrier()  # rank 0's write is done before any rank restores
                # loop re-enters, restoring from the latest checkpoint

    def _timed(self, fn):
        """fn() → (its result, seconds): CUDA events on the card (the step's
        device time as the stream sees it), the host clock on the CPU."""
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def _run_once(self) -> dict:
        params, opt_state, start = self.restore_state()
        src = SyntheticLM(self.data_cfg)
        t_tot0 = time.perf_counter()
        for step in range(start, self.tcfg.steps):
            host = src.batch(step)
            if self.mesh is not None:
                host = shard_batch(host, self.mesh.view, self.mesh.rules)
            batch = to_device(host, self.device)
            if self.failure_sim is not None:
                self.failure_sim.check(step)
            (params, opt_state, metrics), dt = self._timed(
                lambda: self.step_fn(params, opt_state, batch))
            rep = self.watchdog.observe(step, dt)
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps - 1:
                self.history.append(
                    {"step": step, "loss": float(metrics["loss"]),
                     "ce": float(metrics["ce"]), "sec": dt,
                     "straggler": rep.straggler}
                )
            if self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                self._save(params, opt_state, step + 1)
        self.ckpt.wait()
        # the last checkpoint, unless the periodic one just wrote this state (the
        # reference writes the same files again)
        if self.tcfg.ckpt_dir and self.tcfg.steps % self.tcfg.ckpt_every:
            self._save(params, opt_state, self.tcfg.steps, sync=True)
        self._barrier()
        return {
            "params": params,
            "opt_state": opt_state,
            "history": self.history,
            "total_sec": time.perf_counter() - t_tot0,
            "stragglers": self.watchdog.straggler_steps,
        }


# ---------------------------------------------------------------------------
# The checkpoint tree: the reference trainer's, in the reference's layout
# ---------------------------------------------------------------------------


def _moments_to_dict(tree):
    return tree_lib.map_leaves(lambda m: {"payload": m.payload, "scale": m.scale}, tree)


def _gathered(tree_ref, spec_ref, tm) -> dict:
    """A tree of the reference's layout of the rank's shards (tensors, or
    :class:`Stacked` pieces) → the global tree (every rank calls it)."""

    def one(leaf, spec):
        if isinstance(leaf, Stacked):
            return Stacked(tuple(P.gather_leaf(p, s, tm.view, tm.rules)
                                 for p, s in zip(leaf, spec)))
        return P.gather_leaf(leaf, spec, tm.view, tm.rules)

    return tree_lib.map_leaves(one, tree_ref, spec_ref)


def _global_moments(moments, spec_ref, tm):
    """The global moments of a rank's: f32 / bf16 gathered like the
    parameters; int8 codes gathered piece by piece, then laid out on the
    reference's chunk grid ``[chunks, 256]`` (the scales are already every
    chunk's)."""
    if tm is None:
        return moments

    def one(m, spec):
        if m.payload.dtype != torch.int8:
            return optim_lib.Moment(_gathered(m.payload, spec, tm), m.scale)
        pieces = _gathered(m.payload, spec, tm)
        flat = torch.cat([p.reshape(-1) for p in (pieces if isinstance(pieces, Stacked)
                                                  else (pieces,))])
        chunks = m.scale.shape[0]
        payload = torch.nn.functional.pad(flat, (0, chunks * 256 - flat.numel()))
        return optim_lib.Moment(payload.reshape(chunks, 256), m.scale)

    return tree_lib.map_leaves(one, moments, spec_ref)


def state_tree(params: dict, opt_state: optim_lib.AdamState, cfg, tm=None) -> dict:
    """The tree a checkpoint holds: ``{"params": the reference's layout,
    "opt_state": {"step", "mu", "nu"}}`` with each moment a ``{"payload",
    "scale"}`` dict (the reference's ``_detuple``); under ``tm`` (a
    :class:`~repro_torch.train.trainstep.TrainMesh`) the global tree,
    gathered from every rank's shards (a collective)."""
    layout = convert.reference_layout(params, cfg)
    mu, nu = opt_state.mu, opt_state.nu
    if tm is not None:
        spec_ref = convert.reference_layout(tm.spec, cfg)
        layout = _gathered(layout, spec_ref, tm)
        mu, nu = _global_moments(mu, spec_ref, tm), _global_moments(nu, spec_ref, tm)
    return {"params": layout,
            "opt_state": {"step": opt_state.step, "mu": _moments_to_dict(mu),
                          "nu": _moments_to_dict(nu)}}


def checkpoint_paths(cfg, tp: int = 1) -> list[tuple]:
    """Every leaf's key path of :func:`state_tree` for ``cfg``, in the order
    a checkpoint stores them (JAX's: keys sorted) — what reading a reference
    checkpoint needs in place of its treedef."""
    layout = convert.reference_layout(model_lib.specs(cfg, tp), cfg)
    mom = tree_lib.map_leaves(lambda _: {"payload": None, "scale": None}, layout)
    tree = {"params": layout, "opt_state": {"step": None, "mu": mom, "nu": mom}}
    return [path for path, _ in tree_lib.flatten(tree)]


_MOMENT_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}


def state_from_tree(tree: dict, cfg, device, moment_dtype: str, tm=None):
    """A restored checkpoint tree (CPU tensors, the global tree) → (params,
    optimizer state) on ``device``; the moments must be of
    ``moment_dtype``.  Under ``tm`` the rank's shards of both."""
    params = convert.params_from_numpy(tree["params"], cfg, device,
                                       tp=1 if tm is None else tm.tp)
    if tm is not None:
        params = tm.shard(params)
    layout = convert.reference_layout(params, cfg)
    shards = None if tm is None else tm.shards

    def moment(leaf, m, sh=None):
        payload, scale = m["payload"].to(device), m["scale"].to(device)
        found = _MOMENT_DTYPES.get(payload.dtype)
        if found != moment_dtype:
            raise ValueError(f"checkpoint moments are {found or payload.dtype}, the "
                             f"trainer's {moment_dtype}")
        pieces = tuple(leaf) if isinstance(leaf, Stacked) else (leaf,)
        if sh is not None and found == "int8":  # the rank's codes off the global grid
            flat = payload.reshape(-1)
            own = [flat[sh.flat(i, device)].reshape(p.shape) for i, p in enumerate(pieces)]
        elif sh is not None:  # the global moment's pieces → the rank's shards
            glob = payload.unbind(0) if isinstance(leaf, Stacked) else (payload,)
            own = [P.take_index(g, index).clone(memory_format=torch.contiguous_format)
                   for g, index in zip(glob, sh.indices)]
        elif found != "int8":
            own = list(payload.unbind(0)) if isinstance(leaf, Stacked) else [payload]
        else:
            return optim_lib.Moment(payload, scale)
        return optim_lib.Moment(Stacked(own) if isinstance(leaf, Stacked) else own[0], scale)

    opt = tree["opt_state"]
    if shards is None:
        mu = tree_lib.map_leaves(moment, layout, opt["mu"])
        nu = tree_lib.map_leaves(moment, layout, opt["nu"])
    else:
        mu = tree_lib.map_leaves(moment, layout, opt["mu"], shards)
        nu = tree_lib.map_leaves(moment, layout, opt["nu"], shards)
    return params, optim_lib.AdamState(opt["step"].to(device), mu, nu)

