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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch import convert, resolve_device
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.distributed.resilience import FailureSim, SimulatedFailure, StepWatchdog
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw as optim_lib
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
    def __init__(self, cfg, data_cfg: DataConfig, tcfg: TrainerConfig, *,
                 failure_sim: Optional[FailureSim] = None, device=None):
        self.cfg, self.data_cfg, self.tcfg = cfg, data_cfg, tcfg
        self.device = resolve_device(device)
        self.failure_sim = failure_sim
        self.watchdog = StepWatchdog()
        self.opt = optim_lib.adamw(
            optim_lib.cosine_schedule(tcfg.peak_lr, tcfg.warmup, tcfg.steps),
            moment_dtype=tcfg.moment_dtype,
        )
        self.step_fn = make_train_step(
            cfg, self.opt, step_cfg=TrainStepConfig(microbatches=tcfg.microbatches))
        self.ckpt = ckpt_lib.AsyncCheckpointer()
        self.history: list[dict] = []

    # -- state ---------------------------------------------------------

    def init_state(self):
        params = model_lib.draw(self.cfg, self.tcfg.seed, self.device)
        return params, init_opt_state(self.opt, params, self.cfg), 0

    def restore_state(self):
        d = self.tcfg.ckpt_dir
        step = ckpt_lib.latest_step(d) if d else None
        if step is None:
            return self.init_state()
        tree, extra = ckpt_lib.restore(d, step, paths=checkpoint_paths(self.cfg))
        params, opt_state = state_from_tree(tree, self.cfg, self.device,
                                            self.tcfg.moment_dtype)
        return params, opt_state, extra.get("step", step)

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
            batch = to_device(src.batch(step), self.device)
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
                self.ckpt.save(state_tree(params, opt_state, self.cfg),
                               self.tcfg.ckpt_dir, step + 1, extra={"step": step + 1})
        self.ckpt.wait()
        if self.tcfg.ckpt_dir:
            ckpt_lib.save(state_tree(params, opt_state, self.cfg), self.tcfg.ckpt_dir,
                          self.tcfg.steps, extra={"step": self.tcfg.steps})
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


def state_tree(params: dict, opt_state: optim_lib.AdamState, cfg) -> dict:
    """The tree a checkpoint holds: ``{"params": the reference's layout,
    "opt_state": {"step", "mu", "nu"}}`` with each moment a ``{"payload",
    "scale"}`` dict (the reference's ``_detuple``)."""
    return {"params": convert.reference_layout(params, cfg),
            "opt_state": {"step": opt_state.step, "mu": _moments_to_dict(opt_state.mu),
                          "nu": _moments_to_dict(opt_state.nu)}}


def checkpoint_paths(cfg) -> list[tuple]:
    """Every leaf's key path of :func:`state_tree` for ``cfg``, in the order
    a checkpoint stores them (JAX's: keys sorted) — what reading a reference
    checkpoint needs in place of its treedef."""
    layout = convert.reference_layout(model_lib.specs(cfg), cfg)
    mom = tree_lib.map_leaves(lambda _: {"payload": None, "scale": None}, layout)
    tree = {"params": layout, "opt_state": {"step": None, "mu": mom, "nu": mom}}
    return [path for path, _ in tree_lib.flatten(tree)]


_MOMENT_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}


def state_from_tree(tree: dict, cfg, device, moment_dtype: str):
    """A restored checkpoint tree (CPU tensors) → (params, optimizer state)
    on ``device``; the moments must be of ``moment_dtype``."""
    params = convert.params_from_numpy(tree["params"], cfg, device)
    layout = convert.reference_layout(params, cfg)

    def moment(leaf, m):
        payload, scale = m["payload"].to(device), m["scale"].to(device)
        found = _MOMENT_DTYPES.get(payload.dtype)
        if found != moment_dtype:
            raise ValueError(f"checkpoint moments are {found or payload.dtype}, the "
                             f"trainer's {moment_dtype}")
        if found != "int8" and isinstance(leaf, convert.Stacked):
            payload = convert.Stacked(payload.unbind(0))
        return optim_lib.Moment(payload, scale)

    opt = tree["opt_state"]
    state = optim_lib.AdamState(
        opt["step"].to(device), tree_lib.map_leaves(moment, layout, opt["mu"]),
        tree_lib.map_leaves(moment, layout, opt["nu"]))
    return params, state
