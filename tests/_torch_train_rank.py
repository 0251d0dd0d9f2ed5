"""One rank of the port's mesh-training CPU tests (``tests/test_torch_distributed.py``).

Run as ``python tests/_torch_train_rank.py '<json>'`` with ``rank``,
``world`` (4), ``port`` and ``workdir``: the rank joins a gloo process
group on ``tcp://localhost:<port>`` and runs every case in turn, each on
its own ``DeviceMesh`` of the four ranks, writing what it computed to
``workdir/<case>_rank<r>.npz``:

* ``dm_f32`` / ``dm_int8``: ``(data=2, model=2)``, FSDP + TP, two train
  steps with f32 or int8 moments from the reference's parameters
  (``workdir/params.npz``), the first batch's labels masked on one data
  rank only; the first step's loss, metrics and global gradients, the
  global state after each step, the rank's replicated leaves;
* ``dm_mb2``: the same mesh, one step of two microbatches (each rank's
  two slices fall in the reference's two microbatches of the global batch);
* ``pod``: ``(pod=2, data=2)`` with ``compress_pod_grads``: the global
  gradient before and after the compressed hop, one step's state; and the
  standalone ``compressed_psum`` over ``pod`` on distinct values;
* ``pipe``: ``(pipe=2, data=2)``: ``pipeline_apply`` of a tanh stage
  (``pipe_stage.npz``) and of the 2-layer cut's two layers as stages,
  against the sequential stack;
* ``ckpt``: the trainer at ``(data=2, model=2)`` with a failure injected at
  step 3, checkpoints every 2 steps into ``workdir/ckpt``.

It imports only ``repro_torch``, torch and numpy; the test module imports
this one for the shared settings.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

ARCH = "qwen3-1.7b"
WORLD = 4
#: the data stream: rows, tokens a row, seed
DATA = dict(seq_len=16, global_batch=4, seed=1)
LR = 1e-3
#: the first batch's first row (data rank 0's) has its first labels masked
MASKED = 5
STEPS = 2
#: seconds a collective waits for a rank that does not come
COLLECTIVE_TIMEOUT_S = 120
#: the pipeline: microbatches, rows a microbatch, width of the tanh stage
PIPE_M, PIPE_MB, PIPE_W = 6, 2, 16
#: the trainer case: steps, checkpoint period, the injected failure
TRAINER = dict(steps=4, ckpt_every=2, fail_at=(3,))


def smoke_cfg(lib):
    """qwen3-1.7b's smoke config in float32 (``lib``: a configs getter and
    its float32)."""
    get, f32 = lib
    return get(ARCH).scaled(dtype=f32)


def batches(src) -> list:
    """The steps' host batches: the first with row 0's first labels masked."""
    out = [src.batch(i) for i in range(STEPS)]
    out[0]["labels"][0, :MASKED] = -1
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, a in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return out


def _flat(tree, prefix="") -> dict:
    """A nested dict of tensors / numpy arrays / Stacked → ``{"a/b": array}``
    (a Stacked stacked; copies, so later in-place updates do not reach
    them)."""
    from repro_torch.convert import Stacked

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, Stacked):
        return {prefix[:-1]: np.stack([t.detach().numpy() for t in tree])}
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().numpy().copy()}
    return {prefix[:-1]: np.array(tree)}


def _state(params, state, cfg, tm) -> dict:
    from repro_torch.train import trainer

    tree = trainer.state_tree(params, state, cfg, tm)
    return {f"state/{k}": v for k, v in _flat(tree).items()}


def _replicated(params, tm) -> dict:
    """The rank's leaves no axis shards (bitwise equal on every rank)."""
    from repro_torch import tree as tree_lib
    from repro_torch.sharding import partitioning as P

    out = {}
    for (path, leaf), (_, spec) in zip(tree_lib.flatten(params), tree_lib.flatten(tm.spec)):
        if not P.sharded_dims(spec, tm.rules, tm.view.sizes):
            out["replicated/" + "/".join(path)] = leaf.detach().numpy()
    return out


def train_case(name, mesh, tp, params, cfg, moment, workdir, rank, compress=False,
               microbatches=1, steps=STEPS) -> None:
    from repro_torch import convert
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch, to_device
    from repro_torch.optim import adamw
    from repro_torch.train import trainstep

    def glob(tree):  # the global tree in the reference's layout
        return _flat(convert.reference_layout(tm.gather(tree), cfg))

    opt = adamw.adamw(LR, moment_dtype=moment)
    step_cfg = trainstep.TrainStepConfig(compress_pod_grads=compress,
                                         microbatches=microbatches)
    step = trainstep.make_train_step(cfg, opt, tp=tp, mesh=mesh, step_cfg=step_cfg)
    tm = step.mesh
    mine = tm.shard(tree_lib.map_leaves(torch.clone, params))
    state = trainstep.init_opt_state(opt, mine, cfg, tm)
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **DATA))
    out: dict = {}
    for i, host in enumerate(batches(src)[:steps]):
        batch = to_device(shard_batch(host, tm.view, tm.rules), "cpu")
        if i == 0:  # the first step's gradients, as the optimizer sees them
            loss, metrics, grads = trainstep.compute_grads(mine, batch, cfg, step_cfg, tm)
            grads = trainstep.sync_grads(grads, tm)
            out.update({f"grads/{k}": v for k, v in glob(grads).items()})
            if compress:
                after = trainstep.compress_pod(grads, cfg, tm)
                out.update({f"compressed/{k}": v for k, v in glob(after).items()})
        tm.view.reset_counts()
        mine, state, metrics = step(mine, state, batch)
        out.update({f"step{i}/{k}": v.numpy() for k, v in metrics.items()})
        out[f"step{i}/calls"] = np.array(json.dumps(tm.view.calls))
        out.update({f"step{i}/{k}": v for k, v in _state(mine, state, cfg, tm).items()})
    out.update(_replicated(mine, tm))
    np.savez(f"{workdir}/{name}_rank{rank}.npz", **out)


def pod_psum(mesh, workdir, rank) -> None:
    """``compressed_psum`` over ``pod`` on distinct values: 1.0 on pod 0, 3.0
    on pod 1 (the reference's own check), and on a seeded array."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.mesh import MeshView

    view = MeshView.from_mesh(mesh)
    pod = view.axes["pod"]
    x = torch.full((8, 16), 1.0 + 2.0 * pod.rank)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(64, 32)).astype(np.float32))
    np.savez(f"{workdir}/psum_rank{rank}.npz",
             distinct=collectives.compressed_psum(x, pod).numpy(),
             same=collectives.compressed_psum_tree({"g": g}, view, "pod")["g"].numpy(),
             exact=collectives.exact_psum_mean(x, pod).numpy())


def pipe_case(mesh, params, cfg, workdir, rank) -> None:
    from repro_torch import convert
    from repro_torch.distributed import pipeline
    from repro_torch.distributed.mesh import MeshView
    from repro_torch.models import stack
    from repro_torch.tree import map_leaves

    view = MeshView.from_mesh(mesh)
    with np.load(f"{workdir}/pipe_stage.npz") as z:
        ws, xs = torch.from_numpy(z["ws"]), torch.from_numpy(z["xs"])
    tanh = pipeline.pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, xs, view, axis="pipe")
    # the 2-layer cut: one layer a stage, the layers' leaves stacked [L, ...]
    layers = convert.reference_layout(params, cfg)["stack"]["slot0"]
    stages = pipeline.split_stages(map_leaves(lambda t: torch.stack(tuple(t)), layers), 2)
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(PIPE_M, PIPE_MB, 8, cfg.d_model)).astype(np.float32))

    def stage_fn(p, x):
        for j in range(p["ln1"]["scale"].shape[0]):
            x, _, _ = stack.layer_apply(map_leaves(lambda a: a[j], p), x, cfg, mode="train")
        return x

    got = pipeline.pipeline_apply(stage_fn, stages, h, view, axis="pipe")
    with torch.no_grad():
        want = h
        for p in params["layers"]:
            want = torch.stack([stack.layer_apply(p, x, cfg, mode="train")[0] for x in want])
    np.savez(f"{workdir}/pipe_rank{rank}.npz", tanh=tanh.numpy(), layers=got.numpy(),
             sequential=want.numpy(), calls=np.array(json.dumps(view.calls)))


def trainer_case(mesh, cfg, workdir, rank) -> None:
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed.resilience import FailureSim
    from repro_torch.train import trainer as trainer_lib

    steps, every, fail_at = TRAINER["steps"], TRAINER["ckpt_every"], TRAINER["fail_at"]
    tr = trainer_lib.Trainer(
        cfg, DataConfig(vocab_size=cfg.vocab_size, **DATA),
        trainer_lib.TrainerConfig(steps=steps, ckpt_every=every, ckpt_dir=f"{workdir}/ckpt",
                                  log_every=1, peak_lr=LR, warmup=1),
        mesh=mesh, tp=2, failure_sim=FailureSim(fail_at=fail_at), device="cpu")
    out = tr.run()
    np.savez(f"{workdir}/trainer_rank{rank}.npz",
             steps=np.array([h["step"] for h in out["history"]]),
             losses=np.array([h["loss"] for h in out["history"]]))


def main(argv) -> int:
    args = json.loads(argv[1])
    rank, world, workdir = args["rank"], args["world"], args["workdir"]
    torch.set_num_threads(1)
    from repro_torch import configs, convert
    from repro_torch.distributed import mesh as mesh_lib

    mesh_lib.init(rank=rank, world_size=world, init_method=f"tcp://localhost:{args['port']}",
                  device="cpu", backend="gloo", timeout_s=COLLECTIVE_TIMEOUT_S)
    cfg = smoke_cfg((configs.get_smoke_config, torch.float32))
    with np.load(f"{workdir}/params.npz") as z:
        params = convert.params_from_numpy(_nest({k: z[k] for k in z.files}), cfg, "cpu")
    dm = mesh_lib.device_mesh("cpu", (2, 2), ("data", "model"))
    for moment in ("f32", "int8"):
        train_case(f"dm_{moment}", dm, 2, params, cfg, moment, workdir, rank)
    train_case("dm_mb2", dm, 2, params, cfg, "f32", workdir, rank, microbatches=2, steps=1)
    pod = mesh_lib.device_mesh("cpu", (2, 2), ("pod", "data"))
    train_case("pod", pod, 1, params, cfg, "f32", workdir, rank, compress=True)
    pod_psum(pod, workdir, rank)
    pipe = mesh_lib.device_mesh("cpu", (2, 2), ("pipe", "data"))
    pipe_case(pipe, params, cfg, workdir, rank)
    trainer_case(dm, cfg, workdir, rank)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
