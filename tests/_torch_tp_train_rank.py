"""One rank of the port's tensor-parallel and split-batch training CPU tests
(``tests/test_torch_tp_train.py``).

Run as ``python tests/_torch_tp_train_rank.py '<json>'`` with ``rank``,
``world``, ``port``, ``workdir``, ``arch``, ``shape`` (``[data, model]``)
and ``microbatches``: the rank joins a gloo process group on
``tcp://localhost:<port>``, builds a ``(data, model)`` ``DeviceMesh`` of
the world, loads the weights (``workdir/params.npz``, the reference's
layout) and the steps' host batches (``workdir/batches.npz``), and runs
:data:`STEPS` train steps with f32 moments, writing to
``workdir/rank<r>.npz``: the first step's global gradients, each step's
metrics, recorded collectives beside ``dryrun.train_step_collectives``'
count and the global state, the rank's replicated leaves, and its
parameter and optimizer-state bytes beside ``dryrun.rank_bytes``'.

It imports only ``repro_torch``, torch and numpy (and this directory's
``_torch_train_rank`` for the shared helpers); the test module imports this
one for the settings.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

import _torch_train_rank as T

#: the parts: name → (arch, (data, model), microbatches), the slowest (the
#: reference's compile) first, so that the test workers start them first
PARTS = {
    "jamba_1x2": ("jamba-1.5-large-398b", (1, 2), 1),
    "deepseek_2x2": ("deepseek-v2-lite-16b", (2, 2), 1),
    "deepseek_1x2": ("deepseek-v2-lite-16b", (1, 2), 1),
    "deepseek_2x1_mb2": ("deepseek-v2-lite-16b", (2, 1), 2),
    "llama_vision_1x2": ("llama-3.2-vision-11b", (1, 2), 1),
    "seamless_1x2": ("seamless-m4t-medium", (1, 2), 1),
    "mixtral_1x3_hidden": ("mixtral-8x7b", (1, 3), 1),
    "mixtral_1x2": ("mixtral-8x7b", (1, 2), 1),
    "falcon_mamba_1x2": ("falcon-mamba-7b", (1, 2), 1),
    "minicpm3_1x2": ("minicpm3-4b", (1, 2), 1),
}
#: the data stream: rows, tokens a row, seed (4 rows: 2 a data rank, and
#: two microbatches of 1 a data rank)
DATA = dict(seq_len=16, global_batch=4, seed=1)
LR = 1e-3
STEPS = 2
#: the first batch's first row (data rank 0's) has its first labels masked
MASKED = 5
COLLECTIVE_TIMEOUT_S = 120


def cfg_for(arch: str, tp: int, lib):
    """``arch``'s smoke config in float32 (``lib``: a configs getter and its
    float32).  The experts of a MoE config that the model axis does not
    divide (tp = 3) are sharded by their hidden width, at
    ``tests/test_torch_tp_moe.py``'s widths: the FFNs 96 wide, the experts
    48, capacity factor 1.25."""
    get, f32 = lib
    cfg = get(arch).scaled(dtype=f32)
    if tp == 3:
        cfg = cfg.scaled(d_ff=96, moe_d_ff=48, capacity_factor=1.25)
    return cfg


def batches(src, cfg) -> list:
    """The steps' host batches (numpy): the first with row 0's first labels
    masked; a VLM's patch embeddings or an encoder-decoder's frames,
    ``[rows, encoder_tokens, d_model]``, seeded by the step."""
    out = []
    for i in range(STEPS):
        b = src.batch(i)
        if i == 0:
            b["labels"][0, :MASKED] = -1
        ctx = (DATA["global_batch"], cfg.encoder_tokens, cfg.d_model)
        rng = np.random.default_rng(10 + i)
        if cfg.is_enc_dec:
            b["enc_embeds"] = rng.normal(size=ctx).astype(np.float32)
        if cfg.family == "vlm":
            b["ctx_embeds"] = rng.normal(size=ctx).astype(np.float32)
        out.append(b)
    return out


def main(argv) -> int:
    args = json.loads(argv[1])
    rank, world, workdir = args["rank"], args["world"], args["workdir"]
    shape, m = tuple(args["shape"]), args["microbatches"]
    torch.set_num_threads(1)
    from repro_torch import configs, convert
    from repro_torch.data.pipeline import shard_batch, to_device
    from repro_torch.distributed import mesh as mesh_lib
    from repro_torch.launch import dryrun
    from repro_torch.optim import adamw
    from repro_torch.train import trainstep

    mesh_lib.init(rank=rank, world_size=world, init_method=f"tcp://localhost:{args['port']}",
                  device="cpu", backend="gloo", timeout_s=COLLECTIVE_TIMEOUT_S)
    cfg = cfg_for(args["arch"], shape[1], (configs.get_smoke_config, torch.float32))
    with np.load(f"{workdir}/params.npz") as z:
        params = convert.params_from_numpy(T._nest({k: z[k] for k in z.files}), cfg, "cpu")
    with np.load(f"{workdir}/batches.npz") as z:
        hosts = [T._nest({k: z[k] for k in z.files})[str(i)] for i in range(STEPS)]
    mesh = mesh_lib.device_mesh("cpu", shape, ("data", "model"))
    opt = adamw.adamw(LR, moment_dtype="f32")
    step_cfg = trainstep.TrainStepConfig(microbatches=m)
    step = trainstep.make_train_step(cfg, opt, tp=shape[1], mesh=mesh, step_cfg=step_cfg)
    tm = step.mesh
    mine = tm.shard(params)
    del params
    state = trainstep.init_opt_state(opt, mine, cfg, tm)
    axes = {k: a.size for k, a in tm.view.axes.items()}
    counted = dryrun.rank_bytes(cfg, "train", mesh_axes=axes, rules=tm.rules, moments="f32")
    out: dict = {"bytes": np.array(json.dumps(
        [[T._bytes(mine), T._bytes(state)], [counted["params"], counted["moments"]]]))}
    for i, host in enumerate(hosts):
        batch = to_device(shard_batch(host, tm.view, tm.rules), "cpu")
        if i == 0:  # the first step's gradients, as the optimizer sees them
            _, _, grads = trainstep.compute_grads(mine, batch, cfg, step_cfg, tm)
            grads = convert.reference_layout(tm.gather(trainstep.sync_grads(grads, tm)), cfg)
            out.update({f"grads/{k}": v for k, v in T._flat(grads).items()})
            del grads
        tm.view.reset_counts()
        mine, state, metrics = step(mine, state, batch)
        out.update({f"step{i}/{k}": v.numpy() for k, v in metrics.items()})
        want = dryrun.train_step_collectives(
            cfg, mesh_axes=axes, rules=tm.rules, rows=batch["tokens"].shape[0],
            seq=batch["tokens"].shape[1], microbatches=m, remat=step_cfg.remat, moments="f32")
        out[f"step{i}/collectives"] = np.array(json.dumps(dryrun.held_collectives(tm.view, want)))
        out.update({f"step{i}/{k}": v for k, v in T._state(mine, state, cfg, tm).items()})
    out.update(T._replicated(mine, tm))
    np.savez(f"{workdir}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
