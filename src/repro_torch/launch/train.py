"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the trainer loop (checkpoints, watchdog, restart) on one device, the
card by default, the plain path with ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --device cpu --steps 50 --ckpt-dir /tmp/ckpt

or over a ``(data, model)`` mesh when ``--data`` · ``--model`` is above 1
(``--data 0``, the default, counts as 1 beside ``--model``): the launcher
spawns one rank process a mesh place on this host, each joining a process
group of ``--backend`` on ``tcp://localhost:<a free port>``, and the rules
come from ``launch.mesh.plan`` with a train ``ShapeCell`` (FSDP over
``data``), as the reference launcher's do::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --device cpu --backend gloo --data 2 --steps 20 --ckpt-dir /tmp/ckpt

``--backend`` defaults to ``nccl`` on the card and ``gloo`` on the CPU.
``nccl`` needs a card a rank (rank r on ``cuda:r``) and is refused when the
ranks outnumber the cards; ``gloo`` lets ranks share the cards (rank r on
``cuda:(r mod cards)``).  ``--ckpt-dir`` resumes from the latest checkpoint
there (the port's or the reference's, written at any mesh: it holds the
global tree) and writes one every ``--ckpt-every`` steps and at the end.
Rank 0 prints the history.
"""

from __future__ import annotations

import argparse
import json
import socket
import sys

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import MOMENT_DTYPES

#: seconds a rank's collective waits for another before it raises, and the
#: spawned ranks' wall limit
COLLECTIVE_TIMEOUT_S = 600
JOIN_S = 24 * 3600


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--peak-lr", type=float, default=1e-3)
    ap.add_argument("--moment-dtype", default="f32", choices=MOMENT_DTYPES)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data", type=int, default=0,
                    help="data-parallel ways (0 or 1 = no data parallelism)")
    ap.add_argument("--model", type=int, default=1, help="tensor-parallel ways")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend over a mesh (default: nccl on the card, "
                         "gloo on the CPU)")
    ap.add_argument("--device", default="cuda")
    return ap


def _cfg(args):
    return get_smoke_config(args.arch) if args.smoke else get_config(args.arch)


def _trainer(args, *, mesh=None, rules=None, device=None):
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = _cfg(args)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    return Trainer(
        cfg, data,
        TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                      peak_lr=args.peak_lr, moment_dtype=args.moment_dtype,
                      microbatches=args.microbatches),
        mesh=mesh, rules=rules, tp=args.model, device=device or args.device)


def _report(out: dict, where: str) -> None:
    for h in out["history"]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  {h['sec'] * 1e3:.0f} ms")
    print(f"done in {out['total_sec']:.1f}s on {where}; stragglers={out['stragglers']}")


def _rank_device(device, rank: int):
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank(rank: int, argv: list, port: int) -> None:
    """One rank: join the group, build the ``(data, model)`` mesh and the
    plan's rules, run the trainer."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import mesh as mesh_lib
    from repro_torch.launch.mesh import plan

    args = _parser().parse_args(argv)
    data, world = max(args.data, 1), max(args.data, 1) * args.model
    device = _rank_device(args.device, rank)
    mesh_lib.init(rank=rank, world_size=world, init_method=f"tcp://localhost:{port}",
                  device=device, backend=args.backend, timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        mesh = mesh_lib.device_mesh(device, (data, args.model), ("data", "model"))
        cell = ShapeCell("cli", args.seq_len, args.global_batch, "train")
        tr = _trainer(args, device=device, mesh=mesh, rules=plan(_cfg(args), cell, mesh).rules)
        out = tr.run()
        if rank == 0:
            _report(out, f"{world} ranks ({data} data x {args.model} model, {args.backend}) "
                         f"on {device}")
            print(json.dumps({"collectives": tr.mesh.view.calls,
                              "collective_s": tr.mesh.view.collective_s}))
            sys.stdout.flush()
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    ranks = max(args.data, 1) * args.model
    if ranks == 1:
        tr = _trainer(args)
        out = tr.run()
        _report(out, str(tr.device))
        return out

    import torch
    import torch.multiprocessing as mp

    from repro_torch import resolve_device
    from repro_torch.distributed.mesh import default_backend

    device = resolve_device(args.device)
    args.backend = args.backend or default_backend(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if args.backend == "nccl" and ranks > cards:
        raise SystemExit(f"--backend nccl needs a card a rank: {ranks} ranks, {cards} card(s); "
                         "--backend gloo lets ranks share a card")
    argv = argv + ["--backend", args.backend]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, argv, port)) for r in range(ranks)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise SystemExit(f"rank exit codes {codes}")
    return None


if __name__ == "__main__":
    main()
