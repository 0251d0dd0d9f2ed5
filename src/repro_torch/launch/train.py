"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the trainer loop (checkpoints, watchdog, restart) on one device: the
card by default, the plain path with ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --device cpu --steps 50 --ckpt-dir /tmp/ckpt

``--ckpt-dir`` resumes from the latest checkpoint there (the port's or the
reference's) and writes one every ``--ckpt-every`` steps and at the end.
Data and tensor parallelism (``--data`` / ``--model`` above 1) wait for the
sharding and distributed modules, and the launcher refuses them.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import MOMENT_DTYPES
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
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
                    help="data-parallel ways (0 or 1 = single device)")
    ap.add_argument("--model", type=int, default=1, help="tensor-parallel ways")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.data > 1 or args.model > 1:
        raise SystemExit("--data / --model above 1: data and tensor parallelism wait for the "
                         "sharding and distributed modules (ROADMAP Queue 1, item 8)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    tr = Trainer(
        cfg, data,
        TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                      peak_lr=args.peak_lr, moment_dtype=args.moment_dtype,
                      microbatches=args.microbatches),
        device=args.device,
    )
    out = tr.run()
    for h in out["history"]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  {h['sec'] * 1e3:.0f} ms")
    print(f"done in {out['total_sec']:.1f}s on {tr.device}; stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
