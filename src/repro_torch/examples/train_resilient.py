"""Fault-tolerant training demo: checkpoints, an injected failure, a restart.

Twin of the JAX package's ``examples/train_resilient.py``::

    PYTHONPATH=src python -m repro_torch.examples.train_resilient [--device cpu]

Trains the reduced jamba (Mamba + attention + MoE, the most demanding
topology of the configs) with asynchronous checkpoints every 10 steps,
fails it before step 23 through the failure injector, and shows the
trainer restoring from the step-20 checkpoint and completing; prints the
watchdog's straggler telemetry.  The steps, the checkpoint period and the
failure are options, so a short run shows the same loop.  Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed.resilience import FailureSim
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=23)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("jamba-1.5-large-398b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    resume = args.fail_at // args.ckpt_every * args.ckpt_every
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(
            cfg, data,
            TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                          log_every=args.log_every, ckpt_dir=d, peak_lr=1e-3, warmup=5,
                          moment_dtype="bf16"),
            failure_sim=FailureSim(fail_at=(args.fail_at,)), device=args.device,
        )
        out = tr.run()
    seen = [h["step"] for h in out["history"]]
    print("logged steps:", seen)
    print(f"final loss  : {out['history'][-1]['loss']:.3f}")
    print(f"stragglers  : {out['stragglers']}")
    assert args.steps - 1 in seen, "run did not complete after restart"
    print(f"train_resilient OK — failure at step {args.fail_at} recovered from the "
          f"step-{resume} checkpoint")
    return out


if __name__ == "__main__":
    main()
