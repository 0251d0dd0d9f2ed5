"""Quickstart: train a tiny LM, quantize it, serve one completion.

Twin of the JAX package's ``examples/quickstart.py``::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the public API end to end:

1. pick an architecture config (the reduced qwen3 topology: 2 layers,
   vocab 256);
2. train it for 40 steps on the synthetic pipeline (8 rows of 64 tokens);
3. convert the trained weights to the paper's int8 residency (``w8a8``, a
   one-time transform);
4. prefill an 8-token prompt and decode 8 tokens greedily against the
   quantized weights (``matmul_int8`` on the card).

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import model as model_lib
from repro_torch.serve import engine
from repro_torch.train.trainer import Trainer, TrainerConfig


def generate(params, cfg, prompt: torch.Tensor, new_tokens: int) -> list[int]:
    """Convert ``params`` to ``w8a8`` (``min_dim=16``), prefill ``prompt``
    ``[1, S]`` and decode ``new_tokens`` more greedily → the ``1 +
    new_tokens`` tokens picked."""
    qparams = engine.convert_params(params, cfg, "w8a8", min_dim=16)
    with torch.no_grad():
        logits, caches = model_lib.prefill(qparams, {"tokens": prompt}, cfg, max_len=32)
        toks = [int(torch.argmax(logits[0, -1]))]
        pos = prompt.shape[1]
        for _ in range(new_tokens):
            token = torch.tensor([[toks[-1]]], dtype=torch.int64, device=prompt.device)
            lg, caches = model_lib.decode_step(qparams, token, caches, pos, cfg)
            toks.append(int(torch.argmax(lg[0, 0])))
            pos += 1
    return toks


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("qwen3-1.7b").scaled(n_layers=2, vocab_size=256)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)

    print(f"== training {cfg.name} (reduced) ==")
    tr = Trainer(cfg, data, TrainerConfig(steps=args.steps, log_every=10, peak_lr=3e-3,
                                          warmup=5, ckpt_dir=None), device=args.device)
    out = tr.run()
    for h in out["history"]:
        print(f"  step {h['step']:3d}  loss {h['loss']:.3f}  ({h['sec'] * 1e3:.0f} ms)")

    print("== converting to int8 residency (W8A8, one-time transform), then serving ==")
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 8)), dtype=torch.int64,
                             device=tr.device)
    toks = generate(out["params"], cfg, prompt, args.new_tokens)
    print(f"  prompt tokens : {prompt[0].tolist()}")
    print(f"  generated     : {toks}")
    print("quickstart OK")
    return {"history": out["history"], "prompt": prompt[0].tolist(), "tokens": toks,
            "params": out["params"], "cfg": cfg}


if __name__ == "__main__":
    main()
