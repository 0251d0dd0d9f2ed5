"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Materialises a model from seed 0 on the device, converting each weight to
the requested residency policy as it is drawn (so that qwen1.5-32b's
float weights never sit whole beside their converted form), and serves
synthetic requests
through the continuous-batching engine, reporting throughput and
TTFT/TPOT percentiles.  The defaults are the reference launcher's:
``--mode w8a8``, the config's own decode cache (``bf16`` for qwen3-1.7b)
and ``--scheduler fcfs``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --mode ffn=bsdp_fused,mixer=w8a16 --cache-format int4_bp_fused \\
        --scheduler token_budget:budget=32

``--device`` defaults to ``cuda`` and the run fails when no GPU is
present; ``--device cpu`` runs the kernels' plain versions instead.  The
VLM and encoder-decoder configs need a context that no request carries,
so the launcher refuses them, as the reference's does.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core import kvcache, residency
from repro_torch.serve import engine
from repro_torch.serve import scheduler as sched_lib


def registry_arg(parse):
    """argparse ``type=`` wrapper that surfaces the registry's own error."""

    def convert(text):
        try:
            return parse(text)
        except (ValueError, KeyError, TypeError) as e:
            raise argparse.ArgumentTypeError(str(e) or repr(e)) from e

    return convert


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", default="w8a8",
                    type=registry_arg(residency.ResidencySpec.parse),
                    help="registered format name (one of "
                         f"{', '.join(residency.formats())}) or a per-layer "
                         "policy like 'ffn=bsdp_fused,mixer=w8a16'")
    ap.add_argument("--cache-format", default=None,
                    type=registry_arg(lambda s: kvcache.get_cache_format(s).name),
                    help=f"decode-cache residency (one of {', '.join(kvcache.formats())}; "
                         "default: the arch config's)")
    ap.add_argument("--scheduler", default="fcfs",
                    type=registry_arg(sched_lib.make_scheduler),
                    help="orchestration policy (one of "
                         f"{', '.join(sched_lib.schedulers())}), with "
                         "optional kwargs like 'token_budget:budget=16'")
    ap.add_argument("--min-dim", type=int, default=64,
                    help="residency-conversion floor (smaller projections stay float)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_enc_dec or cfg.family == "vlm":
        raise SystemExit(
            f"{args.arch} needs a frontend-context request path; use the "
            "prefill/decode API directly (repro_torch.models.model.prefill and "
            "decode_step take the context)."
        )
    t0 = time.perf_counter()
    params = engine.materialize_converted(cfg, args.mode, seed=0, device=args.device,
                                          min_dim=args.min_dim)
    eng = engine.ServeEngine(params, cfg, slots=args.slots, max_len=args.max_len,
                             mode=args.mode, cache_format=args.cache_format,
                             scheduler=args.scheduler, min_dim=args.min_dim,
                             device=args.device)
    print(f"draw + residency convert ({eng.mode}): {time.perf_counter() - t0:.2f}s, "
          f"{engine.resident_bytes(eng.params) / 1e6:.1f} MB resident")
    print(f"cache format: {eng.cache_format}  scheduler: {eng.scheduler.describe()}  "
          f"device: {eng.device}")
    rng = np.random.default_rng(0)
    reqs = [
        eng.submit(rng.integers(0, cfg.vocab_size, size=(int(n),)).astype(np.int32),
                   args.max_new)
        for n in rng.integers(4, 16, size=args.requests)
    ]
    t0 = time.perf_counter()
    eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in reqs)
    st = eng.stats()
    print(f"served {len(reqs)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s)")

    def ms(v):
        return "-" if v is None else f"{v * 1e3:.1f}ms"

    print(f"TTFT p50/p95: {ms(st.percentile('ttft_s', 50))}/"
          f"{ms(st.percentile('ttft_s', 95))}  TPOT p50: {ms(st.percentile('tpot_s', 50))}")


if __name__ == "__main__":
    main()
