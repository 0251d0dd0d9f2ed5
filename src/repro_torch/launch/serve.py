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

``--ckpt-dir DIR`` serves the parameters of the latest checkpoint under
DIR (one the port's trainer wrote, or the reference's: the parameters are
read through :mod:`repro_torch.checkpoint.ckpt` and brought across with
``params_from_numpy``) in place of seed 0's draw, converted to the
residency policy after the restore.
``--cache-format`` and ``--scheduler`` take any registered name, the
``paged_*`` cache formats and the ``prefix_cache`` scheduler included.
``--trace out.json`` writes the run's observability stream as a
Chrome-trace / Perfetto document (check it with ``python -m
repro_torch.obs.validate out.json``) and ``--stats-every N`` prints one
stats line to stderr every N engine steps.  ``--device`` defaults to
``cuda`` and the run fails when no GPU is present; ``--device cpu`` runs
the kernels' plain versions instead.  The VLM and encoder-decoder configs
need a context that no request carries, so the launcher refuses them, as
the reference's does.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import convert, obs
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core import kvcache, residency
from repro_torch.serve import engine
from repro_torch.serve import scheduler as sched_lib
from repro_torch.train.trainer import checkpoint_paths


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
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the latest checkpoint's parameters (the port's or the "
                         "reference's trainer) instead of seed 0's")
    ap.add_argument("--min-dim", type=int, default=64,
                    help="residency-conversion floor (smaller projections stay float)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write the run's spans, counters and request events as a "
                         "Chrome-trace / Perfetto JSON document to this path")
    ap.add_argument("--stats-every", type=int, default=0, metavar="N",
                    help="print one serving stats line to stderr every N engine "
                         "steps (0 = off)")
    args = ap.parse_args(argv)

    trace_sink = stats_sink = None
    if args.trace:
        trace_sink = obs.register_sink(obs.ChromeTraceSink(args.trace))
    if args.stats_every > 0:
        stats_sink = obs.register_sink(obs.StatsLineSink(every=args.stats_every))
    try:
        _serve(args)
    finally:
        for sink in (trace_sink, stats_sink):
            obs.unregister_sink(sink)
    if trace_sink is not None:
        trace_sink.close()
        print(f"trace: {len(trace_sink)} records -> {args.trace}")


def checkpoint_params(ckpt_dir: str, cfg, device) -> dict:
    """The float parameters of the latest checkpoint under ``ckpt_dir`` (a
    trainer's ``{"params", "opt_state"}`` tree, the port's or the
    reference's) on ``device``."""
    tree, _ = ckpt_lib.restore(ckpt_dir, paths=checkpoint_paths(cfg))
    return convert.params_from_numpy(tree["params"], cfg, device)


def _serve(args) -> None:

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_enc_dec or cfg.family == "vlm":
        raise SystemExit(
            f"{args.arch} needs a frontend-context request path; use the "
            "prefill/decode API directly (repro_torch.models.model.prefill and "
            "decode_step take the context)."
        )
    t0 = time.perf_counter()
    if args.ckpt_dir:
        params = engine.convert_params(checkpoint_params(args.ckpt_dir, cfg, args.device), cfg,
                                       args.mode, min_dim=args.min_dim)
    else:
        params = engine.materialize_converted(cfg, args.mode, seed=0, device=args.device,
                                              min_dim=args.min_dim)
    eng = engine.ServeEngine(params, cfg, slots=args.slots, max_len=args.max_len,
                             mode=args.mode, cache_format=args.cache_format,
                             scheduler=args.scheduler, min_dim=args.min_dim,
                             device=args.device)
    source = f"restore {args.ckpt_dir}" if args.ckpt_dir else "draw"
    print(f"{source} + residency convert ({eng.mode}): {time.perf_counter() - t0:.2f}s, "
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
    if st.pages is not None:
        print("pages: " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                                    for k, v in st.pages.items()))


if __name__ == "__main__":
    main()
