"""End-to-end serving example: the paper's GEMV-V scenario as a service.

Twin of the JAX package's ``examples/serve_quantized.py``::

    PYTHONPATH=src python -m repro_torch.examples.serve_quantized [--device cpu]
        [--modes bf16 w4a4_bsdp ...] [--scheduler token_budget:budget=4]

Serves the reduced qwen3 (2 layers, vocab 256) with batched,
continuously scheduled requests through
:class:`repro_torch.serve.engine.ServeEngine`, one row a residency entry:

* every registered weight format (:mod:`repro_torch.core.residency`),
  ``bsdp_fused`` among them (the FFN's batched rows through
  ``bsdp_gemm_fused``), then the mixed per-layer policies (BSDP FFN,
  ``w8a16`` attention, ``w8a8`` elsewhere);
* an entry ``mode+kv:cache_format`` also picks the decode cache
  (:mod:`repro_torch.core.kvcache`): the bit-plane cache under the BSDP
  FFN, the all-fused pairing ``ffn=bsdp_fused × int4_bp_fused`` (decode
  attention through ``plane_decode_attention``), and bit-plane pages
  (``paged_int4_bp``, :mod:`repro_torch.core.paging`);
* ``--scheduler`` picks the orchestration policy (fcfs | sjf |
  token_budget[:budget=N] | prefix_cache);
* the all-fused row is served once more with ``trace=True``, and the
  timeline's span summary and per-kernel dispatch table are printed
  (:mod:`repro_torch.obs`).  The port's dispatch counter fires at every
  execution, where the reference's fires once a traced program, so the
  table counts executions.

Each row reports tokens/s, resident weight and cache bytes, p50 TTFT in
the engine's work units (processed positions, ``ServeEngine.stats()``)
and the share of greedy tokens equal to the first row's.  Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.core import residency
from repro_torch.models import model as model_lib
from repro_torch.serve import engine

MIXED = "ffn=bsdp,mixer=w8a16,default=w8a8"
MIXED_FUSED = "ffn=bsdp_fused,mixer=w8a16,default=w8a8"
MODES = list(residency.formats()) + [
    MIXED, MIXED + "+kv:int4_bp", MIXED_FUSED + "+kv:int4_bp_fused",
    MIXED + "+kv:paged_int4_bp",
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", nargs="*", default=MODES)
    ap.add_argument("--scheduler", default="fcfs",
                    help="orchestration policy (fcfs | sjf | token_budget[:budget=N] | "
                         "prefix_cache)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("qwen3-1.7b").scaled(n_layers=2, vocab_size=256)
    params = model_lib.materialize(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in rng.integers(4, 12, size=args.requests)]

    reference = None
    rows = []
    print(f"{'mode':<57} {'tok/s':>8} {'resident MB':>12} {'cache MB':>9} "
          f"{'ttft p50':>9} {'agree@1':>8}")
    for entry in args.modes:
        # "mode" or "mode+kv:cache_format": weight x cache residency
        mode, _, cache_fmt = entry.partition("+kv:")
        # the residency conversion happens once, inside the engine
        eng = engine.ServeEngine(params, cfg, slots=3, max_len=64, mode=mode,
                                 cache_format=cache_fmt or None, scheduler=args.scheduler,
                                 min_dim=16, device=args.device)
        reqs = [eng.submit(p, args.max_new) for p in prompts]
        t0 = time.perf_counter()
        eng.run()
        dt = time.perf_counter() - t0
        toks = sum(len(r.out) for r in reqs)
        outs = [tuple(r.out) for r in reqs]
        if reference is None:
            reference, agree = outs, 1.0
        else:
            hits = sum(sum(a == b for a, b in zip(o, r)) for o, r in zip(outs, reference))
            agree = hits / max(sum(len(r) for r in reference), 1)
        st = eng.stats()
        counted = eng.resident_bytes()
        label = eng.mode + (f"+kv:{eng.cache_format}" if cache_fmt else "")
        rows.append(dict(label=label, tokens=toks, weights=counted["weights"],
                         cache=counted["cache"], ttft_work_p50=st.percentile("ttft_work", 50),
                         agree=agree, outs=outs))
        print(f"{label:<57} {toks / dt:8.1f} {counted['weights'] / 1e6:12.2f} "
              f"{counted['cache'] / 1e6:9.3f} {st.percentile('ttft_work', 50):9.1f} "
              f"{agree:8.2f}")
    print(f"scheduler: {eng.scheduler.describe()}")
    traced = _traced_excerpt(params, cfg, prompts, args)
    print("serve_quantized OK")
    return {"rows": rows, "traced": traced}


def _traced_excerpt(params, cfg, prompts, args) -> dict:
    """Serve the all-fused pairing once more with tracing on and print what
    the observability registry saw: a span summary of the step loop and the
    per-kernel dispatch table."""
    eng = engine.ServeEngine(params, cfg, slots=3, max_len=64, mode=MIXED_FUSED,
                             cache_format="int4_bp_fused", scheduler=args.scheduler,
                             min_dim=16, trace=True, device=args.device)
    for p in prompts:
        eng.submit(p, args.max_new)
    eng.run()
    timeline = eng.timeline()
    obs.unregister_sink(eng._ring)

    print(f"\ntraced run ({eng.mode}+kv:{eng.cache_format}): {len(timeline)} records")
    print(f"{'span':<18} {'count':>5} {'total ms':>9} {'p50 ms':>8}")
    spans = obs.summarize_spans(timeline)
    for name, s in sorted(spans.items()):
        print(f"{name:<18} {s['count']:>5} {s['total_s'] * 1e3:>9.1f} {s['p50_s'] * 1e3:>8.2f}")
    table = obs.dispatch_table(timeline)
    print("kernel dispatches (executions over the run):")
    for key, count in sorted(table.items()):
        labels = ",".join(f"{k}={v}" for k, v in key)
        print(f"  {labels:<40} {count}")
    return {"records": len(timeline), "spans": spans, "dispatches": table}


if __name__ == "__main__":
    main()
