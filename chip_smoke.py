#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Builds the hand-written kernels from ``src/repro_torch/csrc``, holds each
one against its plain PyTorch version at the main path's shapes, serves
full-width, full-depth qwen3-1.7b (random weights from a seed) through
``ServeEngine`` with ``ffn=bsdp_fused,mixer=w8a16``, the ``int4_bp_fused``
cache and ``fcfs``, checks that every kernel of that path launched, and
compares the kernel path with the plain path on a 2-layer cut.  Any failure
is a nonzero exit.  It needs a CUDA device and the repository's ``src``;
without either it fails before printing a result.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit; the one before that a JSON object with every
kernel's launches, error against its plain version and times.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
MODE = "ffn=bsdp_fused,mixer=w8a16"
CACHE = "int4_bp_fused"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12  # dense int8 tensor cores
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
DEQUANT_RTOL = 2e-5  # of max|plain|: float32 sums over K = 2048 in another order
ATTN_TOL = 1e-4  # rtol = atol, as tests/test_kvcache.py holds the fused read
# Kernel path vs plain path on the 2-layer cut: dtype → (max |Δ|/max|logit|,
# min cosine).  The two paths run the same arithmetic except that each
# kernel sums in its own order (float32, ~1e-6 relative).  The activations
# are re-quantized to int4 before every bit-plane product and every cache
# read, so a last-bit difference that lands on an int4 rounding boundary (or
# on a row's max|x|, which sets its scale) becomes one int4 step of that
# row.  In float32 that is rare; in bf16 every cast can move an element by
# 2^-8, so the bf16 limits are the ones tests/test_serve_bsdp.py sets for
# int4 noise against bf16.
PATH_LIMITS = {"float32": (0.05, 0.999), "bfloat16": (0.5, 0.9)}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


class Timer:
    """Median of CUDA-event times of single calls, with the 50 MB L2 flushed
    before each call (the serving path finds the weights cold)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.int8, device=device)

    def ms(self, fn, reps: int = 25) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in events:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(bytes_moved: float, ops_time_s: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    if t_bytes >= ops_time_s:
        return t_bytes * 1e3, "bytes"
    return ops_time_s * 1e3, "operations"


# ---------------------------------------------------------------------------
# Phase 1: card and toolchain
# ---------------------------------------------------------------------------


def phase_toolchain(torch):
    from repro_torch.kernels import _build

    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("float32 matmul precision: allow_tf32 = False (cuda.matmul and cudnn)")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc in parallel: {_build.build_seconds})")
    for stem, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------


def phase_kernels(torch, device, timer) -> list[dict]:
    from repro_torch.core import bitplane
    from repro_torch.core.kvcache import FusedBitPlaneCacheFormat
    from repro_torch.kernels import bsdp_gemm, bsdp_kernel, dequant_gemv, plane_attn

    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, generator=gen,
                             device=device)

    # qwen3-1.7b FFN: w_in [K=2048 → N=12288], w_out [K=6144 → N=2048]
    for layer, n, k in (("w_in", 12288, 2048), ("w_out", 2048, 6144)):
        kw = k // 32
        w = words(n, 4, kw)
        for name, mod, fn, plain, ms_ in (
            ("bsdp_gemv", bsdp_kernel, bsdp_kernel.bsdp_matmul,
             bsdp_kernel.bsdp_matmul_plain, (1,)),
            ("bsdp_gemm_fused", bsdp_gemm, bsdp_gemm.bsdp_gemm_fused,
             bsdp_gemm.bsdp_gemm_fused_plain, (4, 256)),
        ):
            for m in ms_:
                x = words(m, 4, kw)
                got = fn(x, w)
                want = plain(x, w)
                torch.cuda.synchronize()
                err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
                check(err == 0, f"{name} {layer} M={m}: not bit-exact (max err {err})")
                nbytes = (m + n) * 4 * kw * 4 + m * n * 4
                # the int4 dot product's multiply-adds at the int8 tensor rate
                b_ms, b_by = bound(nbytes, 2 * m * n * k / INT8_OPS_PER_S)
                rows.append(dict(
                    name=name, shape=f"{layer} M={m} N={n} K={k}", route="cuda",
                    source=f"src/repro_torch/csrc/{mod.KERNEL.source}",
                    replaces=mod.KERNEL.replaces, max_abs_err=float(err),
                    ms=timer.ms(lambda: fn(x, w)), plain_ms=timer.ms(lambda: plain(x, w)),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # attention projections (w8a16): K = 2048 → N = 2048 (wq, wo) / 1024 (wk, wv)
    for n in (2048, 1024):
        k = 2048
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen, device=device)
        ws = torch.rand((1, n), generator=gen, device=device) * 0.02 + 1e-3
        w_deq = w.to(torch.float32) * ws  # the yardstick's pre-dequantized weight
        for m in (1, 4, 256):
            x = torch.randn((m, k), generator=gen, device=device)
            got = dequant_gemv.dequant_matmul(x, w, ws)
            want = dequant_gemv.dequant_matmul_plain(x, w, ws)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            check(err <= DEQUANT_RTOL * scale,
                  f"dequant_matmul M={m} N={n}: err {err} > {DEQUANT_RTOL} * {scale}")
            b_ms, b_by = bound(m * k * 4 + k * n + n * 4 + m * n * 4,
                               2 * m * n * k / F32_OPS_PER_S)
            rows.append(dict(
                name="dequant_matmul", shape=f"M={m} N={n} K={k}", route="cuda",
                source=f"src/repro_torch/csrc/{dequant_gemv.KERNEL.source}",
                replaces=dequant_gemv.KERNEL.replaces, max_abs_err=err,
                ms=timer.ms(lambda: dequant_gemv.dequant_matmul(x, w, ws)),
                plain_ms=timer.ms(lambda: dequant_gemv.dequant_matmul_plain(x, w, ws)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=timer.ms(lambda: torch.matmul(x, w_deq))))

    # decode attention on the bit-plane cache: B=4 slots × Hkv=8 → R=32, G=2,
    # L=512, F=128 (Fw=4).  Slot 0 idle (every position masked), slot 1 a
    # wrapped ring (positions 100..611), slot 2 part-filled, slot 3 full.
    b, h, g, l, feat = 4, 8, 2, 512, 128
    fw = feat // 32
    kp, vp = words(b, l, h, 4, fw), words(b, l, h, 4, fw)
    ks = torch.rand((b, l, h), generator=gen, device=device) * 0.5 + 0.01
    vs = torch.rand((b, l, h), generator=gen, device=device) * 0.5 + 0.01
    pos_ids = torch.full((b, l), -1, dtype=torch.int64, device=device)
    ring = torch.arange(100, 612, device=device)
    pos_ids[1, ring % l] = ring
    pos_ids[2, :300] = torch.arange(300, device=device)
    pos_ids[3] = torch.arange(l, device=device)
    cur = torch.tensor([0, 611, 299, 511], device=device)
    valid = (pos_ids >= 0) & (pos_ids <= cur[:, None])
    bias = torch.where(valid, 0.0, -1e30).to(torch.float32)
    bias = bias[:, None, None, :].expand(b, h, g, l).contiguous()
    q = torch.randn((b, h, g, feat), generator=gen, device=device)
    q_planes, q_scale = FusedBitPlaneCacheFormat._query_planes(q)
    args = (q_planes, q_scale, kp, ks, vp, vs, bias)
    sm = 1.0 / math.sqrt(feat)
    got = plane_attn.plane_decode_attention(*args, sm_scale=sm)
    want = plane_attn.plane_decode_attention_plain(*args, sm_scale=sm)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "plane_decode_attention: non-finite output")
    check(torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL),
          f"plane_decode_attention: max err {(got - want).abs().max().item()}")
    # the idle slot's rows get uniform weights: the mean of v_scale · v_int4
    vals = bitplane.decode(vp[0].permute(1, 0, 2, 3)).to(torch.float32)  # [H, L, F]
    idle = (vals * vs[0].T[:, :, None]).mean(dim=1)  # [H, F]
    check(torch.allclose(got[0], idle[:, None, :].expand_as(got[0]), rtol=ATTN_TOL,
                         atol=ATTN_TOL),
          "plane_decode_attention: a fully masked row is not uniform")
    r = b * h
    nbytes = (q_planes.numel() * 4 + q_scale.numel() * 4 + 2 * (kp.numel() * 4 + ks.numel() * 4)
              + bias.numel() * 4 + r * g * feat * 4)
    ops_s = 2 * r * g * l * feat / INT8_OPS_PER_S + 2 * r * g * l * feat / F32_OPS_PER_S
    b_ms, b_by = bound(nbytes, ops_s)
    rows.append(dict(
        name="plane_decode_attention", shape=f"R={r} G={g} L={l} Fw={fw}", route="cuda",
        source=f"src/repro_torch/csrc/{plane_attn.KERNEL.source}",
        replaces=plane_attn.KERNEL.replaces,
        max_abs_err=(got - want).abs().max().item(),
        ms=timer.ms(lambda: plane_attn.plane_decode_attention(*args, sm_scale=sm)),
        plain_ms=timer.ms(lambda: plane_attn.plane_decode_attention_plain(*args, sm_scale=sm)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    print("library_ms of dequant_matmul: torch.matmul against a weight dequantized "
          "ahead of time — a yardstick only; the port never calls it")
    for row in rows:
        print("kernel " + json.dumps(row))
    return rows


# ---------------------------------------------------------------------------
# Phase 3: serve full qwen3-1.7b through the kernels
# ---------------------------------------------------------------------------


def _serve(engine_mod, params, cfg, slots, n_requests, rng, device):
    eng = engine_mod.ServeEngine(params, cfg, mode=MODE, cache_format=CACHE,
                                 scheduler="fcfs", slots=slots, max_len=512,
                                 trace_logits=True, device=device)
    for n in rng.integers(16, 129, size=n_requests):
        eng.submit(rng.integers(0, cfg.vocab_size, size=(int(n),)).astype("int32"), 32)
    eng.run()
    return eng


def phase_serve(torch, device, card) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    from repro_torch.serve import engine

    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    params = model_lib.materialize(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    print(f"materialize qwen3-1.7b ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    qparams = engine.convert_params(params, cfg, MODE)
    torch.cuda.synchronize()
    del params
    print(f"residency convert ({MODE}): {time.perf_counter() - t0:.2f} s, "
          f"{engine.resident_bytes(qparams) / 1e9:.3f} GB resident")
    rng = np.random.default_rng(SEED)
    counts = {}
    for slots, n_requests in ((4, 8), (1, 2)):
        ops.reset_counts()
        eng = _serve(engine, qparams, cfg, slots, n_requests, rng, device)
        launches, plain = ops.launch_counts(), ops.plain_cuda_counts()
        print(f"serve slots={slots}: launches {launches} plain-on-cuda {plain}")
        check(all(v == 0 for v in plain.values()),
              f"slots={slots}: a plain version ran on a CUDA tensor: {plain}")
        for name, v in launches.items():
            counts[name] = counts.get(name, 0) + v
        for req in eng.requests:
            check(req.state == "done" and len(req.out) == 32, f"request {req.uid} unfinished")
            check(all(0 <= t < cfg.vocab_size for t in req.out), "token out of vocab")
        for kind, _, logits in eng.logit_trace:
            check(bool(np.isfinite(logits).all()) and logits.shape[-1] == cfg.vocab_size,
                  f"{kind} logits not finite / wrong width")
        st = eng.stats()
        print(f"serve slots={slots} on {card}: {st.total_tokens} tokens, "
              f"{st.tok_per_s:.2f} tok/s, TTFT p50 {st.percentile('ttft_s', 50) * 1e3:.2f} ms, "
              f"TPOT p50 {st.percentile('tpot_s', 50) * 1e3:.2f} ms, steps {st.steps}, "
              f"peak mem {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if slots == 4:
            check(launches["bsdp_gemm_fused"] > 0 and launches["dequant_matmul"] > 0
                  and launches["plane_decode_attention"] > 0,
                  f"slots=4 path missed a kernel: {launches}")
        else:
            check(launches["bsdp_gemv"] > 0, f"slots=1 path never ran the GEMV: {launches}")
    check(all(v > 0 for v in counts.values()), f"a kernel never launched: {counts}")
    phase_profile(torch, device, engine, qparams, cfg, card)
    return counts


def phase_profile(torch, device, engine, qparams, cfg, card, steps: int = 3) -> None:
    """Where a decode step's time goes: ``torch.profiler`` over a few steady
    decode steps at slots=4 — wall time, device-busy time (the sum of the
    device-side kernel and copy durations), idle share, device operations
    per step and the kernels taking most device time."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = engine.ServeEngine(qparams, cfg, mode=MODE, cache_format=CACHE, slots=4,
                             max_len=512, device=device)
    rng = np.random.default_rng(SEED + 1)
    for _ in range(4):
        eng.submit(rng.integers(0, cfg.vocab_size, size=64).astype(np.int32), 2 + 2 * steps)
    eng.step()  # prefill (+ first decode)
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 / steps
    by_name: dict = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile decode step (slots=4, {cfg.n_layers} layers, {card}, under the "
          f"profiler): wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, device ops {len(dev_events) / steps:.0f}/step")
    for name, ms in top:
        print(f"  {ms:8.3f} ms/step  {name[:90]}")


# ---------------------------------------------------------------------------
# Phase 4: kernel path against the plain path (2 layers, full width)
# ---------------------------------------------------------------------------


def phase_paths(torch, device) -> None:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serve import engine

    for dtype_name, (max_rel, min_cos) in PATH_LIMITS.items():
        cfg = get_config("qwen3-1.7b").scaled(n_layers=2, dtype=getattr(torch, dtype_name))
        params = engine.convert_params(
            model_lib.materialize(cfg, seed=SEED, device=device), cfg, MODE)
        traces, outs = [], []
        for impl in (None, "plain"):
            rng = np.random.default_rng(0)
            eng = engine.ServeEngine(params, cfg, slots=2, max_len=32, mode=MODE,
                                     cache_format=CACHE, trace_logits=True, impl=impl,
                                     device=device)
            for n, mn in zip((5, 3, 7), (6, 2, 4)):
                eng.submit(rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32), mn,
                           force=rng.integers(0, cfg.vocab_size, size=(mn,)).astype(np.int32))
            eng.run()
            traces.append(eng.logit_trace)
            outs.append([r.out for r in eng.requests])
        kinds = [[(k, s) for k, s, _ in t] for t in traces]
        check(kinds[0] == kinds[1], "kernel and plain paths scheduled differently")
        check(outs[0] == outs[1], "kernel and plain paths emitted different tokens")
        worst_rel, worst_cos, agree = 0.0, 1.0, 0
        for (_, _, a), (_, _, p) in zip(*traces):
            a, p = np.asarray(a, np.float64), np.asarray(p, np.float64)
            worst_rel = max(worst_rel, float(np.abs(a - p).max() / np.abs(p).max()))
            worst_cos = min(worst_cos, float((a.ravel() @ p.ravel())
                                             / (np.linalg.norm(a) * np.linalg.norm(p))))
            agree += int(np.array_equal(a.reshape(-1, a.shape[-1]).argmax(-1),
                                        p.reshape(-1, p.shape[-1]).argmax(-1)))
        print(f"kernel vs plain path (2 layers, {dtype_name}): {len(traces[0])} logit "
              f"vectors, max rel err {worst_rel:.3e} (limit {max_rel}), min cosine "
              f"{worst_cos:.6f} (limit {min_cos}), argmax agree {agree}/{len(traces[0])}")
        check(worst_rel <= max_rel and worst_cos >= min_cos,
              f"kernel path logits drift from the plain path ({dtype_name})")
        del params, eng
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_line()
    phase_toolchain(torch)
    timer = Timer(torch, device)
    rows = phase_kernels(torch, device, timer)
    del timer
    torch.cuda.empty_cache()
    counts = phase_serve(torch, device, card)
    torch.cuda.empty_cache()
    phase_paths(torch, device)

    # one entry per kernel, at its most frequent serving shape (decode)
    pick = {"bsdp_gemv": "w_in M=1", "bsdp_gemm_fused": "w_in M=4",
            "dequant_matmul": "M=4 N=2048", "plane_decode_attention": "R=32"}
    kernels = []
    for name, prefix in pick.items():
        row = next(r for r in rows if r["name"] == name and r["shape"].startswith(prefix))
        err = max(r["max_abs_err"] for r in rows if r["name"] == name)
        kernels.append({k: row[k] for k in ("name", "route", "source", "replaces")}
                       | {"launches": counts[name], "max_abs_err": err}
                       | {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "shape")})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
