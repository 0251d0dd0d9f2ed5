#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Builds the hand-written kernels from ``src/repro_torch/csrc`` and holds each
one against its plain PyTorch version at the shapes its path gives it (phase
2), timing each call twice: single calls (``Timer``) and the same calls
enqueued ahead of the device (``queued_ms``, no host time in the window).
Then it prints, per path, the sum over one decode step's launches of each
kernel's time above its bound.  Then it serves full-width, full-depth
qwen3-1.7b (random weights from a seed) through ``ServeEngine`` and
``fcfs`` on three paths (phase 3):

  A  ``ffn=bsdp_fused,mixer=w8a16`` with the ``int4_bp_fused`` cache
  B  ``w8a8`` with the config's ``bf16`` cache (the reference launcher's default)
  C  ``ffn=bsdp,mixer=w4a8`` with the ``int4_bp`` cache

and two more at the same width and depth:

  E  path A's weights and cache with chunked prefill: one 448-token prompt
     and seven short ones, under ``fcfs``, ``token_budget:budget=32`` and
     ``token_budget:budget=256`` (the long prompt's later chunks run plane
     attention at G = 64, and at G = 384 for its 192-token second chunk
     under budget 256; phase 2 holds the kernel at G = 64, 384 and 512)
  F  ``w8a8`` with the ``int8`` cache under ``sjf``

then the two further dense configs at their full published width, depth
cut to 8 layers (below), each on path A's and path B's stack (the same
request mix, ``fcfs``):

  G  starcoder2-3b (LayerNorm, GELU, 2 KV heads, untied head) on path A's stack
  H  starcoder2-3b on path B's stack (``matmul_int8`` on the head too)
  I  qwen1.5-32b (q/k/v biases, untied head) on path A's stack
  J  qwen1.5-32b on path B's stack

and the MLA and MoE configs, also at full published width and 8 layers, on
the same two stacks:

  K  minicpm3-4b (MLA with a low-rank q) on path A's stack
  L  minicpm3-4b on path B's stack
  M  deepseek-v2-lite-16b (MLA, 64 routed experts top 6 + 2 shared, layer 0
     dense) on path A's stack: the experts through one grouped launch of
     ``bsdp_gemm_fused`` (``bsdp_gemv`` at slots=1) per projection
  N  deepseek-v2-lite-16b on path B's stack: the experts through one
     grouped ``matmul_int8`` per projection

and the sliding-window MoE and Mamba configs, at full published width and
depth, on the same two stacks:

  O  mixtral-8x7b (32 layers, 8 experts top 2, window 4096, untied head) on
     path A's stack: the experts through one grouped ``bsdp_gemm_fused``
     per projection at E = 8, K 4096 / N 28672
  P  mixtral-8x7b on path B's stack: grouped ``matmul_int8``, the head too
  Q  falcon-mamba-7b (64 Mamba-1 layers, d_inner 8192, no attention, tied
     head) on path A's stack: ``dequant_matmul`` on in_proj, x_proj (N =
     288) and out_proj
  R  falcon-mamba-7b on path B's stack: ``matmul_int8`` on the same

and one windowed serve:

  S  mixtral-8x7b at full width, depth cut to 2 layers, path A's stack,
     slots=4, max_len 4352 (a 4096-position ring): one 4,160-token prompt
     and three of 64 tokens, 64 new tokens each, under ``fcfs`` and
     ``token_budget:budget=256``; each row's ring must hold exactly its last
     <= 4096 positions and plane attention run at L = 4096; then, in
     float32 under both schedulers, the kernel path against the plain
     path: the all-exact stack at a zero difference, ``w8a16`` with the
     fused int4 cache within ``PATH_LIMITS``; under ``fcfs`` path A's
     stack printed (``S_MODES`` says why), and both of its paths' distances
     from a reference serve whose ``w8a16`` products are taken in float64
     (``_reference_distances``: whether a kernel is at fault)

and the cross-attention configs at full published width and depth, on
the same two stacks, through ``model.prefill`` and ``model.decode_step``
(neither engine serves a context), every cross gate set to ``CROSS_GATE``
after the draw (llama-vision's initialises to 0, which would close its
cross branch):

  T  llama-3.2-vision-11b (40 layers, cross-attention in place of
     self-attention at layers i % 5 == 3, over [4, 1601, 4096] patch
     embeddings) on path A's stack
  U  llama-3.2-vision-11b on path B's stack (the head too)
  V  seamless-m4t-medium (12 non-causal encoder layers over [4, 1536,
     1024] frames, 12 decoder layers each self- then cross-attending,
     LayerNorm, GELU, d_head 64, vocab 256206) on path A's stack: plane
     attention at Fw = 2, G = 1; the ``layers.i.cross`` leaves match
     neither of the stack's patterns and stay bf16
  W  seamless-m4t-medium on path B's stack (``matmul_int8`` at the head's
     unaligned N = 256206)

MLA reads its latent cache through the cache format's plain plane math, so
K and M launch no plane attention; Q and R have no attention at all.
Phase 2 holds each grouped launch against its plain version at
deepseek's and mixtral's expert shapes, ``dequant_matmul`` and
``matmul_int8`` at falcon-mamba's projections (N = 288 included), and the
kernels at T-W's shapes: the decode projections and heads, plane attention
at d_head 64, the cross K/V prefill (M = 4 x 1601) and the encoder's FFN
input (M = 4 x 1536).  Weights
of G-W are drawn and converted leaf by leaf (``engine.materialize_converted``):
qwen1.5-32b's, whole in bf16, would not fit one card beside their
converted form.  The script then drives the ops-level
entry points ``ops.dim_matmul`` and ``ops.matmul_int8_raw`` (path D).  Each
path runs with the launch counts set to 0 just before it and read just
after, and fails unless its kernels launched (exactly, a decode step), no
plain version ran on the card and its resident bytes match the analytic
count.  Phase 4 compares the kernel path with the plain path on a 2-layer
cut for each weight format, the ``int8`` cache, a chunked serve and each
further config on its two stacks (with the share of MoE routing choices
that agree; O-R's configs too, B's stack held to a zero difference),
qwen1.5-32b with path A's int4 steps taken out one at a time (the
all-exact stacks held to a zero difference), and one period of
llama-vision (its cross layer 3) and a 2 + 2-layer seamless on both stacks
(B's at a zero difference), gates open; there, in float32, a value the two
paths round to different int4 codes at a boundary (within ``FLIP_TOL`` of
a step) is forced to the plain path's code, as MoE routes are forced, and
a code that differs farther fails.  Any failure is a nonzero exit.  It
needs a CUDA device and the repository's ``src``; without either it fails
before printing a result.

Every serving path runs at full width, and at full depth but for cuts
made to keep the run well inside the 1200 s it may take: paths G-N serve
their configs at 8 layers (``CONFIG_DEPTH``; at full depth, PR 18-19,
they took ~380 s of a 1,063 s run with O-S), and S serves mixtral-8x7b at
2 of its 32 layers (its 4,160-token prefill and its plain-path
comparisons at full depth would take many minutes).  A cut layer
launches what a full-depth layer does, at the same shapes.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit; the one before that a JSON object with every
kernel's launches, error against its plain version and times.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
#: serving paths: name → (weight residency, decode cache, kernels that must
#: launch at slots=4 and at slots=1, launches per decode step at slots=4 on
#: 28 layers)
PATHS = {
    "A": ("ffn=bsdp_fused,mixer=w8a16", "int4_bp_fused",
          {4: ("bsdp_gemm_fused", "dequant_matmul", "plane_decode_attention"),
           1: ("bsdp_gemv", "bsdp_gemm_fused", "dequant_matmul", "plane_decode_attention")},
          {"bsdp_gemm_fused": 56, "dequant_matmul": 112, "plane_decode_attention": 28}),
    "B": ("w8a8", "bf16", {4: ("matmul_int8",), 1: ("matmul_int8",)}, {"matmul_int8": 168}),
    "C": ("ffn=bsdp,mixer=w4a8", "int4_bp",
          {4: ("bsdp_gemm", "matmul_int4_packed"),
           1: ("bsdp_gemv", "bsdp_gemm", "matmul_int4_packed")},
          {"bsdp_gemm": 56, "matmul_int4_packed": 112}),
}
#: the further dense configs, each at full width, depth cut by CONFIG_DEPTH,
#: on path A's and path B's stack: path → (arch, the stack's path, launches
#: per decode step at slots=4 on 8 layers: on A's stack 2 BSDP GEMMs, 4
#: W8A16 projections and one plane attention a layer, the head left in bf16;
#: on B's 6 W8A8 projections a layer and the head)
CONFIG_PATHS = {
    "G": ("starcoder2-3b", "A",
          {"bsdp_gemm_fused": 16, "dequant_matmul": 32, "plane_decode_attention": 8}),
    "H": ("starcoder2-3b", "B", {"matmul_int8": 49}),
    "I": ("qwen1.5-32b", "A",
          {"bsdp_gemm_fused": 16, "dequant_matmul": 32, "plane_decode_attention": 8}),
    "J": ("qwen1.5-32b", "B", {"matmul_int8": 49}),
}
#: the MLA and MoE configs at full width, depth cut by CONFIG_DEPTH: path →
#: (arch, the stack's path, kernels that must launch by slots, launches per
#: decode step at slots=4 on CONFIG_DEPTH's 8 layers).  On A's stack: minicpm3-4b's 4 W8A16 projections a layer
#: (w_dq, w_uq, w_dkv, wo; w_uk and w_uv are dequantized for the absorbed
#: decode, not launched) and 2 BSDP GEMMs; deepseek-v2-lite-16b's 3 (wq,
#: w_dkv, wo), layer 0's 2 BSDP GEMMs and each MoE layer's 4 (the routed
#: experts' w_in and w_out one grouped launch each, the shared expert's
#: two); the head left in bf16.  On B's stack the same projections and the
#: head through ``matmul_int8``.
MLA_PATHS = {
    "K": ("minicpm3-4b", "A",
          {4: ("bsdp_gemm_fused", "dequant_matmul"),
           1: ("bsdp_gemv", "bsdp_gemm_fused", "dequant_matmul")},
          {"dequant_matmul": 32, "bsdp_gemm_fused": 16}),
    "L": ("minicpm3-4b", "B", {4: ("matmul_int8",), 1: ("matmul_int8",)},
          {"matmul_int8": 49}),
    "M": ("deepseek-v2-lite-16b", "A",
          {4: ("bsdp_gemm_fused", "dequant_matmul"),
           1: ("bsdp_gemv", "bsdp_gemm_fused", "dequant_matmul")},
          {"bsdp_gemm_fused": 30, "dequant_matmul": 24}),
    "N": ("deepseek-v2-lite-16b", "B", {4: ("matmul_int8",), 1: ("matmul_int8",)},
          {"matmul_int8": 55}),
}
#: paths G-N serve their configs at 8 layers (deepseek-v2-lite-16b's dense
#: layer 0 and 7 MoE layers), so that the run with paths O-S stays well
#: inside its time limit: at full depth (PR 18-19) G-N took ~380 s of a
#: 1,063 s run.  A layer's shapes, and so each kernel launch, are those of
#: the full depth; O-R serve their configs whole.
CONFIG_DEPTH = {arch: 8 for arch in ("starcoder2-3b", "qwen1.5-32b", "minicpm3-4b",
                                     "deepseek-v2-lite-16b")}


def config_for(arch: str):
    """The config a serving path of G-R serves: the registry's, cut to
    :data:`CONFIG_DEPTH` where it names the arch."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg.scaled(n_layers=CONFIG_DEPTH[arch]) if arch in CONFIG_DEPTH else cfg


#: the sliding-window MoE and Mamba configs at full width and depth: path →
#: (arch, the stack's path, kernels that must launch by slots, launches per
#: decode step at slots=4).  On A's stack: mixtral-8x7b's 4 W8A16 attention
#: projections, 2 grouped BSDP GEMMs (w_in, w_out over 8 experts) and one
#: plane attention a layer, the head left in bf16; falcon-mamba-7b's 3
#: W8A16 projections a layer (in_proj, x_proj, out_proj; its head tied).
#: On B's stack the same projections through ``matmul_int8``, mixtral's
#: head too.
WINDOW_SSM_PATHS = {
    "O": ("mixtral-8x7b", "A",
          {4: ("bsdp_gemm_fused", "dequant_matmul", "plane_decode_attention"),
           1: ("bsdp_gemv", "bsdp_gemm_fused", "dequant_matmul", "plane_decode_attention")},
          {"dequant_matmul": 128, "bsdp_gemm_fused": 64, "plane_decode_attention": 32}),
    "P": ("mixtral-8x7b", "B", {4: ("matmul_int8",), 1: ("matmul_int8",)},
          {"matmul_int8": 193}),
    "Q": ("falcon-mamba-7b", "A", {4: ("dequant_matmul",), 1: ("dequant_matmul",)},
          {"dequant_matmul": 192}),
    "R": ("falcon-mamba-7b", "B", {4: ("matmul_int8",), 1: ("matmul_int8",)},
          {"matmul_int8": 192}),
}
#: paths G-R draw and convert leaf by leaf (``engine.materialize_converted``),
#: and the peak allocation may exceed the resident bytes by two float32
#: copies of the largest layer projection (a leaf's draw and its cast to
#: the model's dtype alive together) and this much for the column blocks'
#: temporaries.  The untied head's larger draw comes second, when only the
#: embedding is resident.
STREAM_SLACK_BYTES = 256 << 20
#: the cross-attention configs at full width and depth: path → (arch, the
#: stack's path, kernels that must launch by slots, launches per decode step
#: at slots=4).  Neither engine serves a context, so these paths drive
#: ``model.prefill`` and ``model.decode_step`` directly.  A decode step
#: reads each cross layer's context K/V from its cache, so a cross branch
#: launches its wq and wo alone.  On A's stack: llama-3.2-vision-11b's 32
#: self-attention layers 4 W8A16 projections and one plane attention each,
#: its 8 cross layers (``layers.i.mixer``, which the pattern ``mixer``
#: matches) 2 W8A16 projections each, every layer's FFN 2 BSDP GEMMs;
#: seamless-m4t-medium's 12 decoder layers 4 W8A16 self-attention
#: projections, 2 BSDP GEMMs and one plane attention each, while their
#: ``layers.i.cross`` leaves match neither pattern and stay bf16, launching
#: nothing.  On B's stack every projection through ``matmul_int8``, the
#: untied head too.
CROSS_PATHS = {
    "T": ("llama-3.2-vision-11b", "A",
          {4: ("bsdp_gemm_fused", "dequant_matmul", "plane_decode_attention"),
           1: ("bsdp_gemv", "bsdp_gemm_fused", "dequant_matmul", "plane_decode_attention")},
          {"dequant_matmul": 144, "bsdp_gemm_fused": 80, "plane_decode_attention": 32}),
    "U": ("llama-3.2-vision-11b", "B", {4: ("matmul_int8",), 1: ("matmul_int8",)},
          {"matmul_int8": 225}),
    "V": ("seamless-m4t-medium", "A",
          {4: ("bsdp_gemm_fused", "dequant_matmul", "plane_decode_attention"),
           1: ("bsdp_gemv", "bsdp_gemm_fused", "dequant_matmul", "plane_decode_attention")},
          {"dequant_matmul": 48, "bsdp_gemm_fused": 24, "plane_decode_attention": 12}),
    "W": ("seamless-m4t-medium", "B", {4: ("matmul_int8",), 1: ("matmul_int8",)},
          {"matmul_int8": 97}),
}
#: every cross layer's tanh gate is set to this after the draw: llama-vision's
#: gate initialises to 0, which would close its cross branch (it would add
#: exactly nothing, so no check could see it broken)
CROSS_GATE = 0.5


def path_spec(path: str) -> tuple:
    """(weights, cache, kernels that must launch by slots, launches a decode
    step at slots=4) of any serving path."""
    if path in PATHS:
        return PATHS[path]
    if path in MLA_PATHS or path in WINDOW_SSM_PATHS or path in CROSS_PATHS:
        _, stack, must, per_step = (MLA_PATHS.get(path) or WINDOW_SSM_PATHS.get(path)
                                    or CROSS_PATHS[path])
        return (*PATHS[stack][:2], must, per_step)
    _, stack, per_step = CONFIG_PATHS[path]
    mode, cache, must, _ = PATHS[stack]
    return mode, cache, must, per_step


#: phase 4's (weights, cache, scheduler): the three paths, the
#: popcount-at-every-batch bit-plane format, the int8 cache (path F) and
#: chunked prefill on path A (path E)
PATH_MODES = [(mode, cache, "fcfs") for mode, cache, _, _ in PATHS.values()] + [
    ("w4a4_bsdp", "int4_bp_fused", "fcfs"), ("w8a8", "int8", "fcfs"),
    (PATHS["A"][0], PATHS["A"][1], "token_budget:budget=4")]
RESIDENT_RTOL = 0.005  # resident bytes against the analytic count
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
#: phase 4's further cuts of qwen1.5-32b, each taking one of path A's int4
#: steps out of its stack, to tell which one moves the kernel path off the
#: plain path: (weights, cache, scheduler) → whether the two paths must
#: agree to the bit.  With w8a8 attention and the bf16 cache every kernel
#: the serve launches is bit-exact (BSDP, W8A8), so any difference there is
#: a kernel fault; with w8a16 attention (float32 sums in another order) the
#: int4 FFN re-quantizes the difference; with a w8a16 FFN only the int4
#: cache does.
DRIFT_MODES = {
    ("ffn=bsdp_fused,mixer=w8a8", "bf16", "fcfs"): True,
    ("ffn=bsdp_fused,mixer=w8a16", "bf16", "fcfs"): False,
    ("w8a16", "int4_bp_fused", "fcfs"): False,
}


#: phase 4's further cut of deepseek-v2-lite-16b: path A's FFN (the grouped
#: BSDP experts) with W8A8 attention and the bf16 cache, every kernel it
#: launches exact, so the two paths must agree to the bit, every expert
#: choice included, in bf16 too
MOE_EXACT_MODE = ("ffn=bsdp_fused,mixer=w8a8", "bf16", "fcfs")


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


#: device clocks the queue is held for while a queued timing is enqueued
#: (about 25 ms on an H100, many times the host's enqueue of 25 calls)
QUEUE_HOLD_CYCLES = 50_000_000


def queued_ms(timer: Timer, fn, reps: int = 25) -> float | None:
    """``timer.ms`` with the host out of the timed windows: the device is held
    by a sleep kernel while every (flush, start, call, end) is enqueued, so
    each window holds the call's device time alone.  None if the sleep ended
    before the host had enqueued every call."""
    torch = timer.torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    held = torch.cuda.Event()
    torch.cuda._sleep(QUEUE_HOLD_CYCLES)
    held.record()
    for start, end in events:
        timer.flush.zero_()
        start.record()
        fn()
        end.record()
    ahead = not held.query()
    torch.cuda.synchronize()
    if not ahead:
        return None
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
        spilled = 0
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")
            spilled += sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        print(f"ptxas {stem}: {log.count('entry function')} kernel instances, "
              f"{spilled} spill bytes in all")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version at its path's shapes
# ---------------------------------------------------------------------------

#: qwen3-1.7b projections: name → (K, N).  wo has wq's (K, N) and wv has
#: wk's, so the wq and wk rows stand for them.
PROJ = {"wq": (2048, 2048), "wk": (2048, 1024), "w_in": (2048, 12288),
        "w_out": (6144, 2048)}
#: each path's kernel launches in one decode step at slots=4 on 28 layers, by
#: the phase-2 row of the same shape: (kernel, row shape, launches per step)
STEP_ROWS = {
    "A": [("bsdp_gemm_fused", "w_in M=4 N=12288 K=2048", 28),
          ("bsdp_gemm_fused", "w_out M=4 N=2048 K=6144", 28),
          ("dequant_matmul", "M=4 N=2048 K=2048 x=bf16", 56),  # wq, wo
          ("dequant_matmul", "M=4 N=1024 K=2048 x=bf16", 56),  # wk, wv
          ("plane_decode_attention", "R=32 G=2 L=512 Fw=4", 28)],
    "B": [("matmul_int8", "wq M=4 N=2048 K=2048", 56),  # wq, wo
          ("matmul_int8", "wk M=4 N=1024 K=2048", 56),  # wk, wv
          ("matmul_int8", "w_in M=4 N=12288 K=2048", 28),
          ("matmul_int8", "w_out M=4 N=2048 K=6144", 28)],
    "C": [("bsdp_gemm", "w_in M=4 N=12288 K=2048", 28),
          ("bsdp_gemm", "w_out M=4 N=2048 K=6144", 28),
          ("matmul_int4_packed", "wq M=4 N=2048 K=2048", 56),  # wq, wo
          ("matmul_int4_packed", "wk M=4 N=1024 K=2048", 56)],  # wk, wv
}
#: the same at slots=1 for ``bsdp_gemv``, the bit-plane formats' M == 1 route
#: (w_in and w_out once a layer): exact per decode step, checked in phase 3
STEP_ROWS_1 = {
    path: [("bsdp_gemv", "w_in M=1 N=12288 K=2048", 28),
           ("bsdp_gemv", "w_out M=1 N=2048 K=6144", 28)]
    for path in ("A", "C")
}


def _row(rows, name, kernel, shape, err, timer, call, plain_ms, bound_ms_by, library_ms,
         library_note=None):
    """One kernel row: ``call`` timed by ``timer`` (ms) and by
    :func:`queued_ms` (the device time alone)."""
    b_ms, b_by = bound_ms_by
    rows.append(dict(
        name=name, shape=shape, route="cuda", source=f"src/repro_torch/csrc/{kernel.source}",
        replaces=kernel.replaces, max_abs_err=float(err), ms=timer.ms(call),
        queued_ms=queued_ms(timer, call), plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms, library_note=library_note))


def _int_err(got, want) -> int:
    return (got.long() - want.long()).abs().max().item()


def int_mm_min_m(torch, device) -> int:
    """The smallest M at which ``torch._int_mm`` runs on this card (it has
    refused M <= 16 on CUDA); yardsticks at smaller M are padded to it."""
    b = torch.zeros((32, 32), dtype=torch.int8, device=device)
    try:
        torch._int_mm(torch.zeros((1, 32), dtype=torch.int8, device=device), b)
    except RuntimeError:
        return 32
    return 1


def _int_mm(torch, x_i8, w_i8, min_m):
    """``torch._int_mm`` on the same int8 operands — a yardstick the port
    never calls — with rows padded up to ``min_m`` and columns up to a
    multiple of 8 (it refuses others); returns (fn, note), fn giving the
    ``[M, N]`` result."""
    m, n = x_i8.shape[0], w_i8.shape[1]
    notes = []
    if m < min_m:
        xp = torch.zeros((min_m, x_i8.shape[1]), dtype=torch.int8, device=x_i8.device)
        xp[:m] = x_i8
        x_i8 = xp
        notes.append(f"M padded from {m} to {min_m} (it refuses M <= 16)")
    if n % 8:
        w_i8 = torch.nn.functional.pad(w_i8, (0, -n % 8))
        notes.append(f"N padded from {n} to {w_i8.shape[1]} (it takes multiples of 8)")
    if not notes:
        return (lambda: torch._int_mm(x_i8, w_i8)), None
    return ((lambda: torch._int_mm(x_i8, w_i8)[:m, :n]),
            "torch._int_mm at " + ", ".join(notes))


def phase_kernels(torch, device, timer) -> list[dict]:
    gen = torch.Generator(device=device).manual_seed(SEED)
    min_m = int_mm_min_m(torch, device)
    print(f"torch._int_mm runs from M = {min_m} on this card")
    rows: list[dict] = []
    _rows_bsdp(torch, device, gen, timer, rows, min_m)
    _rows_int8(torch, device, gen, timer, rows, min_m)
    _rows_int4(torch, device, gen, timer, rows, min_m)
    _rows_dim(torch, device, gen, timer, rows)
    _rows_dequant(torch, device, gen, timer, rows)
    _rows_attention(torch, device, gen, timer, rows)
    _rows_configs(torch, device, gen, timer, rows, min_m)
    _rows_grouped(torch, device, gen, timer, rows)
    _rows_window_ssm(torch, device, gen, timer, rows, min_m)
    _rows_cross(torch, device, gen, timer, rows, min_m)
    dequant_accuracy(torch, device, gen)
    for row in rows:
        print("kernel " + json.dumps(row))
    one = torch.zeros(1, device=device)
    print(f"launch floor: {timer.ms(lambda: one.zero_()):.5f} ms (median of a one-element "
          f"zero_() under the same timer, {card_line()})")
    step_gaps(rows)
    return rows


def step_gaps(rows) -> None:
    """Per path, the sum over one decode step's launches of (ms − bound ms),
    each launch at its own projection's measured row: the order in which
    the kernels lose the most device time to their bounds.  Once with the
    ``Timer``'s ms and once with the queued ms; at slots=4 for every kernel
    of the path, at slots=1 for ``bsdp_gemv``."""
    lines = [(path, 4, entries) for path, entries in STEP_ROWS.items()]
    lines += [(path, 1, entries) for path, entries in STEP_ROWS_1.items()]
    lines += [(path, 4, config_step_rows(path)) for path in CONFIG_PATHS]
    lines += [(path, 1, config_step_rows(path, 1))
              for path, (_, stack, _) in CONFIG_PATHS.items() if stack == "A"]
    lines += [(path, 4, window_ssm_step_rows(path)) for path in WINDOW_SSM_PATHS]
    lines += [("O", 1, window_ssm_step_rows("O", 1))]
    lines += [(path, slots, cross_step_rows(path, slots)) for path in CROSS_PATHS
              for slots in ((4, 1) if CROSS_PATHS[path][1] == "A" else (4,))]
    for path, slots, entries in lines:
        per_step = {}
        for name, _, n in entries:
            per_step[name] = per_step.get(name, 0) + n
        if slots == 4:
            check(per_step == path_spec(path)[3],
                  f"the step rows of path {path} != the path's launches per step")
        arch = (CONFIG_PATHS.get(path) or WINDOW_SSM_PATHS.get(path) or CROSS_PATHS.get(path)
                or ("qwen3-1.7b",))[0]
        n_layers = config_for(arch).n_layers
        for key in ("ms", "queued_ms"):
            gaps: dict = {}
            for name, shape, n in entries:
                row = next(r for r in rows if r["name"] == name and r["shape"] == shape)
                if row[key] is None:  # the host fell behind the queue: no reading
                    gaps[name] = float("nan")
                else:
                    gaps[name] = gaps.get(name, 0.0) + n * (row[key] - row["bound_ms"])
            ranked = ", ".join(f"{k} {v:.3f} ms"
                               for k, v in sorted(gaps.items(), key=lambda kv: -kv[1]))
            print(f"path {path} decode step (slots={slots}, {n_layers} layers): launches x ({key} - "
                  f"bound ms) summed {sum(gaps.values()):.3f} ms: {ranked}")


def _words(torch, gen, device, *shape):
    return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, generator=gen,
                         device=device)


def _int8(torch, gen, device, *shape, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, dtype=torch.int8, generator=gen, device=device)


def _scales(torch, gen, device, *shape):
    return torch.rand(shape, generator=gen, device=device) * 0.05 + 1e-3


def _rows_bsdp(torch, device, gen, timer, rows, min_m):
    """The three BSDP kernels at the FFN's shapes: ``bsdp_gemv`` at M = 1
    (the slots=1 decode of A and C) and at M = 4 and 256 (``w4a4_bsdp``'s
    decode and prefill), the GEMMs at M = 4 and 256 and ``bsdp_gemm_fused``
    also at M = 1 (the yardstick a GEMV route has to beat)."""
    for layer in ("w_in", "w_out"):
        _bsdp_rows_at(torch, device, gen, timer, rows, min_m, layer, *PROJ[layer],
                      {"bsdp_gemv": (1, 4, 256), "bsdp_gemm_fused": (1, 4, 256),
                       "bsdp_gemm": (4, 256)})


def _bsdp_rows_at(torch, device, gen, timer, rows, min_m, label, k, n, ms_by_kernel):
    """BSDP kernel rows at one weight ``[K, N]``, each kernel at its Ms.  The
    library yardstick is ``torch._int_mm`` on the int4 values decoded to
    int8 ahead of time."""
    from repro_torch.core import bitplane
    from repro_torch.kernels import bsdp_gemm, bsdp_kernel

    kw = k // 32
    w = _words(torch, gen, device, n, 4, kw)
    w_dec = bitplane.decode(w).T.contiguous()  # [K, N] int8
    for name, kernel, fn, plain in (
        ("bsdp_gemv", bsdp_kernel.KERNEL, bsdp_kernel.bsdp_matmul,
         bsdp_kernel.bsdp_matmul_plain),
        ("bsdp_gemm_fused", bsdp_gemm.KERNEL, bsdp_gemm.bsdp_gemm_fused,
         bsdp_gemm.bsdp_gemm_fused_plain),
        ("bsdp_gemm", bsdp_gemm.KERNEL_UNROLLED, bsdp_gemm.bsdp_gemm,
         bsdp_gemm.bsdp_gemm_plain),
    ):
        for m in ms_by_kernel.get(name, ()):
            x = _words(torch, gen, device, m, 4, kw)
            got = fn(x, w)
            err = _int_err(got, plain(x, w))
            check(err == 0, f"{name} {label} M={m}: not bit-exact (max err {err})")
            check(torch.equal(got, fn(x, w)), f"{name} {label} M={m}: two calls differ")
            if name == "bsdp_gemm":
                check(torch.equal(got, bsdp_gemm.bsdp_gemm_fused(x, w)),
                      f"bsdp_gemm {label} M={m}: differs from bsdp_gemm_fused")
            lib, note = _int_mm(torch, bitplane.decode(x), w_dec, min_m)
            nbytes = (m + n) * 4 * kw * 4 + m * n * 4
            # the int4 dot product's multiply-adds at the int8 tensor rate
            _row(rows, name, kernel, f"{label} M={m} N={n} K={k}", err,
                 timer, lambda: fn(x, w), timer.ms(lambda: plain(x, w)),
                 bound(nbytes, 2 * m * n * k / INT8_OPS_PER_S), timer.ms(lib),
                 note or "torch._int_mm on the int4 values decoded to int8 ahead of time")


def _rows_int8(torch, device, gen, timer, rows, min_m):
    """W8A8 at the projections of path B; scaled output bit-exact (the same
    integer sums, the same float32 multiplies in the same order)."""
    for layer in ("wq", "wk", "w_in", "w_out"):
        _int8_rows_at(torch, device, gen, timer, rows, min_m, layer, *PROJ[layer], (1, 4, 256))


def _int8_rows_at(torch, device, gen, timer, rows, min_m, label, k, n, ms):
    """``matmul_int8`` rows at one weight ``[K, N]``, and the raw int32
    variant once (wq at M = 4)."""
    from repro_torch.kernels import gemv_int8

    w = _int8(torch, gen, device, k, n)
    ws = _scales(torch, gen, device, 1, n)
    for m in ms:
        x = _int8(torch, gen, device, m, k)
        xs = _scales(torch, gen, device, m, 1)
        err = (gemv_int8.matmul_int8(x, w, xs, ws)
               - gemv_int8.matmul_int8_plain(x, w, xs, ws)).abs().max().item()
        check(err == 0, f"matmul_int8 {label} M={m}: not bit-exact (max err {err})")
        lib, note = _int_mm(torch, x, w, min_m)
        acc = gemv_int8.matmul_int8(x, w, xs, ws, out_int32=True)
        check(torch.equal(acc, lib()[:m]), f"matmul_int8 {label} M={m}: != torch._int_mm")
        nbytes = m * k + k * n + 4 * (m + n) + 4 * m * n
        _row(rows, "matmul_int8", gemv_int8.KERNEL, f"{label} M={m} N={n} K={k}", err,
             timer, lambda: gemv_int8.matmul_int8(x, w, xs, ws),
             timer.ms(lambda: gemv_int8.matmul_int8_plain(x, w, xs, ws)),
             bound(nbytes, 2 * m * n * k / INT8_OPS_PER_S), timer.ms(lib),
             note or "torch._int_mm (int32 out, no scales)")
        if label == "wq" and m == 4:  # the raw int32 variant, once
            err = _int_err(acc, gemv_int8.matmul_int8_plain(x, w, xs, ws, out_int32=True))
            check(err == 0, f"matmul_int8 out_int32: not bit-exact (max err {err})")
            _row(rows, "matmul_int8", gemv_int8.KERNEL, f"{label} M={m} N={n} K={k} "
                 "out_int32", err,
                 timer, lambda: gemv_int8.matmul_int8(x, w, xs, ws, out_int32=True),
                 timer.ms(lambda: gemv_int8.matmul_int8_plain(x, w, xs, ws,
                                                              out_int32=True)),
                 bound(m * k + k * n + 4 * m * n, 2 * m * n * k / INT8_OPS_PER_S),
                 timer.ms(lib), note or "torch._int_mm")


def _rows_int4(torch, device, gen, timer, rows, min_m):
    """W4A8 at path C's attention projections; both nibble extremes planted."""
    from repro_torch.core import quant
    from repro_torch.kernels import gemv_int4

    for layer in ("wq", "wk"):
        k, n = PROJ[layer]
        w4 = _int8(torch, gen, device, k, n, lo=-8, hi=8)
        w4[:4, 0] = torch.tensor([-8, 7, 7, -8], dtype=torch.int8, device=device)
        wp = quant.pack_int4(w4, axis=0)
        ws = _scales(torch, gen, device, 1, n)
        for m in (1, 4, 256):
            x = _int8(torch, gen, device, m, k)
            xs = _scales(torch, gen, device, m, 1)
            got = gemv_int4.matmul_int4_packed(x, wp, xs, ws)
            err = (got - gemv_int4.matmul_int4_packed_plain(x, wp, xs, ws)).abs().max().item()
            check(err == 0, f"matmul_int4_packed {layer} M={m}: not bit-exact (max err {err})")
            check(torch.equal(got, gemv_int4.matmul_int4_packed(x, wp, xs, ws)),
                  f"matmul_int4_packed {layer} M={m}: two calls differ")
            lib, note = _int_mm(torch, x, w4, min_m)
            nbytes = m * k + k * n // 2 + 4 * (m + n) + 4 * m * n
            _row(rows, "matmul_int4_packed", gemv_int4.KERNEL, f"{layer} M={m} N={n} K={k}",
                 err, timer, lambda: gemv_int4.matmul_int4_packed(x, wp, xs, ws),
                 timer.ms(lambda: gemv_int4.matmul_int4_packed_plain(x, wp, xs, ws)),
                 bound(nbytes, 2 * m * n * k / INT8_OPS_PER_S), timer.ms(lib),
                 note or "torch._int_mm against the weight unpacked ahead of time")


def _rows_dim(torch, device, gen, timer, rows):
    """DIM at K = 2048: full-range int16 with the edge values planted,
    bit-exact against its plain version and the plain wide matmul."""
    from repro_torch.kernels import dim_kernel, ref

    k = 2048
    for n in (2048, 12288):
        w = torch.randint(-32768, 32768, (k, n), dtype=torch.int16, generator=gen,
                          device=device)
        w[0, 0], w[1, 1], w[2, 0] = -32768, 32767, -1
        for m in (1, 4, 256):
            x = _int8(torch, gen, device, m, k)
            got = dim_kernel.matmul_w16a8(x, w)
            err = max(_int_err(got, dim_kernel.matmul_w16a8_plain(x, w)),
                      _int_err(got, ref.dim_w16a8_ref(x, w)))
            check(err == 0, f"matmul_w16a8 M={m} N={n}: not bit-exact (max err {err})")
            nbytes = m * k + 2 * k * n + 4 * m * n
            _row(rows, "matmul_w16a8", dim_kernel.KERNEL, f"M={m} N={n} K={k}", err,
                 timer, lambda: dim_kernel.matmul_w16a8(x, w),
                 timer.ms(lambda: dim_kernel.matmul_w16a8_plain(x, w)),
                 bound(nbytes, 4 * m * n * k / INT8_OPS_PER_S), None,
                 "null: no PyTorch call computes int8 x int16 -> int32 exactly on CUDA")


def _rows_dequant(torch, device, gen, timer, rows):
    """W8A16 at path A's attention projections: K = 2048 → N = 2048 (wq, wo)
    / 1024 (wk, wv), with float32 activations and with the model's bf16
    ones (widened inside the kernel)."""
    for n in (2048, 1024):
        _dequant_rows_at(torch, device, gen, timer, rows, "", 2048, n,
                         (torch.float32, torch.bfloat16), (1, 4, 256))


def _dequant_rows_at(torch, device, gen, timer, rows, prefix, k, n, dtypes, ms):
    """``dequant_matmul`` rows at one weight ``[K, N]``.  Two calls must be
    bitwise equal."""
    from repro_torch.kernels import dequant_gemv

    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen, device=device)
    ws = torch.rand((1, n), generator=gen, device=device) * 0.02 + 1e-3
    w_deq = w.to(torch.float32) * ws  # the yardstick's pre-dequantized weight
    for dtype in dtypes:
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=device).to(dtype)
            xf = x.to(torch.float32)  # the yardstick's activations, widened ahead of time
            got = dequant_gemv.dequant_matmul(x, w, ws)
            want = dequant_gemv.dequant_matmul_plain(x, w, ws)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            tag = f"{prefix}M={m} N={n} K={k}" + ("" if dtype == torch.float32 else " x=bf16")
            check(err <= DEQUANT_RTOL * scale,
                  f"dequant_matmul {tag}: err {err} > {DEQUANT_RTOL} * {scale}")
            check(torch.equal(got, dequant_gemv.dequant_matmul(x, w, ws)),
                  f"dequant_matmul {tag}: two calls differ")
            nbytes = m * k * x.element_size() + k * n + n * 4 + m * n * 4
            _row(rows, "dequant_matmul", dequant_gemv.KERNEL, tag,
                 err, timer, lambda: dequant_gemv.dequant_matmul(x, w, ws),
                 timer.ms(lambda: dequant_gemv.dequant_matmul_plain(x, w, ws)),
                 bound(nbytes, 2 * m * n * k / F32_OPS_PER_S),
                 timer.ms(lambda: torch.matmul(xf, w_deq)),
                 "torch.matmul against a weight dequantized (and bf16 activations "
                 "widened) ahead of time")


def _rows_attention(torch, device, gen, timer, rows):
    """Decode attention on the bit-plane cache at path A's two decode shapes:
    slots=4 × Hkv=8 → R=32 and slots=1 → R=8, G=2, L=512, F=128 (Fw=4),
    then the chunk rows."""
    for b in (4, 1):
        _attention_decode_row(torch, device, gen, timer, rows, b, 8, 2)
    for s_len in CHUNK_ROWS:
        _row_attention_chunk(torch, device, gen, timer, rows, s_len)


def _attention_decode_row(torch, device, gen, timer, rows, b, h, g, l=512, window=None,
                          feat=128):
    """Plane attention at a decode shape: ``b`` slots × ``h`` kv heads → R
    rows of G query heads, L (512, or 4096: mixtral-8x7b's window-long
    ring), F=128 (Fw=4; seamless-m4t-medium's 64: Fw=2).  At b = 4: slot 0
    idle (every position masked), slot 1 a wrapped ring (positions
    100..99+L), slot 2 part-filled, slot 3 full, and the bias materialised,
    with the window term where the config has one.  At b = 1 the one slot
    is part-filled (300 positions: the last L splits wholly masked in a
    live row) and the bias is the engine's expanded view (stride 0 over
    heads and queries).  Two calls must be
    bitwise equal."""
    import torch.nn.functional as F

    from repro_torch.core import bitplane
    from repro_torch.core.kvcache import FusedBitPlaneCacheFormat
    from repro_torch.kernels import plane_attn

    fw = feat // 32
    kp, vp = (_words(torch, gen, device, b, l, h, 4, fw),
              _words(torch, gen, device, b, l, h, 4, fw))
    ks = torch.rand((b, l, h), generator=gen, device=device) * 0.5 + 0.01
    vs = torch.rand((b, l, h), generator=gen, device=device) * 0.5 + 0.01
    pos_ids = torch.full((b, l), -1, dtype=torch.int64, device=device)
    if b == 4:
        ring = torch.arange(100, 100 + l, device=device)
        pos_ids[1, ring % l] = ring
        pos_ids[2, :300] = torch.arange(300, device=device)
        pos_ids[3] = torch.arange(l, device=device)
        cur = torch.tensor([0, 99 + l, 299, l - 1], device=device)
    else:
        pos_ids[0, :300] = torch.arange(300, device=device)
        cur = torch.tensor([299], device=device)
    valid = (pos_ids >= 0) & (pos_ids <= cur[:, None])
    if window is not None:
        valid &= pos_ids > cur[:, None] - window
    bias = torch.where(valid, 0.0, -1e30).to(torch.float32)[:, None, None, :]
    bias = bias.expand(b, h, g, l)
    if b == 4:
        bias = bias.contiguous()
    q = torch.randn((b, h, g, feat), generator=gen, device=device)
    q_planes, q_scale = FusedBitPlaneCacheFormat._query_planes(q)
    args = (q_planes, q_scale, kp, ks, vp, vs, bias)
    sm = 1.0 / math.sqrt(feat)
    r = b * h
    tag = f"R={r} G={g} L={l} Fw={fw}"
    got = plane_attn.plane_decode_attention(*args, sm_scale=sm)
    want = plane_attn.plane_decode_attention_plain(*args, sm_scale=sm)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"plane_decode_attention {tag}: non-finite output")
    check(torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL),
          f"plane_decode_attention {tag}: max err {(got - want).abs().max().item()}")
    check(torch.equal(got, plane_attn.plane_decode_attention(*args, sm_scale=sm)),
          f"plane_decode_attention {tag}: two calls differ")
    if b == 4:  # the idle slot's rows get uniform weights: the mean of v_scale · v_int4
        vals = bitplane.decode(vp[0].permute(1, 0, 2, 3)).to(torch.float32)  # [H, L, F]
        idle = (vals * vs[0].T[:, :, None]).mean(dim=1)  # [H, F]
        check(torch.allclose(got[0], idle[:, None, :].expand_as(got[0]), rtol=ATTN_TOL,
                             atol=ATTN_TOL),
              "plane_decode_attention: a fully masked row is not uniform")

    # yardstick: scaled_dot_product_attention over K/V dequantized ahead of
    # time (rows r = (b, h): q [R, 1, G, F], K/V [R, 1, L, F], mask [R, 1, G, L])
    def dequant(planes, scale):
        v = bitplane.decode(planes).to(torch.float32)[..., :feat] * scale[..., None]
        return v.permute(0, 2, 1, 3).reshape(r, 1, l, feat).contiguous()

    kd, vd = dequant(kp, ks), dequant(vp, vs)
    qd = q.reshape(r, 1, g, feat)
    mask = bias.reshape(r, 1, g, l)
    # each input read once: the bias counts at its stored size
    nbytes = (q_planes.numel() * 4 + q_scale.numel() * 4
              + 2 * (kp.numel() * 4 + ks.numel() * 4)
              + bias.untyped_storage().nbytes() + r * g * feat * 4)
    ops_s = 2 * r * g * l * feat / INT8_OPS_PER_S + 2 * r * g * l * feat / F32_OPS_PER_S
    _row(rows, "plane_decode_attention", plane_attn.KERNEL,
         tag + ("" if b == 4 else " bias expanded"),
         (got - want).abs().max().item(),
         timer, lambda: plane_attn.plane_decode_attention(*args, sm_scale=sm),
         timer.ms(lambda: plane_attn.plane_decode_attention_plain(*args, sm_scale=sm)),
         bound(nbytes, ops_s),
         timer.ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                         scale=sm)),
         "F.scaled_dot_product_attention over K/V dequantized ahead of time")


#: chunk lengths of the chunked-prefill attention rows (G = 2 · S): budget
#: 32's chunks, the 192-token second chunk path E runs under budget 256, and
#: a whole chunk of budget 256
CHUNK_ROWS = (32, 192, 256)


def _row_attention_chunk(torch, device, gen, timer, rows, s_len):
    """Plane attention at a chunk step of path A's cache (R = 32, L = 512,
    Fw = 4): S tokens a slot, G = 2·S query rows, the bias built as the
    engine builds it (per-token causal masks, materialised [B, Hkv, G, L]).
    Slot 0 a chunk at positions 64..63+S over a part-filled ring, slot 1 a
    decode row (one live token, S - 1 pads: uniform rows), slot 2 idle, slot
    3 a chunk ending a wrapped ring (positions 100..611).  Held against the
    plain version, bitwise repeatable, and each (row, query) bit-identical to
    a G = 2 launch of its first two query rows alone (one tile)."""
    import torch.nn.functional as F

    from repro_torch.core import bitplane
    from repro_torch.core.kvcache import FusedBitPlaneCacheFormat
    from repro_torch.kernels import plane_attn

    b, h, grp, l, feat = 4, 8, 2, 512, 128
    fw, g, r = feat // 32, 2 * s_len, 4 * 8
    kp, vp = (_words(torch, gen, device, b, l, h, 4, fw),
              _words(torch, gen, device, b, l, h, 4, fw))
    ks = torch.rand((b, l, h), generator=gen, device=device) * 0.5 + 0.01
    vs = torch.rand((b, l, h), generator=gen, device=device) * 0.5 + 0.01
    pos_ids = torch.full((b, l), -1, dtype=torch.int64, device=device)
    cur = torch.full((b, s_len), -1, dtype=torch.int64, device=device)
    pos_ids[0, :64 + s_len] = torch.arange(64 + s_len, device=device)
    cur[0] = torch.arange(64, 64 + s_len, device=device)
    pos_ids[1, :300] = torch.arange(300, device=device)
    cur[1, -1] = 299
    ring = torch.arange(100, 612, device=device)
    pos_ids[3, ring % l] = ring
    cur[3] = torch.arange(612 - s_len, 612, device=device)
    valid = (pos_ids[:, None, :] >= 0) & (pos_ids[:, None, :] <= cur[..., None])
    bias = torch.where(valid, 0.0, -1e30).to(torch.float32)  # [B, S, L]
    bias = bias[:, None, :, None, :].expand(b, h, s_len, grp, l).reshape(b, h, g, l)
    q = torch.randn((b, h, g, feat), generator=gen, device=device)
    q_planes, q_scale = FusedBitPlaneCacheFormat._query_planes(q)
    args = (q_planes, q_scale, kp, ks, vp, vs, bias)
    sm = 1.0 / math.sqrt(feat)
    tag = f"R={r} G={g} L={l} Fw={fw}"
    got = plane_attn.plane_decode_attention(*args, sm_scale=sm)
    want = plane_attn.plane_decode_attention_plain(*args, sm_scale=sm)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"plane_decode_attention {tag}: non-finite output")
    check(torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL),
          f"plane_decode_attention {tag}: max err {(got - want).abs().max().item()}")
    check(torch.equal(got, plane_attn.plane_decode_attention(*args, sm_scale=sm)),
          f"plane_decode_attention {tag}: two calls differ")
    for g0 in (0, g - 2):  # the first and the last tile's query rows, launched alone
        part = plane_attn.plane_decode_attention(
            q_planes[:, :, g0:g0 + 2], q_scale[:, :, g0:g0 + 2], kp, ks, vp, vs,
            bias[:, :, g0:g0 + 2], sm_scale=sm)
        check(torch.equal(got[:, :, g0:g0 + 2], part),
              f"plane_decode_attention {tag}: query rows {g0}.. differ from a G=2 launch")

    def dequant(planes, scale):
        v = bitplane.decode(planes).to(torch.float32)[..., :feat] * scale[..., None]
        return v.permute(0, 2, 1, 3).reshape(r, 1, l, feat).contiguous()

    kd, vd = dequant(kp, ks), dequant(vp, vs)
    qd, mask = q.reshape(r, 1, g, feat), bias.reshape(r, 1, g, l)
    nbytes = (q_planes.numel() * 4 + q_scale.numel() * 4 + 2 * (kp.numel() * 4 + ks.numel() * 4)
              + bias.untyped_storage().nbytes() + r * g * feat * 4)
    ops_s = 2 * r * g * l * feat / INT8_OPS_PER_S + 2 * r * g * l * feat / F32_OPS_PER_S
    _row(rows, "plane_decode_attention", plane_attn.KERNEL, tag + f" chunk S={s_len}",
         (got - want).abs().max().item(),
         timer, lambda: plane_attn.plane_decode_attention(*args, sm_scale=sm),
         timer.ms(lambda: plane_attn.plane_decode_attention_plain(*args, sm_scale=sm)),
         bound(nbytes, ops_s),
         timer.ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask, scale=sm)),
         "F.scaled_dot_product_attention over K/V dequantized ahead of time")


def config_projections(cfg) -> dict:
    """name → (K, N) of a layer's projections, and of the untied head."""
    d, dh = cfg.d_model, cfg.d_head
    d_in = cfg.d_ff if cfg.act == "gelu" else 2 * cfg.d_ff  # SwiGLU: fused [gate; up]
    proj = {"wq": (d, cfg.n_heads * dh), "wk": (d, cfg.n_kv_heads * dh),
            "wv": (d, cfg.n_kv_heads * dh), "wo": (cfg.n_heads * dh, d),
            "w_in": (d, d_in), "w_out": (cfg.d_ff, d)}
    if not cfg.tie_embeddings:
        proj["head"] = (d, cfg.vocab_size)
    return proj


def config_row(cfg, name: str, m: int) -> str:
    """The phase-2 row of projection ``name`` of ``cfg`` at M = m, named
    after the first projection of its shape (wq stands for wo, wk for wv)."""
    proj = config_projections(cfg)
    k, n = proj[name]
    first = next(p for p, shape in proj.items() if shape == (k, n))
    return f"{cfg.name} {first} M={m} N={n} K={k}"


def config_step_rows(path: str, slots: int = 4) -> list:
    """STEP_ROWS for a path of :data:`CONFIG_PATHS`: (kernel, row, launches a
    decode step) at slots=4, or ``bsdp_gemv``'s at slots=1 (A's stack)."""
    arch, stack, _ = CONFIG_PATHS[path]
    cfg = config_for(arch)
    layers = cfg.n_layers
    if slots == 1:
        return [("bsdp_gemv", config_row(cfg, name, 1), layers) for name in ("w_in", "w_out")]
    if stack == "B":
        return [("matmul_int8", config_row(cfg, name, 4), 1 if name == "head" else layers)
                for name in config_projections(cfg)]
    return ([("bsdp_gemm_fused", config_row(cfg, name, 4), layers) for name in ("w_in", "w_out")]
            + [("dequant_matmul", config_row(cfg, name, 4) + " x=bf16", layers)
               for name in ("wq", "wk", "wv", "wo")]
            + [("plane_decode_attention",
                f"R={4 * cfg.n_kv_heads} G={cfg.n_heads // cfg.n_kv_heads} L=512 Fw=4",
                layers)])


#: the prefill rows of paths G-J: the phase-3 mix prefills prompts of 16-128
#: tokens, left-padded over up to 4 slots, so the projections see M = B · S
#: of 17 to 512 rows through the kernels' tile routes (M > 16)
PREFILL_M = 256


def _rows_configs(torch, device, gen, timer, rows, min_m):
    """The kernels of paths G-J at the shapes the two further configs give
    them: ``bsdp_gemv`` (M = 1) and ``bsdp_gemm_fused`` (M = 1, 4 and
    :data:`PREFILL_M`) at each FFN projection (K = 27392 is 107 binary
    256-wide K steps, an odd count), ``dequant_matmul`` (M = 1, 4 and
    PREFILL_M, bf16 x) at each attention shape, ``matmul_int8`` at every
    projection (M = 1, 4 and PREFILL_M) and the head (M = 1 and 4, the
    rows a step's last tokens give it; 778.6 M int8 weights at
    qwen1.5-32b's), and plane attention at G = 12 over R = 8 (starcoder2-3b)
    and G = 1 over R = 160 (qwen1.5-32b)."""
    from repro_torch.configs import get_config

    ms = (1, 4, PREFILL_M)
    for arch in dict.fromkeys(arch for arch, _, _ in CONFIG_PATHS.values()):
        cfg = get_config(arch)
        proj = config_projections(cfg)
        shapes = {}  # each distinct (K, N) once, under its first projection
        for name, shape in proj.items():
            shapes.setdefault(shape, name)
        for shape, name in shapes.items():
            label = f"{arch} {name}"
            if name in ("w_in", "w_out"):
                _bsdp_rows_at(torch, device, gen, timer, rows, min_m, label, *shape,
                              {"bsdp_gemv": (1,), "bsdp_gemm_fused": ms})
            elif name != "head":
                _dequant_rows_at(torch, device, gen, timer, rows, label + " ", *shape,
                                 (torch.bfloat16,), ms)
            _int8_rows_at(torch, device, gen, timer, rows, min_m, label, *shape,
                          ms[:2] if name == "head" else ms)
        _attention_decode_row(torch, device, gen, timer, rows, 4, cfg.n_kv_heads,
                              cfg.n_heads // cfg.n_kv_heads)
        torch.cuda.empty_cache()


#: deepseek-v2-lite-16b's routed experts (paths M and N): how many, and the
#: (K, N) of their w_in (SwiGLU's fused gate and up) and w_out
EXPERTS = 64
EXPERT_PROJ = {"w_in": (2048, 2816), "w_out": (1408, 2048)}
#: the rows an expert takes in one grouped launch, by kernel: a decode step
#: at slots=1 and 4 (capacity 1 a row), and a prefill of 4 rows of 128
#: tokens (capacity int(128 · 6 · 1.25 / 64 + 0.999) = 15 a row, M = 60)
GROUPED_M = {"bsdp_gemv": (1,), "bsdp_gemm_fused": (4, 60), "bsdp_gemm": (4, 60),
             "matmul_int8": (1, 4, 60)}


#: mixtral-8x7b's experts (paths O, P and S): how many, the (K, N) of w_in
#: and w_out, and the rows an expert takes: a decode step at slots=1 and 4
#: (capacity 1 a row), and the prefill of one 128-token prompt (capacity
#: int(128 · 2 · 1.25 / 8 + 0.999) = 40)
MIXTRAL_EXPERTS = 8
MIXTRAL_EXPERT_PROJ = {"w_in": (4096, 28672), "w_out": (14336, 4096)}
MIXTRAL_GROUPED_M = {"bsdp_gemv": (1,), "bsdp_gemm_fused": (4, 40), "matmul_int8": (1, 4, 40)}


def _rows_grouped(torch, device, gen, timer, rows, e=EXPERTS, proj=EXPERT_PROJ,
                  grouped_m=GROUPED_M, prefix="", plain_reps=25):
    """The grouped launches at an expert shape (deepseek-v2-lite-16b's by
    default, E = 64; mixtral-8x7b's with ``prefix``): each bit-exact against
    its plain version (the 2-D plain version once an expert, timed over
    ``plain_reps`` calls) and repeatable, timed against ``singles_ms``, the
    same kernel launched once an expert (E launches), and against one
    ``torch.bmm`` in bf16 on operands dequantized ahead of time."""
    from repro_torch.core import bitplane
    from repro_torch.kernels import bsdp_gemm, bsdp_kernel, gemv_int8

    bmm_note = "torch.bmm in bf16 on operands dequantized ahead of time"
    for label, (k, n) in proj.items():
        label = prefix + label
        kw = k // 32
        w = _words(torch, gen, device, e, n, 4, kw)
        w_bf = bitplane.decode(w).transpose(1, 2).to(torch.bfloat16)  # [E, K, N]
        for name, kernel, grouped, single, plain in (
            ("bsdp_gemv", bsdp_kernel.KERNEL, bsdp_kernel.bsdp_matmul_grouped,
             bsdp_kernel.bsdp_matmul, bsdp_kernel.bsdp_matmul_grouped_plain),
            ("bsdp_gemm_fused", bsdp_gemm.KERNEL, bsdp_gemm.bsdp_gemm_fused_grouped,
             bsdp_gemm.bsdp_gemm_fused, bsdp_gemm.bsdp_gemm_fused_grouped_plain),
            ("bsdp_gemm", bsdp_gemm.KERNEL_UNROLLED, bsdp_gemm.bsdp_gemm_grouped,
             bsdp_gemm.bsdp_gemm, bsdp_gemm.bsdp_gemm_grouped_plain),
        ):
            for m in grouped_m.get(name, ()):
                x = _words(torch, gen, device, e, m, 4, kw)
                got = grouped(x, w)
                err = _int_err(got, plain(x, w))
                tag = f"grouped E={e} {label} M={m} N={n} K={k}"
                check(err == 0, f"{name} {tag}: not bit-exact (max err {err})")
                check(torch.equal(got, grouped(x, w)), f"{name} {tag}: two calls differ")
                x_bf = bitplane.decode(x).to(torch.bfloat16)
                nbytes = e * ((m + n) * 4 * kw * 4 + m * n * 4)
                _row(rows, name, kernel, tag, err, timer, lambda: grouped(x, w),
                     timer.ms(lambda: plain(x, w), reps=plain_reps),
                     bound(nbytes, 2 * e * m * n * k / INT8_OPS_PER_S),
                     timer.ms(lambda: torch.bmm(x_bf, w_bf)), bmm_note)
                rows[-1]["singles_ms"] = timer.ms(lambda: [single(x[i], w[i]) for i in range(e)])
        del w, w_bf
        w = _int8(torch, gen, device, e, k, n)
        ws = _scales(torch, gen, device, e, 1, n)
        w_deq = (w.to(torch.float32) * ws).to(torch.bfloat16)
        for m in grouped_m["matmul_int8"]:
            x = _int8(torch, gen, device, e, m, k)
            xs = _scales(torch, gen, device, e, m, 1)
            got = gemv_int8.matmul_int8_grouped(x, w, xs, ws)
            err = (got - gemv_int8.matmul_int8_grouped_plain(x, w, xs, ws)).abs().max().item()
            tag = f"grouped E={e} {label} M={m} N={n} K={k}"
            check(err == 0, f"matmul_int8 {tag}: not bit-exact (max err {err})")
            check(torch.equal(got, gemv_int8.matmul_int8_grouped(x, w, xs, ws)),
                  f"matmul_int8 {tag}: two calls differ")
            x_deq = (x.to(torch.float32) * xs).to(torch.bfloat16)
            nbytes = e * (m * k + k * n + 4 * (m + n) + 4 * m * n)
            _row(rows, "matmul_int8", gemv_int8.KERNEL, tag, err, timer,
                 lambda: gemv_int8.matmul_int8_grouped(x, w, xs, ws),
                 timer.ms(lambda: gemv_int8.matmul_int8_grouped_plain(x, w, xs, ws),
                          reps=plain_reps),
                 bound(nbytes, 2 * e * m * n * k / INT8_OPS_PER_S),
                 timer.ms(lambda: torch.bmm(x_deq, w_deq)), bmm_note)
            rows[-1]["singles_ms"] = timer.ms(
                lambda: [gemv_int8.matmul_int8(x[i], w[i], xs[i], ws[i]) for i in range(e)])
        del w, w_deq
        torch.cuda.empty_cache()


#: mixtral-8x7b's attention projections and untied head (paths O and P):
#: name → (K, N); wo has wq's shape and wv wk's
MIXTRAL_PROJ = {"wq": (4096, 4096), "wk": (4096, 1024), "head": (4096, 32000)}
#: falcon-mamba-7b's Mamba projections (paths Q and R): name → (K, N)
MAMBA_PROJ = {"in_proj": (4096, 16384), "x_proj": (8192, 288), "out_proj": (8192, 4096)}
#: falcon-mamba-7b's prefill rows: an SSM config refills one slot at a time,
#: and phase 3's prompts are at most 128 tokens long
MAMBA_PREFILL_M = 128


def _rows_window_ssm(torch, device, gen, timer, rows, min_m):
    """The kernels of paths O-S at their new shapes: plane attention at
    mixtral-8x7b's decode shape (R = 32, G = 4) over its window-long ring
    (L = 4096, the window term in the bias); ``dequant_matmul`` (bf16 x)
    and ``matmul_int8`` at its attention projections and ``matmul_int8`` at
    its head (M = 1, 4); the grouped launches at its experts (E = 8, the
    plain versions timed over 5 calls); and both kernels at falcon-mamba-7b's
    projections (M = 1, 4 and 128), x_proj's N = 288 a 32-column tail past
    the 64- and 128-wide tiles."""
    _attention_decode_row(torch, device, gen, timer, rows, 4, 8, 4, l=4096, window=4096)
    for name, (k, n) in MIXTRAL_PROJ.items():
        label = f"mixtral-8x7b {name}"
        if name != "head":
            _dequant_rows_at(torch, device, gen, timer, rows, label + " ", k, n,
                             (torch.bfloat16,), (1, 4))
        _int8_rows_at(torch, device, gen, timer, rows, min_m, label, k, n, (1, 4))
    _rows_grouped(torch, device, gen, timer, rows, MIXTRAL_EXPERTS, MIXTRAL_EXPERT_PROJ,
                  MIXTRAL_GROUPED_M, prefix="mixtral-8x7b ", plain_reps=5)
    for name, (k, n) in MAMBA_PROJ.items():
        label = f"falcon-mamba-7b {name}"
        _dequant_rows_at(torch, device, gen, timer, rows, label + " ", k, n,
                         (torch.bfloat16,), (1, 4, MAMBA_PREFILL_M))
        _int8_rows_at(torch, device, gen, timer, rows, min_m, label, k, n,
                      (1, 4, MAMBA_PREFILL_M))
    torch.cuda.empty_cache()


def window_ssm_step_rows(path: str, slots: int = 4) -> list:
    """STEP_ROWS for a path of :data:`WINDOW_SSM_PATHS`: (kernel, row,
    launches a decode step) at slots=4, or the grouped ``bsdp_gemv``'s at
    slots=1 (path O)."""
    from repro_torch.configs import get_config

    arch, stack, _, _ = WINDOW_SSM_PATHS[path]
    layers = get_config(arch).n_layers
    a_stack = stack == "A"
    kernel, suffix = ("dequant_matmul", " x=bf16") if a_stack else ("matmul_int8", "")
    if arch == "falcon-mamba-7b":
        return [(kernel, f"{arch} {name} M=4 N={n} K={k}{suffix}", layers)
                for name, (k, n) in MAMBA_PROJ.items()]
    experts = [(f"grouped E={MIXTRAL_EXPERTS} {arch} {name} M={{m}} N={n} K={k}", layers)
               for name, (k, n) in MIXTRAL_EXPERT_PROJ.items()]
    if slots == 1:
        return [("bsdp_gemv", row.format(m=1), n) for row, n in experts]
    rows = [(kernel, f"{arch} {name} M=4 N={n} K={k}{suffix}", 2 * layers)
            for name, (k, n) in MIXTRAL_PROJ.items() if name != "head"]
    rows += [("bsdp_gemm_fused" if a_stack else "matmul_int8", row.format(m=4), n)
             for row, n in experts]
    if a_stack:
        return rows + [("plane_decode_attention", "R=32 G=4 L=4096 Fw=4", layers)]
    k, n = MIXTRAL_PROJ["head"]
    return rows + [("matmul_int8", f"{arch} head M=4 N={n} K={k}", 1)]


def _rows_cross(torch, device, gen, timer, rows, min_m):
    """The kernels of paths T-W at their decode shapes: for each distinct
    projection shape of the two cross-attention configs ``bsdp_gemv`` (M =
    1) and ``bsdp_gemm_fused`` (M = 4) at the FFN's, ``dequant_matmul``
    (bf16 x, M = 4) at attention's, ``matmul_int8`` (M = 4) at every one,
    the untied heads included (seamless-m4t-medium's N = 256206 is no
    multiple of 16: the kernels' unaligned route); plane attention at each
    config's decode shape (llama-vision R = 32, G = 4, Fw = 4; seamless R =
    64, G = 1, Fw = 2); then the prefill rows at the context's M:
    ``dequant_matmul`` and ``matmul_int8`` at llama-vision's cross K/V
    projection (K 4096, N 1024, M = 4 x 1601) and ``bsdp_gemm_fused`` at
    seamless's encoder w_in (K 1024, N 4096, M = 4 x 1536)."""
    from repro_torch.configs import get_config

    for arch in dict.fromkeys(arch for arch, *_ in CROSS_PATHS.values()):
        cfg = get_config(arch)
        shapes = {}  # each distinct (K, N) once, under its first projection
        for name, shape in config_projections(cfg).items():
            shapes.setdefault(shape, name)
        for (k, n), name in shapes.items():
            label = f"{arch} {name}"
            if name in ("w_in", "w_out"):
                _bsdp_rows_at(torch, device, gen, timer, rows, min_m, label, k, n,
                              {"bsdp_gemv": (1,), "bsdp_gemm_fused": (4,)})
            elif name != "head":
                _dequant_rows_at(torch, device, gen, timer, rows, label + " ", k, n,
                                 (torch.bfloat16,), (4,))
            _int8_rows_at(torch, device, gen, timer, rows, min_m, label, k, n, (4,))
        _attention_decode_row(torch, device, gen, timer, rows, 4, cfg.n_kv_heads,
                              cfg.n_heads // cfg.n_kv_heads, feat=cfg.d_head)
        torch.cuda.empty_cache()
    vlm, enc_dec = (get_config(arch) for arch in dict.fromkeys(a for a, *_ in
                                                               CROSS_PATHS.values()))
    k, n = config_projections(vlm)["wk"]
    m = 4 * vlm.encoder_tokens
    _dequant_rows_at(torch, device, gen, timer, rows, f"{vlm.name} cross wk ", k, n,
                     (torch.bfloat16,), (m,))
    _int8_rows_at(torch, device, gen, timer, rows, min_m, f"{vlm.name} cross wk", k, n, (m,))
    k, n = config_projections(enc_dec)["w_in"]
    _bsdp_rows_at(torch, device, gen, timer, rows, min_m, f"{enc_dec.name} encoder w_in", k, n,
                  {"bsdp_gemm_fused": (4 * enc_dec.encoder_tokens,)})
    torch.cuda.empty_cache()


#: ``dequant_matmul``'s prefill shapes where path S's drift was weighed (M,
#: K, N, x dtype): S's attention projections over its 4,160-token prompt and
#: three of 64 (M = 16640; wq, and wk's N = 1024)
DEQUANT_ACCURACY_SHAPES = ((16640, 4096, 4096, "float32"), (16640, 4096, 1024, "float32"))


def dequant_accuracy(torch, device, gen) -> None:
    """How far ``dequant_matmul`` and its plain version (``torch.matmul``
    on the dequantized weight) each sit from the same product taken in
    float64 and rounded once, at :data:`DEQUANT_ACCURACY_SHAPES`: max and
    mean |Δ| over max |exact|.  Printed, not held: it says whether the
    kernel's float32 sums round further from the exact product than the
    plain path's."""
    from repro_torch.kernels import dequant_gemv

    for m, k, n, dtype in DEQUANT_ACCURACY_SHAPES:
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen, device=device)
        ws = torch.rand((1, n), generator=gen, device=device) * 0.02 + 1e-3
        x = torch.randn((m, k), generator=gen, device=device).to(getattr(torch, dtype))
        exact = (x.double() @ (w.double() * ws.double())).float().double()
        scale = exact.abs().max().item()
        errs = []
        for fn in (dequant_gemv.dequant_matmul, dequant_gemv.dequant_matmul_plain):
            got = fn(x, w, ws)
            d = (got.double() - exact).abs()
            errs.append((d.max().item() / scale, d.mean().item() / scale))
        del exact, x
        print(f"dequant_matmul accuracy M={m} N={n} K={k} x={dtype} against the float64 product: "
              f"kernel max {errs[0][0]:.3e} mean {errs[0][1]:.3e}, plain max {errs[1][0]:.3e} "
              f"mean {errs[1][1]:.3e} (of max |exact| {scale:.4g}; printed, not held)")
        torch.cuda.empty_cache()


def _cross_converted(cfg, mode: str, i: int) -> bool:
    """Whether the residency policy ``mode`` converts layer ``i``'s
    cross-attention projections: a ``cross`` layer's sit under
    ``layers.i.mixer``, an ``attn_cross`` layer's under ``layers.i.cross``."""
    from repro_torch.core.residency import ResidencySpec

    key = "mixer" if cfg.mixer_kind(i) == "cross" else "cross"
    return ResidencySpec.parse(mode).mode_for(f"layers.{i}.{key}.wq") != "bf16"


def cross_step_rows(path: str, slots: int = 4) -> list:
    """STEP_ROWS for a path of :data:`CROSS_PATHS`, counted from the
    config's layers: (kernel, row, launches a decode step) at slots=4, or
    ``bsdp_gemv``'s at slots=1 (A's stack).  A self-attention layer
    launches wq, wk, wv and wo, a converted cross branch wq and wo (its K/V
    come from the cache)."""
    from repro_torch.configs import get_config

    arch, stack, _, _ = CROSS_PATHS[path]
    cfg = get_config(arch)
    mode = PATHS[stack][0]
    n = cfg.n_layers
    if slots == 1:
        return [("bsdp_gemv", config_row(cfg, name, 1), n) for name in ("w_in", "w_out")]
    n_self = sum(cfg.mixer_kind(i) != "cross" for i in range(n))
    n_cross = sum(cfg.mixer_kind(i) != "attn" and _cross_converted(cfg, mode, i)
                  for i in range(n))
    attn = [("wq", 2 * n_self + 2 * n_cross), ("wk", 2 * n_self)]
    if stack == "B":
        return ([("matmul_int8", config_row(cfg, name, 4), k) for name, k in attn]
                + [("matmul_int8", config_row(cfg, name, 4), 1 if name == "head" else n)
                   for name in ("w_in", "w_out", "head")])
    return ([("dequant_matmul", config_row(cfg, name, 4) + " x=bf16", k) for name, k in attn]
            + [("bsdp_gemm_fused", config_row(cfg, name, 4), n) for name in ("w_in", "w_out")]
            + [("plane_decode_attention", f"R={4 * cfg.n_kv_heads} G="
                f"{cfg.n_heads // cfg.n_kv_heads} L=512 Fw={cfg.d_head // 32}", n_self)])


# ---------------------------------------------------------------------------
# Phase 3: serve full qwen3-1.7b through each path's kernels
# ---------------------------------------------------------------------------


def analytic_resident_bytes(cfg, mode: str, min_dim: int = 64) -> int:
    """Resident bytes of a converted model from its shapes alone: each
    weight of ``model.specs`` under a quantizable key whose last two axes
    are at least ``min_dim`` (the engine's conversion floor) and that the
    policy converts holds its payload plus a float32 per-channel scale, a
    stacked expert weight ``[E, K, N]`` E of them; every other leaf (the
    float32 embedding, norms, biases and router, the weights the policy
    keeps float) its own dtype's bytes."""
    from repro_torch.core.residency import ResidencySpec
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import QUANTIZABLE_KEYS

    spec = ResidencySpec.parse(mode)
    payload = {"w8a16": lambda k, n: k * n, "w8a8": lambda k, n: k * n,
               "w4a8": lambda k, n: -(-k // 2) * n,
               **{f: (lambda k, n: n * 4 * -(-k // 32) * 4)
                  for f in ("w4a4_bsdp", "bsdp", "bsdp_fused")}}

    def walk(tree, path):
        if isinstance(tree, dict):
            return sum(walk(v, path + (k,)) for k, v in tree.items())
        if isinstance(tree, list):
            return sum(walk(v, path + (str(i),)) for i, v in enumerate(tree))
        shape, fmt = tree.shape, spec.mode_for(".".join(path))
        if path[-1] in QUANTIZABLE_KEYS and fmt in payload and min(shape[-2:]) >= min_dim:
            k, n = shape[-2:]
            return math.prod(shape[:-2]) * (payload[fmt](k, n) + 4 * n)
        return math.prod(shape) * tree.dtype.itemsize

    return walk(model_lib.specs(cfg), ())


def _serve(engine_mod, params, cfg, mode, cache, slots, n_requests, rng, device):
    eng = engine_mod.ServeEngine(params, cfg, mode=mode, cache_format=cache,
                                 scheduler="fcfs", slots=slots, max_len=512,
                                 trace_logits=True, device=device)
    for n in rng.integers(16, 129, size=n_requests):
        eng.submit(rng.integers(0, cfg.vocab_size, size=(int(n),)).astype("int32"), 32)
    eng.run()
    return eng


def phase_serve(torch, device, card) -> dict[str, dict]:
    """Paths A, B and C at full width and depth; returns path → kernel →
    launches of that path's serving runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serve import engine

    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    params = model_lib.materialize(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    print(f"materialize qwen3-1.7b ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}): {time.perf_counter() - t0:.2f} s")
    qparams = {}
    for path, (mode, _, _, _) in PATHS.items():
        t0 = time.perf_counter()
        qparams[path] = engine.convert_params(params, cfg, mode)
        torch.cuda.synchronize()
        got, want = engine.resident_bytes(qparams[path]), analytic_resident_bytes(cfg, mode)
        print(f"path {path}: residency convert ({mode}): {time.perf_counter() - t0:.2f} s, "
              f"{got} B resident (analytic {want} B, {got / want - 1:+.2e})")
        check(abs(got - want) <= RESIDENT_RTOL * want,
              f"path {path}: resident bytes {got} vs analytic {want}")
    del params
    torch.cuda.empty_cache()
    counts = {}
    for path in PATHS:
        counts[path] = _serve_path(torch, device, card, engine, qparams[path], cfg, path)
        if path == "A":
            counts["E"] = phase_chunked(torch, device, card, engine, qparams[path], cfg)
        if path == "B":
            counts["F"] = phase_int8_cache(torch, device, card, engine, qparams[path], cfg)
        phase_profile(torch, device, engine, qparams.pop(path), cfg, card, path)
        torch.cuda.empty_cache()
    return counts


def draw_converted(torch, device, cfg, path, header, largest, what, prepare=None):
    """``path``'s weights for ``cfg``, drawn from ``SEED`` and converted leaf
    by leaf (``engine.materialize_converted``), then ``prepare(params)`` if
    given; resident bytes held to :func:`analytic_resident_bytes` and the
    peak allocation to resident + 2 x ``largest`` (``what``: the largest
    float32 leaf drawn whole) + :data:`STREAM_SLACK_BYTES`."""
    from repro_torch.serve import engine

    mode = path_spec(path)[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = engine.materialize_converted(cfg, mode, seed=SEED, device=device)
    if prepare is not None:
        prepare(qparams)
    torch.cuda.synchronize()
    got, want = engine.resident_bytes(qparams), analytic_resident_bytes(cfg, mode)
    peak = torch.cuda.max_memory_allocated() - base
    limit = got + 2 * largest + STREAM_SLACK_BYTES
    print(f"path {path}: {header} drawn and converted leaf by leaf ({mode}): "
          f"{time.perf_counter() - t0:.2f} s, {got} B resident (analytic {want} B, "
          f"{got / want - 1:+.2e}), peak allocated {peak} B (bound {limit} B = resident + "
          f"2 x {largest} B, {what}, + {STREAM_SLACK_BYTES} B)")
    check(abs(got - want) <= RESIDENT_RTOL * want,
          f"path {path}: resident bytes {got} vs analytic {want}")
    check(peak <= limit, f"path {path}: the conversion peaked at {peak} B > {limit} B")
    return qparams


def phase_configs(torch, device, card) -> dict[str, dict]:
    """Paths G-J: each further config at full width (and depth, but where
    :data:`CONFIG_DEPTH` cuts it) on path A's and path B's stack, drawn from
    ``SEED`` and converted leaf by leaf (qwen1.5-32b's float weights would
    not fit the card beside their converted form), resident bytes held to
    the analytic count and the peak allocation to its bound; each path
    served as A-C are and profiled, its tree freed before the next.
    Returns path → kernel → launches."""
    from repro_torch.serve import engine

    counts = {}
    for path, (arch, _, _) in CONFIG_PATHS.items():
        cfg = config_for(arch)
        largest = max(k * n for name, (k, n) in config_projections(cfg).items()
                      if name != "head") * 4
        qparams = draw_converted(
            torch, device, cfg, path,
            f"{arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size})", largest, "the largest layer projection in float32")
        counts[path] = _serve_path(torch, device, card, engine, qparams, cfg, path)
        phase_profile(torch, device, engine, qparams, cfg, card, path)
        del qparams
        torch.cuda.empty_cache()
    return counts


def _largest_leaf_bytes(cfg) -> int:
    """Bytes in float32 of the largest weight of a layer: a projection, or
    a MoE layer's stacked expert weight, drawn whole before conversion."""
    from repro_torch.models import model as model_lib

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    return 4 * max(math.prod(leaf.shape) for leaf in leaves(model_lib.specs(cfg)["layers"]))


def describe(cfg) -> str:
    """A config's shape in one line: depth, widths, mixer and FFN."""
    parts = [f"{cfg.n_layers} layers", f"d_model {cfg.d_model}"]
    if cfg.family == "ssm":
        parts.append(f"d_inner {cfg.d_inner}, d_state {cfg.d_state}, dt_rank "
                     f"{cfg.dt_rank_actual}")
    else:
        parts.append(f"{cfg.n_heads} / {cfg.n_kv_heads} kv heads")
    if cfg.attn_type == "mla":
        parts.append(f"kv_lora {cfg.kv_lora_rank}, q_lora {cfg.q_lora_rank}")
    if cfg.sliding_window:
        parts.append(f"window {cfg.sliding_window}")
    if cfg.n_experts:
        parts.append(f"experts {cfg.n_experts} top {cfg.experts_per_tok} + "
                     f"{cfg.n_shared_experts} shared, expert d_ff {cfg.moe_d_ff}")
    return ", ".join(parts + [f"vocab {cfg.vocab_size}"])


def phase_full_paths(torch, device, card, paths) -> dict[str, dict]:
    """Each path of ``paths`` (path → (arch, ...)): paths K-N (minicpm3-4b
    and deepseek-v2-lite-16b, MLA launching no plane attention) or O-R
    (mixtral-8x7b and falcon-mamba-7b), at full width and at full depth
    but where :data:`CONFIG_DEPTH` cuts it, drawn from ``SEED`` and converted leaf by leaf (a stacked expert weight
    an expert at a time), resident bytes held to the analytic count and the
    peak allocation to resident + 2 x the largest layer leaf in float32 +
    the slack; each served as A-C are and profiled, its tree freed before
    the next.  Returns path → kernel → launches."""
    from repro_torch.serve import engine

    counts = {}
    for path, (arch, _, _, _) in paths.items():
        cfg = config_for(arch)
        qparams = draw_converted(torch, device, cfg, path, f"{arch} ({describe(cfg)})",
                                 _largest_leaf_bytes(cfg), "the largest layer leaf in float32")
        counts[path] = _serve_path(torch, device, card, engine, qparams, cfg, path)
        phase_profile(torch, device, engine, qparams, cfg, card, path)
        del qparams
        torch.cuda.empty_cache()
    return counts


def _serve_path(torch, device, card, engine, qparams, cfg, path) -> dict:
    import numpy as np

    from repro_torch.kernels import ops

    mode, cache, must, _ = path_spec(path)
    rng = np.random.default_rng(SEED)
    counts: dict = {}
    for slots, n_requests in ((4, 8), (1, 2)):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        eng = _serve(engine, qparams, cfg, mode, cache, slots, n_requests, rng, device)
        torch.cuda.synchronize()
        launches, plain = ops.launch_counts(), ops.plain_cuda_counts()
        ran = {k: v for k, v in launches.items() if v}
        print(f"path {path} serve slots={slots}: launches {ran} plain-on-cuda "
              f"{sum(plain.values())}")
        check(all(v == 0 for v in plain.values()),
              f"path {path} slots={slots}: a plain version ran on a CUDA tensor: {plain}")
        for name in must[slots]:
            check(launches[name] > 0, f"path {path} slots={slots}: {name} never launched")
        if slots == 1 and "bsdp_gemv" in must[1]:  # the slots=1 gap line's launches per step
            steps = sum(len(req.out) - 1 for req in eng.requests)  # decode steps: 1 row each
            # each BSDP GEMM launch of a slots=4 step is a GEMV at slots=1 (the
            # FFN's w_in and w_out a layer; a MoE layer's grouped experts too)
            per_step = path_spec(path)[3]
            want = (per_step.get("bsdp_gemm_fused", 0) + per_step.get("bsdp_gemm", 0)) * steps
            check(launches["bsdp_gemv"] == want,
                  f"path {path} slots=1: bsdp_gemv launched {launches['bsdp_gemv']} times in "
                  f"{steps} decode steps, expected {want}")
        # MLA reads its latent through the formats' plane math; an SSM has no attention
        if path in MLA_PATHS or cfg.family == "ssm":
            check(launches["plane_decode_attention"] == 0,
                  f"path {path}: {cfg.name} launched plane attention")
        for name, v in ran.items():
            counts[name] = counts.get(name, 0) + v
        for req in eng.requests:
            check(req.state == "done" and len(req.out) == 32,
                  f"path {path}: request {req.uid} unfinished")
            check(all(0 <= t < cfg.vocab_size for t in req.out), "token out of vocab")
        for kind, _, logits in eng.logit_trace:
            check(bool(np.isfinite(logits).all()) and logits.shape[-1] == cfg.vocab_size,
                  f"path {path}: {kind} logits not finite / wrong width")
        st = eng.stats()
        print(f"path {path} serve slots={slots} on {card}: {st.total_tokens} tokens, "
              f"{st.tok_per_s:.2f} tok/s, TTFT p50 {st.percentile('ttft_s', 50) * 1e3:.2f} ms, "
              f"TPOT p50 {st.percentile('tpot_s', 50) * 1e3:.2f} ms, steps {st.steps}, "
              f"peak mem {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return counts


def phase_profile(torch, device, engine, qparams, cfg, card, path, steps: int = 3) -> None:
    """Where a decode step's time goes on one path: the launches of one
    decode step at slots=4 (checked against the path's count), then
    :func:`profile_steps` over a few steady decode steps."""
    import numpy as np

    from repro_torch.kernels import ops

    mode, cache, _, per_step = path_spec(path)
    eng = engine.ServeEngine(qparams, cfg, mode=mode, cache_format=cache, slots=4,
                             max_len=512, device=device)
    rng = np.random.default_rng(SEED + 1)
    for _ in range(4):
        eng.submit(rng.integers(0, cfg.vocab_size, size=64).astype(np.int32), 3 + 2 * steps)
    eng.step()  # prefill (+ first decode)
    eng.step()
    torch.cuda.synchronize()
    ops.reset_counts()
    eng.step()
    torch.cuda.synchronize()
    step_launches = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"path {path} launches per decode step (slots=4): {step_launches}")
    check(step_launches == per_step,
          f"path {path}: decode step launched {step_launches}, expected {per_step}")
    profile_steps(torch, eng.step, steps, f"path {path} profile decode step (slots=4, "
                  f"{cfg.n_layers} layers, {card}, under the profiler)")


def profile_steps(torch, step, steps: int, label: str) -> None:
    """``torch.profiler`` over ``steps`` calls of ``step`` (an engine step,
    or a decode step of the cross paths): wall time, device-busy
    time (the sum of the device-side kernel and copy durations), idle share,
    device operations per step and the kernels taking most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 / steps
    by_name: dict = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"{label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, device ops {len(dev_events) / steps:.0f}/step")
    for name, ms in top:
        print(f"  {ms:8.3f} ms/step  {name[:90]}")


# ---------------------------------------------------------------------------
# Path E: chunked prefill on path A; path F: the int8 cache on path B
# ---------------------------------------------------------------------------

#: path E's schedulers (fcfs, then chunks of at most 32 and 256 tokens a
#: slot) → the most query rows G plane attention takes: 2 · the longest
#: chunk, 448 - 256 = 192 tokens under budget 256 (the first 256 refill
#: through the prefill path)
E_SCHEDULERS = {"fcfs": 2, "token_budget:budget=32": 64, "token_budget:budget=256": 384}
E_LONG = 448  # the long prompt, submitted first


def _plane_attention_rows(plane_attn, ring_lengths=None):
    """Wrap ``plane_attn.plane_decode_attention`` to record the query rows G
    of every call (and the ring length L into ``ring_lengths``); returns
    (the list, a function that restores it)."""
    seen, fn = [], plane_attn.plane_decode_attention

    def recording(q_planes, q_scale, k_planes, *args, **kw):
        seen.append(q_planes.shape[2])
        if ring_lengths is not None:
            ring_lengths.append(k_planes.shape[1])
        return fn(q_planes, q_scale, k_planes, *args, **kw)

    plane_attn.plane_decode_attention = recording
    return seen, lambda: setattr(plane_attn, "plane_decode_attention", fn)


def phase_chunked(torch, device, card, engine, qparams, cfg) -> dict:
    """Path E: path A's weights and cache at full width and depth, slots=4,
    max_len 512; one 448-token prompt submitted first and seven of 16-64
    tokens, all at step 0, 32 new tokens each, served under each of
    :data:`E_SCHEDULERS`.  The long prompt must walk through PREFILLING
    under the budgets, every chunk step must launch plane attention once a
    layer with no plain version on the card, every request must finish with
    32 tokens in the vocabulary and finite logits, and the three shorts
    refilled with the long prompt must each get a strictly smaller
    ``ttft_work`` (the deterministic clock) than under fcfs.  Then one chunk
    step of each budget under the profiler.  Returns the kernel launches."""
    import numpy as np

    from repro_torch.kernels import ops, plane_attn
    from repro_torch.serve.scheduler import PREFILLING

    mode, cache, _, _ = PATHS["A"]
    rng = np.random.default_rng(SEED + 3)
    lens = [E_LONG] + [int(n) for n in rng.integers(16, 65, size=7)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    counts: dict = {}
    ttft_work = {}
    for sched in E_SCHEDULERS:
        eng = engine.ServeEngine(qparams, cfg, mode=mode, cache_format=cache, scheduler=sched,
                                 slots=4, max_len=512, trace_logits=True, device=device)
        reqs = [eng.submit(p, 32) for p in prompts]
        refilled = reqs[1:4]  # the shorts that share the long prompt's refill
        seen_g, restore = _plane_attention_rows(plane_attn)
        torch.cuda.synchronize()
        ops.reset_counts()
        prefilling, chunk_steps = False, 0
        try:
            while True:
                chunking = any(r is not None and r.state == PREFILLING for r in eng.active)
                before = ops.launch_counts()["plane_decode_attention"]
                if not eng.step():
                    break
                prefilling |= reqs[0].state == PREFILLING
                if chunking:
                    chunk_steps += 1
                    n = ops.launch_counts()["plane_decode_attention"] - before
                    check(n == cfg.n_layers, f"path E {sched}: a chunk step launched plane "
                          f"attention {n} times, expected {cfg.n_layers}")
            torch.cuda.synchronize()
        finally:
            restore()
        launches, plain = ops.launch_counts(), ops.plain_cuda_counts()
        ran = {k: v for k, v in launches.items() if v}
        for name, v in ran.items():
            counts[name] = counts.get(name, 0) + v
        check(all(v == 0 for v in plain.values()),
              f"path E {sched}: a plain version ran on a CUDA tensor: {plain}")
        check(launches["plane_decode_attention"] > 0, f"path E {sched}: no plane attention")
        chunked = sched != "fcfs"
        check(prefilling == chunked and (chunk_steps > 0) == chunked,
              f"path E {sched}: PREFILLING {prefilling}, {chunk_steps} chunk steps")
        check(max(seen_g) == E_SCHEDULERS[sched],
              f"path E {sched}: plane attention took G up to {max(seen_g)}, expected "
              f"{E_SCHEDULERS[sched]}")
        for req in reqs:
            check(req.state == "done" and len(req.out) == 32,
                  f"path E {sched}: request {req.uid} unfinished")
            check(all(0 <= t < cfg.vocab_size for t in req.out), "token out of vocab")
        for kind, _, logits in eng.logit_trace:
            check(bool(np.isfinite(logits).all()) and logits.shape[-1] == cfg.vocab_size,
                  f"path E {sched}: {kind} logits not finite / wrong width")
        st = eng.stats()
        ttft_work[sched] = [st.requests[r.uid].ttft_work for r in refilled]
        print(f"path E serve {sched} on {card}: {st.total_tokens} tokens, {st.tok_per_s:.2f} "
              f"tok/s, TTFT p50 {st.percentile('ttft_s', 50):.4f} s p95 "
              f"{st.percentile('ttft_s', 95):.4f} s, TPOT p50 "
              f"{st.percentile('tpot_s', 50) * 1e3:.2f} ms, steps {st.steps}, chunk steps "
              f"{chunk_steps}, plane attention G up to {max(seen_g)}, ttft_work of the "
              f"co-refilled shorts {ttft_work[sched]} (long {st.requests[0].ttft_work}), "
              f"launches {ran}")
    budgets = list(E_SCHEDULERS)[1:]
    for sched in budgets:
        for got, fcfs in zip(ttft_work[sched], ttft_work["fcfs"]):
            check(got < fcfs, f"path E {sched}: a co-refilled short's ttft_work {got} is not "
                  f"below fcfs's {fcfs}")
    for sched in budgets:  # one chunk step of each budget, under the profiler
        eng = engine.ServeEngine(qparams, cfg, mode=mode, cache_format=cache, scheduler=sched,
                                 slots=4, max_len=512, device=device)
        for p in prompts[:4]:
            eng.submit(p, 32)
        eng.step()  # refill: the long prompt's first chunk, the shorts' whole prompts
        n = min(int(sched.split("=")[1]), E_LONG - eng.requests[0].prefilled)
        profile_steps(torch, eng.step, 1, f"path E profile chunk step ({sched}: S={n}, G={2 * n}, "
                      f"3 decode rows, {cfg.n_layers} layers, {card}, under the profiler)")
        torch.cuda.empty_cache()
    return counts


def analytic_int8_cache_bytes(cfg, slots: int, max_len: int) -> int:
    """The ``int8`` cache's bytes from its shapes: per layer, K and V as
    one int8 byte a feature plus a float32 scale a (slot, position, kv head),
    and the int32 ``pos_ids``."""
    return (2 * cfg.n_layers * slots * max_len * cfg.n_kv_heads * (cfg.d_head + 4)
            + cfg.n_layers * slots * max_len * 4)


def phase_int8_cache(torch, device, card, engine, qparams, cfg) -> dict:
    """Path F: ``w8a8`` weights with the ``int8`` cache under ``sjf`` at
    slots=4, the phase-3 mix.  ``matmul_int8`` must launch with no plain
    version on the card, every request finish, and the weights' and the live
    cache's bytes equal their analytic counts."""
    import numpy as np

    from repro_torch.core import kvcache
    from repro_torch.kernels import ops

    mode, max_len = PATHS["B"][0], 512
    rng = np.random.default_rng(SEED)
    torch.cuda.synchronize()
    ops.reset_counts()
    eng = engine.ServeEngine(qparams, cfg, mode=mode, cache_format="int8", scheduler="sjf",
                             slots=4, max_len=max_len, trace_logits=True, device=device)
    for n in rng.integers(16, 129, size=8):
        eng.submit(rng.integers(0, cfg.vocab_size, size=(int(n),)).astype("int32"), 32)
    eng.run()
    torch.cuda.synchronize()
    launches, plain = ops.launch_counts(), ops.plain_cuda_counts()
    ran = {k: v for k, v in launches.items() if v}
    check(all(v == 0 for v in plain.values()),
          f"path F: a plain version ran on a CUDA tensor: {plain}")
    check(launches["matmul_int8"] > 0, "path F: matmul_int8 never launched")
    for req in eng.requests:
        check(req.state == "done" and len(req.out) == 32, f"path F: request {req.uid} unfinished")
        check(all(0 <= t < cfg.vocab_size for t in req.out), "token out of vocab")
    for kind, _, logits in eng.logit_trace:
        check(bool(np.isfinite(logits).all()), f"path F: {kind} logits not finite")
    weights, want_w = engine.resident_bytes(eng.params), analytic_resident_bytes(cfg, mode)
    cache, want_c = (kvcache.cache_resident_bytes(eng.caches),
                     analytic_int8_cache_bytes(cfg, 4, max_len))
    st = eng.stats()
    print(f"path F serve (w8a8, int8 cache, sjf, slots=4) on {card}: {st.total_tokens} tokens, "
          f"{st.tok_per_s:.2f} tok/s, TTFT p50 {st.percentile('ttft_s', 50) * 1e3:.2f} ms, "
          f"TPOT p50 {st.percentile('tpot_s', 50) * 1e3:.2f} ms, steps {st.steps}; resident "
          f"weights {weights} B (analytic {want_w}), cache {cache} B (analytic {want_c}); "
          f"launches {ran}")
    check(weights == want_w, f"path F: resident weight bytes {weights} != analytic {want_w}")
    check(cache == want_c, f"path F: int8 cache bytes {cache} != analytic {want_c}")
    return ran


# ---------------------------------------------------------------------------
# Path S: the sliding window across a 4096-position ring
# ---------------------------------------------------------------------------

#: path S: mixtral-8x7b at full width, depth cut to S_LAYERS, path A's stack,
#: slots=4, a ring of min(window, S_MAX_LEN) = 4096 positions; one prompt
#: longer than the window and three short ones, S_NEW new tokens each, under
#: each of S_SCHEDULERS (token_budget's chunk rows run past position 4096,
#: plane attention at G up to 4 query heads a kv head · 256)
S_LAYERS = 2
S_MAX_LEN = 4352
S_PROMPTS = (4160, 64, 64, 64)
S_NEW = 64
S_SCHEDULERS = ("fcfs", "token_budget:budget=256")
#: path S's kernel-vs-plain comparisons, float32 on S's schedule: ((weights,
#: cache), schedulers, how it is held).  "exact": a zero difference with
#: every expert choice the same (every kernel of the stack is exact), so no
#: kernel is at fault at S's shapes; "limits": PATH_LIMITS with the plain
#: path's expert choices forced (w8a16's float32 sums in another order,
#: through the int4 cache and the window's bias); "printed": the drift is
#: printed and not held.  Path A's stack is printed: its int4 FFN re-quantizes
#: w8a16's last-bit differences (a row's int4 scale is its max |x|, so one
#: moved element can re-round the whole row) over S's 4,160-token rows, and
#: the fcfs line of the int4 FFN beside the bf16 cache shows that the drift
#: starts there and not at the cache; :func:`_reference_distances` then
#: measures both of its paths against a more exact run.
S_MODES = (
    (MOE_EXACT_MODE[:2], S_SCHEDULERS, "exact"),
    (("w8a16", "int4_bp_fused"), S_SCHEDULERS, "limits"),
    (("ffn=bsdp_fused,mixer=w8a16", "bf16"), ("fcfs",), "printed"),
    (PATHS["A"][:2], ("fcfs",), "printed"),
)


def phase_window(torch, device, card) -> dict:
    """Path S under each of :data:`S_SCHEDULERS`: every request finishes with
    S_NEW tokens in the vocabulary and finite logits, plane attention runs at
    L = 4096 (and, chunked, at G = 4 · the chunk, the long prompt's chunks
    reaching past position 4096) with no plain version on the card, and each slot's
    ring holds exactly its request's last <= 4096 written positions.  Then
    the kernel path against the plain path in float32 for each stack of
    :data:`S_MODES`.  Returns the kernel launches of the bf16 serves."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, plane_attn
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import PREFILLING

    cfg = get_config("mixtral-8x7b").scaled(n_layers=S_LAYERS)
    ring = min(cfg.sliding_window, S_MAX_LEN)
    mode, cache = PATHS["A"][:2]
    qparams = engine.materialize_converted(cfg, mode, seed=SEED, device=device)
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in S_PROMPTS]
    tops = sorted(n + S_NEW - 2 for n in S_PROMPTS)  # the last position each request writes
    counts: dict = {}
    for sched in S_SCHEDULERS:
        eng = engine.ServeEngine(qparams, cfg, mode=mode, cache_format=cache, scheduler=sched,
                                 slots=4, max_len=S_MAX_LEN, trace_logits=True, device=device)
        reqs = [eng.submit(p, S_NEW) for p in prompts]
        ring_lengths: list = []
        seen_g, restore = _plane_attention_rows(plane_attn, ring_lengths)
        torch.cuda.synchronize()
        ops.reset_counts()
        chunks = []  # (first, last + 1) positions of the long prompt's decode-call chunks
        t0 = time.perf_counter()
        try:
            while True:
                before = reqs[0].prefilled if reqs[0].state == PREFILLING else None
                if not eng.step():
                    break
                if before is not None:
                    chunks.append((before, reqs[0].prefilled))
            torch.cuda.synchronize()
        finally:
            restore()
        wall = time.perf_counter() - t0
        launches, plain = ops.launch_counts(), ops.plain_cuda_counts()
        ran = {k: v for k, v in launches.items() if v}
        for name, v in ran.items():
            counts[name] = counts.get(name, 0) + v
        check(all(v == 0 for v in plain.values()),
              f"path S {sched}: a plain version ran on a CUDA tensor: {plain}")
        for name in PATHS["A"][2][4]:
            check(launches[name] > 0, f"path S {sched}: {name} never launched")
        check(set(ring_lengths) == {ring},
              f"path S {sched}: plane attention ran over rings of {sorted(set(ring_lengths))}")
        chunked = sched != "fcfs"
        longest = max((b - a for a, b in chunks), default=1)
        check(bool(chunks) == chunked and (not chunked or max(b for _, b in chunks) > ring),
              f"path S {sched}: the long prompt's chunks {chunks}")
        # G = query heads a kv head × the call's longest chunk (a short prompt's may be longer)
        grp = cfg.n_heads // cfg.n_kv_heads
        check(grp * longest <= max(seen_g) <= grp * (256 if chunked else 1),
              f"path S {sched}: plane attention took G up to {max(seen_g)}, the long "
              f"prompt's longest chunk {longest}")
        for req in reqs:
            check(req.state == "done" and len(req.out) == S_NEW,
                  f"path S {sched}: request {req.uid} unfinished")
            check(all(0 <= t < cfg.vocab_size for t in req.out), "token out of vocab")
        for kind, _, logits in eng.logit_trace:
            check(bool(np.isfinite(logits).all()) and logits.shape[-1] == cfg.vocab_size,
                  f"path S {sched}: {kind} logits not finite / wrong width")
        for i, layer in enumerate(eng.caches):
            pos_ids = layer["pos_ids"].cpu().numpy()
            check(pos_ids.shape == (4, ring), f"path S: layer {i}'s ring is {pos_ids.shape}")
            got_tops = []
            for row in pos_ids:
                live = row[row >= 0]
                top = int(live.max())
                check(sorted(live.tolist()) == list(range(max(0, top - ring + 1), top + 1)),
                      f"path S {sched}: layer {i}: a ring does not hold exactly its last "
                      f"<= {ring} positions (up to {top})")
                got_tops.append(top)
            check(sorted(got_tops) == tops, f"path S {sched}: the rings end at {got_tops}")
        st = eng.stats()
        print(f"path S serve {sched} (mixtral-8x7b, {S_LAYERS} layers, ring {ring}, prompts "
              f"{list(S_PROMPTS)}) on {card}: {st.total_tokens} tokens in {wall:.2f} s, "
              f"TTFT p50 {st.percentile('ttft_s', 50):.4f} s, TPOT p50 "
              f"{st.percentile('tpot_s', 50) * 1e3:.2f} ms, steps {st.steps}, chunk steps "
              f"{len(chunks)} (the last ending at {chunks[-1][1] if chunks else '-'}), plane "
              f"attention G up to {max(seen_g)} at L {ring}; every ring holds its last <= "
              f"{ring} positions; launches {ran}")
    del qparams, eng
    torch.cuda.empty_cache()
    cfg32 = cfg.scaled(dtype=torch.float32)
    schedule = (4, S_MAX_LEN, tuple((n, S_NEW) for n in S_PROMPTS))
    for (mode, cache), schedulers, held in S_MODES:
        params32 = engine.materialize_converted(cfg32, mode, seed=SEED, device=device)
        exact = held == "exact"
        for sched in schedulers:
            _kernel_vs_plain(engine, params32, cfg32, mode, cache, sched, "float32",
                             (0.0, PATH_LIMITS["float32"][1]) if exact else
                             PATH_LIMITS["float32"], device, exact_routes=exact,
                             schedule=schedule, held=held != "printed")
        if (mode, cache) == PATHS["A"][:2]:
            _reference_distances(
                torch, f"path S ({cfg32.name}, {cfg32.n_layers} layers, {mode}, cache {cache}, "
                f"fcfs)",
                lambda impl, forced: _serve_cut(engine, params32, cfg32, mode, cache, "fcfs",
                                                impl, device, forced=forced, schedule=schedule))
        del params32
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Paths T-W: cross-attention through model.prefill and model.decode_step
# ---------------------------------------------------------------------------

#: paths T-W: new tokens a request (greedy), and the ring length
CROSS_NEW, CROSS_MAX_LEN = 32, 512


def open_gates(params, cfg, value: float = CROSS_GATE) -> None:
    """Set every cross layer's tanh ``gate`` to ``value`` in place (a
    ``cross`` layer's under ``mixer``, an ``attn_cross`` layer's under
    ``cross``; the encoder-decoder does not read its gate)."""
    for i, layer in enumerate(params["layers"]):
        kind = cfg.mixer_kind(i)
        if kind != "attn":
            layer["mixer" if kind == "cross" else "cross"]["gate"].fill_(value)


class CrossDrive:
    """One batch of requests of a cross-attention config driven through
    ``model.prefill`` (prompts left-padded with negative positions, each
    row's context drawn from ``SEED``) and greedy ``model.decode_step``
    calls; each call's logits are checked finite and as wide as the vocab,
    and its tokens copied to the host (as the engine copies its logits)."""

    def __init__(self, torch, params, cfg, lens, device, impl=None, forced=None):
        import numpy as np

        from repro_torch.models import model as model_lib

        self.torch, self.model, self.params, self.cfg, self.impl = (
            torch, model_lib, params, cfg, impl)
        self.forced = forced
        b, s = len(lens), max(lens)
        rng = np.random.default_rng(SEED + 5)
        tokens = rng.integers(0, cfg.vocab_size, size=(b, s))
        pos = np.stack([np.arange(s) - (s - n) for n in lens])
        gen = torch.Generator(device=device).manual_seed(SEED + 5)
        ctx = torch.randn((b, cfg.encoder_tokens, cfg.d_model), generator=gen, device=device)
        key = "enc_embeds" if cfg.is_enc_dec else "ctx_embeds"
        self.batch = {"tokens": torch.from_numpy(tokens).to(device),
                      "positions": torch.from_numpy(pos.astype(np.int32)).to(device), key: ctx}
        self.pos = torch.tensor(lens, dtype=torch.int32, device=device)
        self.out: list = []  # tokens a call, on the host
        self.logits: list = []  # [(kind, rows, host logits)] in the order of the calls
        self.caches = None

    def _take(self, kind, logits):
        torch = self.torch
        check(tuple(logits.shape) == (self.pos.shape[0], 1, self.cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{self.cfg.name}: {kind} logits not finite / wrong shape {tuple(logits.shape)}")
        step = len(self.out)
        if self.forced is not None:
            tok = torch.as_tensor(self.forced[step], device=logits.device)[:, None]
        else:
            tok = logits[:, -1].argmax(-1, keepdim=True)
        self.tok = tok
        host = logits.cpu().numpy()
        self.logits.append((kind, tok.shape[0], host))
        self.out.append(tok.cpu().numpy()[:, 0])

    def prefill(self):
        logits, self.caches = self.model.prefill(self.params, self.batch, self.cfg,
                                                 max_len=CROSS_MAX_LEN, impl=self.impl)
        self._take("prefill", logits)

    def step(self):
        logits, self.caches = self.model.decode_step(self.params, self.tok, self.caches,
                                                     self.pos, self.cfg, impl=self.impl)
        self.pos = self.pos + 1
        self._take("decode", logits)


def phase_cross(torch, device, card) -> dict[str, dict]:
    """Paths T-W: llama-3.2-vision-11b and seamless-m4t-medium at full width
    and depth on A's and B's stacks, drawn from ``SEED`` and converted leaf
    by leaf, every cross gate set to :data:`CROSS_GATE`, resident bytes held
    to the analytic count (the cross and encoder leaves included) and the
    peak allocation to its bound.  Each serves, through ``model.prefill``
    and greedy ``model.decode_step``, four prompts of 16-128 tokens
    (left-padded) with their contexts (llama-vision's [4, 1601, 4096] patch
    embeddings, seamless's [4, 1536, 1024] frames through its encoder) for
    :data:`CROSS_NEW` tokens, then one request at slots=1; the kernels of
    the path must launch with no plain version on the card (``bsdp_gemv``
    exactly twice a layer a decode step at slots=1), and one decode step at
    slots=4 launch exactly the path's count; then 3 decode steps under the
    profiler.  Returns path → kernel → launches."""
    import numpy as np

    from repro_torch.kernels import ops

    counts = {}
    for path, (arch, _, must, per_step) in CROSS_PATHS.items():
        cfg = config_for(arch).scaled(cache_format=path_spec(path)[1])
        # the untied head's draw may be the largest (seamless's 256206-row vocab)
        largest = max(_largest_leaf_bytes(cfg), 4 * cfg.d_model * cfg.vocab_size)
        enc = f", encoder {cfg.n_enc_layers} layers" if cfg.is_enc_dec else ""
        qparams = draw_converted(
            torch, device, cfg, path,
            f"{arch} ({describe(cfg)}, context {cfg.encoder_tokens} tokens{enc}, cross layers "
            f"{[i for i in range(cfg.n_layers) if cfg.mixer_kind(i) != 'attn']}, gates "
            f"{CROSS_GATE})", largest, "the largest leaf in float32",
            prepare=lambda params: open_gates(params, cfg))
        rng = np.random.default_rng(SEED)
        counts[path] = {}
        for slots in (4, 1):
            lens = [int(n) for n in rng.integers(16, 129, size=slots)]
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            ops.reset_counts()
            t0 = time.perf_counter()
            drive = CrossDrive(torch, qparams, cfg, lens, device)
            drive.prefill()
            ttft = time.perf_counter() - t0
            for _ in range(CROSS_NEW - 1):
                drive.step()
            wall = time.perf_counter() - t0
            launches, plain = ops.launch_counts(), ops.plain_cuda_counts()
            ran = {k: v for k, v in launches.items() if v}
            print(f"path {path} slots={slots}: launches {ran} plain-on-cuda {sum(plain.values())}")
            check(all(v == 0 for v in plain.values()),
                  f"path {path} slots={slots}: a plain version ran on a CUDA tensor: {plain}")
            for name in must[slots]:
                check(launches[name] > 0, f"path {path} slots={slots}: {name} never launched")
            if slots == 1 and "bsdp_gemv" in must[1]:
                want_gemv = per_step["bsdp_gemm_fused"] * (CROSS_NEW - 1)
                check(launches["bsdp_gemv"] == want_gemv,
                      f"path {path} slots=1: bsdp_gemv launched {launches['bsdp_gemv']} times, "
                      f"expected {want_gemv}")
            for name, v in ran.items():
                counts[path][name] = counts[path].get(name, 0) + v
            toks = np.stack(drive.out)
            check(toks.shape == (CROSS_NEW, slots) and bool(((toks >= 0)
                                                             & (toks < cfg.vocab_size)).all()),
                  f"path {path}: tokens {toks.shape} out of the vocab")
            print(f"path {path} slots={slots} (prompts {lens}) on {card}: {slots * CROSS_NEW} "
                  f"tokens in {wall:.2f} s, {slots * CROSS_NEW / wall:.2f} tok/s, TTFT (prefill, "
                  f"encoder included) {ttft * 1e3:.2f} ms, TPOT "
                  f"{(wall - ttft) / (CROSS_NEW - 1) * 1e3:.2f} ms, peak mem "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        drive = CrossDrive(torch, qparams, cfg, [64] * 4, device)
        drive.prefill()
        drive.step()
        torch.cuda.synchronize()
        ops.reset_counts()
        drive.step()
        torch.cuda.synchronize()
        step_launches = {k: v for k, v in ops.launch_counts().items() if v}
        print(f"path {path} launches per decode step (slots=4): {step_launches}")
        check(step_launches == per_step,
              f"path {path}: decode step launched {step_launches}, expected {per_step}")
        profile_steps(torch, drive.step, 3, f"path {path} profile decode step (slots=4, "
                      f"{cfg.n_layers} layers, {card}, under the profiler)")
        del qparams, drive
        torch.cuda.empty_cache()
    return counts


def _reference_distances(torch, label: str, run) -> tuple:
    """Whether a kernel path's drift from its plain path is a kernel's
    fault or the stack's sensitivity to rounding: ``run(impl, forced)``
    serves one teacher-forced schedule → (logit trace, tokens, MoE routes),
    with ``forced`` another run's routes.  One reference run, the plain
    path with every ``w8a16`` product taken in float64 and rounded once to
    float32 (``dequant_matmul_plain`` wrapped for that run alone), then the
    plain path and the kernel path with the reference's expert choices
    forced; prints each path's distance from the reference and from each
    other.  Within about 2x of each other, the kernel path is as far from
    the more exact run as the plain path is: no kernel is at fault.
    Printed, not held.  Returns the two distances (kernel, plain)."""
    from repro_torch.kernels import dequant_gemv

    plain_fn = dequant_gemv.dequant_matmul_plain

    def wide(x, w_i8, w_scale):
        w = w_i8.to(torch.float64) * w_scale.reshape(1, -1).to(torch.float64)
        return (x.to(torch.float64) @ w).to(torch.float32)

    dequant_gemv.dequant_matmul_plain = wide
    try:
        ref = run("plain", None)
    finally:
        dequant_gemv.dequant_matmul_plain = plain_fn
    plain, kernel = run("plain", ref[2]), run(None, ref[2])
    for other in (plain, kernel):
        check([(k, s) for k, s, _ in other[0]] == [(k, s) for k, s, _ in ref[0]]
              and other[1] == ref[1], f"{label}: a run scheduled or emitted differently")
    (k_rel, k_cos, _), (p_rel, p_cos, _), (kp_rel, kp_cos, _) = (
        _drift((kernel[0], ref[0])), _drift((plain[0], ref[0])), _drift((kernel[0], plain[0])))
    ratio = k_rel / p_rel if p_rel else float("inf")
    verdict = ("same order (within 2x): no kernel is at fault" if ratio <= 2 else
               "the kernel path more than 2x further: a kernel is at fault")
    forced = ", the reference's expert choices forced" if ref[2] else ""
    print(f"{label} against a float64-w8a16 reference (float32{forced}, {len(ref[0])} logit "
          f"vectors): kernel path max rel err {k_rel:.3e} / min cosine {k_cos:.6f}, plain path "
          f"{p_rel:.3e} / {p_cos:.6f}, kernel vs plain {kp_rel:.3e} / {kp_cos:.6f}; kernel / "
          f"plain distance {ratio:.3f}: {verdict} (printed, not held)")
    return k_rel, p_rel


# ---------------------------------------------------------------------------
# Path D: the ops-level entry points of the DIM and raw int32 W8A8 kernels
# ---------------------------------------------------------------------------


def phase_ops_path(torch, device) -> dict:
    """``ops.dim_matmul`` and ``ops.matmul_int8_raw`` once each at a decode
    shape (M = 4, K = N = 2048), checked against the byte-plane
    decomposition of ``core/dim.py`` and the plain int32 matmul."""
    from repro_torch.core import dim
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    x = _int8(torch, gen, device, 4, 2048)
    w16 = torch.randint(-32768, 32768, (2048, 2048), dtype=torch.int16, generator=gen,
                        device=device)
    w16[0, 0], w16[1, 1], w16[2, 0] = -32768, 32767, -1
    w8 = _int8(torch, gen, device, 2048, 2048)
    ops.reset_counts()
    out_dim = ops.dim_matmul(x, w16)
    out_raw = ops.matmul_int8_raw(x, w8)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"path D (ops.dim_matmul, ops.matmul_int8_raw): launches {launches}")
    check(launches == {"matmul_w16a8": 1, "matmul_int8": 1}, f"path D launched {launches}")
    check(all(v == 0 for v in ops.plain_cuda_counts().values()),
          "path D: a plain version ran on a CUDA tensor")
    check(torch.equal(out_dim, dim.matmul_w16a8(x, w16)), "ops.dim_matmul != core.dim")
    check(torch.equal(out_raw, ref.matmul_int8_ref(x, w8)), "ops.matmul_int8_raw != oracle")
    return launches


# ---------------------------------------------------------------------------
# Phase 4: kernel path against the plain path (2 layers, full width)
# ---------------------------------------------------------------------------


def phase_paths(torch, device) -> None:
    """Kernel path against plain path on 2-layer cuts at full width: qwen3-1.7b
    under every stack of :data:`PATH_MODES`, each further config under its
    two stacks (paths G-R; path B's stack held to a zero difference on the
    MLA, MoE, window and Mamba configs), qwen1.5-32b under :data:`DRIFT_MODES`,
    deepseek-v2-lite-16b under :data:`MOE_EXACT_MODE` (the bit-exact stacks
    held to a zero difference) and the cuts of :data:`CROSS_CUTS` on their
    two stacks (paths T-W; B's at a zero difference; A's in float32 with its
    boundary codes forced, :class:`CodeLog`), seamless's also under
    :data:`CROSS_DRIFT_MODES`, in float32 and bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serve import engine

    cuts = {"qwen3-1.7b": PATH_MODES}
    for path in [*CONFIG_PATHS, *MLA_PATHS, *WINDOW_SSM_PATHS]:
        arch = (CONFIG_PATHS.get(path) or MLA_PATHS.get(path) or WINDOW_SSM_PATHS[path])[0]
        cuts.setdefault(arch, []).append((*path_spec(path)[:2], "fcfs"))
    cuts["qwen1.5-32b"] += list(DRIFT_MODES)
    cuts["deepseek-v2-lite-16b"].append(MOE_EXACT_MODE)
    # B's stack is all-exact on the MLA, MoE, window and Mamba configs
    exact_b = {arch for arch, *_ in [*MLA_PATHS.values(), *WINDOW_SSM_PATHS.values()]}
    for dtype_name, limits in PATH_LIMITS.items():
        for arch, modes in cuts.items():
            cfg = get_config(arch).scaled(n_layers=2, dtype=getattr(torch, dtype_name))
            float_params = model_lib.materialize(cfg, seed=SEED, device=device)
            for mode, cache, sched in modes:
                # every kernel of path B's stack is exact: no difference at all
                exact = (arch == "qwen1.5-32b" and DRIFT_MODES.get((mode, cache, sched), False)
                         or arch in exact_b and (mode, cache) == PATHS["B"][:2]
                         or (mode, cache, sched) == MOE_EXACT_MODE)
                _kernel_vs_plain(engine, engine.convert_params(float_params, cfg, mode), cfg,
                                 mode, cache, sched, dtype_name, (0.0, limits[1]) if exact else limits,
                                 device, exact_routes=exact)
            del float_params
            torch.cuda.empty_cache()
        for arch, depth in CROSS_CUTS.items():
            cfg = get_config(arch).scaled(dtype=getattr(torch, dtype_name), **depth)
            float_params = model_lib.materialize(cfg, seed=SEED, device=device)
            open_gates(float_params, cfg)
            modes = {path_spec(path)[:2]: "exact" if stack == "B" else "limits"
                     for path, (p_arch, stack, _, _) in CROSS_PATHS.items() if p_arch == arch}
            if cfg.is_enc_dec and dtype_name == "float32":
                modes.update(CROSS_DRIFT_MODES)
            enc = f" + {cfg.n_enc_layers} encoder" if cfg.is_enc_dec else ""
            for (mode, cache), held in modes.items():
                cut = cfg.scaled(cache_format=cache)
                qparams = engine.convert_params(float_params, cut, mode)
                # float32 rounds each float kernel's last bits into int4 codes
                _hold(f"{cfg.name}, {mode}, cache {cache}, {cfg.n_layers}{enc} layers, "
                      f"{dtype_name}, gates {CROSS_GATE}",
                      lambda impl, _: _cross_run(torch, qparams, cut, impl, device),
                      (0.0, limits[1]) if held == "exact" else limits,
                      codes=dtype_name == "float32" and held != "exact")
                del qparams
            del float_params
            torch.cuda.empty_cache()


#: phase 4's cuts of the cross-attention configs: one period of
#: llama-vision's superblock (its cross layer 3 among four self-attention
#: layers) and seamless with 2 encoder and 2 decoder layers
CROSS_CUTS = {"llama-3.2-vision-11b": {"n_layers": 5},
              "seamless-m4t-medium": {"n_layers": 2, "n_enc_layers": 2}}
#: their drive: two prompts left-padded to one prefill with their full-size
#: contexts, then teacher-forced decode steps
CROSS_CUT_LENS, CROSS_CUT_STEPS = (5, 3), 6
#: the seamless cut in float32 under two more stacks, as DRIFT_MODES holds
#: qwen1.5-32b's, each taking some of path A's steps out: (weights, cache)
#: → "exact" (a zero difference: every kernel of the stack is exact, so no
#: integer kernel is at fault at the encoder's M = 2 x 1536) or "limits"
#: (PATH_LIMITS: w8a16's float32 sums in another order, through the int4
#: cache)
CROSS_DRIFT_MODES = {
    ("ffn=bsdp_fused,mixer=w8a8", "bf16"): "exact",
    ("w8a16", "int4_bp_fused"): "limits",
}


def _record_routes(forced=None):
    """Patch ``moe._route`` to record, per call, its top-k experts (as they
    come and as a set, sorted) and the smallest gap between a token's k-th
    and (k+1)-th router probability.  With ``forced`` (another serve's log)
    the call's experts are replaced by that serve's, and the gates taken
    from this serve's own probabilities as ``_route`` takes them: the
    discrete choice is teacher-forced, as the tokens are.  Returns (log,
    undo)."""
    import torch

    from repro_torch.models import moe

    log, route = [], moe._route

    def recording(params, x, cfg):
        idx, gate, aux = route(params, x, cfg)
        probs = torch.softmax(torch.einsum("bsd,de->bse", x.to(torch.float32),
                                           params["router"]), dim=-1)
        top = torch.topk(probs, cfg.experts_per_tok + 1, dim=-1).values
        log.append((idx, torch.sort(idx, dim=-1).values.cpu(),
                    (top[..., -2] - top[..., -1]).min()))
        if forced is not None:
            idx = forced[len(log) - 1][0]
            gate = torch.gather(probs, -1, idx)
            gate = (gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)).to(x.dtype)
        return idx, gate, aux

    moe._route = recording
    return log, lambda: setattr(moe, "_route", route)


#: phase 4's schedule on a cut: (slots, max_len, (prompt tokens, new tokens)
#: a request)
CUT_SCHEDULE = (2, 32, ((5, 6), (3, 2), (7, 4)))


def _serve_cut(engine, params, cfg, mode, cache, sched, impl, device, forced=None,
               schedule=CUT_SCHEDULE):
    """One teacher-forced serve of a cut under ``schedule``: (logit trace,
    tokens, routing log)."""
    import numpy as np

    slots, max_len, requests = schedule
    rng = np.random.default_rng(0)
    eng = engine.ServeEngine(params, cfg, slots=slots, max_len=max_len, mode=mode,
                             cache_format=cache, scheduler=sched,
                             trace_logits=True, impl=impl, device=device)
    log, undo = _record_routes(forced)
    try:
        for n, mn in requests:
            eng.submit(rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32),
                       mn, force=rng.integers(0, cfg.vocab_size, size=(mn,)).astype(np.int32))
        eng.run()
    finally:
        undo()
    return eng.logit_trace, [r.out for r in eng.requests], log


def _drift(traces) -> tuple:
    """(max |Δ| / max |plain logit|, min cosine, argmax agreements) of the
    kernel path's trace against the plain path's."""
    import numpy as np

    worst_rel, worst_cos, agree = 0.0, 1.0, 0
    for (_, _, a), (_, _, p) in zip(*traces):
        a, p = np.asarray(a, np.float64), np.asarray(p, np.float64)
        worst_rel = max(worst_rel, float(np.abs(a - p).max() / np.abs(p).max()))
        worst_cos = min(worst_cos, float((a.ravel() @ p.ravel())
                                         / (np.linalg.norm(a) * np.linalg.norm(p))))
        agree += int(np.array_equal(a.reshape(-1, a.shape[-1]).argmax(-1),
                                    p.reshape(-1, p.shape[-1]).argmax(-1)))
    return worst_rel, worst_cos, agree


class CodeLog:
    """One drive's roundings of floats to integer codes, at the stacks' two
    rounding sites: ``quant.quantize`` (the activations of ``w8a8``,
    ``w4a8`` and the BSDP formats) and ``kvcache._quant_slots`` (the int8
    and int4 caches, the plane cache's queries).  Without ``plain`` it
    records each call's value over its scale and its codes.  With
    ``plain`` (the plain run's log; the runs round in the same order) it
    counts the codes that differ from that run's, and the largest |Δ|
    between the two runs' values in steps; a code that differs by one where
    both values lie within :data:`FLIP_TOL` of the half-step between the two
    codes is a float32 rounding difference at a boundary, which ``force``
    replaces by the plain run's code.  Any other difference is counted in
    ``far``.  Used as a context manager around one drive."""

    def __init__(self, plain=None, force=False):
        self.plain, self.force = plain, force
        self.calls: list = []
        self.differ = self.forced = self.far = 0
        self.drift = self.edge = 0.0  # largest |Δ value| and |value - boundary|, in steps
        self.first = None  # the first differing code: (call, shape, its value in both runs)

    def codes(self, v, q):
        import torch

        i = len(self.calls)
        if self.plain is None:
            self.calls.append((v, q))
            return q
        self.calls.append(None)
        check(i < len(self.plain.calls) and self.plain.calls[i][1].numel() == q.numel(),
              "the kernel run rounded other tensors than the plain run")
        vp, qp = (t.reshape(-1) for t in self.plain.calls[i])
        v, flat = v.reshape(-1), q.reshape(-1)
        self.drift = max(self.drift, float((v - vp).abs().max()))
        idx = (flat != qp).nonzero()[:, 0]
        if not len(idx):
            return q
        qd, qpd = flat[idx].float(), qp[idx].float()
        mid = (qd + qpd) / 2
        dist = torch.maximum((v[idx] - mid).abs(), (vp[idx] - mid).abs())
        near = ((qd - qpd).abs() == 1) & (dist <= FLIP_TOL)
        if self.first is None:
            self.first = (i, tuple(q.shape), float(v[idx[0]]), float(vp[idx[0]]))
        self.differ += len(idx)
        self.far += int((~near).sum())
        self.edge = max(self.edge, float(dist.max()))
        if self.force:
            flat = flat.clone()
            flat[idx[near]] = qp[idx[near]]
            self.forced += int(near.sum())
        return flat.reshape(q.shape)

    def __enter__(self):
        import dataclasses

        from repro_torch.core import kvcache, quant

        quantize, slots = quant.quantize, kvcache._quant_slots

        def quantize_(x, *, bits=8, axis=-1, scale=None):
            qt = quantize(x, bits=bits, axis=axis, scale=scale)
            return dataclasses.replace(qt, data=self.codes(x / qt.scale, qt.data))

        def slots_(x, qmax, qmin):
            q, scale = slots(x, qmax, qmin)
            return self.codes(x.to(scale.dtype) / scale[..., None], q), scale

        quant.quantize, kvcache._quant_slots = quantize_, slots_
        self._undo = lambda: (setattr(quant, "quantize", quantize),
                              setattr(kvcache, "_quant_slots", slots))
        return self

    def __exit__(self, *exc):
        self._undo()


#: how near the half-step between two codes (in steps of the code) a value
#: must lie in both runs for :class:`CodeLog` to count a code that differs
#: as a float32 rounding difference at the boundary.  The two runs' values
#: differ by float32 sums taken in another order, far below this; a kernel
#: at fault moves them by a sizeable part of a step
FLIP_TOL = 1e-3


def _hold(label, run, limits, held=True, exact_routes=False, codes=False):
    """The kernel path against the plain path on one teacher-forced drive:
    ``run(impl, forced)`` → (logit trace, tokens, MoE routing log), with
    ``forced`` another run's routing log.  ``label`` names the drive.

    For a MoE config it prints the share of (token, k) routing choices on
    which the kernel path's router agrees with the plain path's (all of
    them with ``exact_routes``, the all-exact stacks) and the router's
    smallest top-k margin.  An expert choice is discrete: a rounding
    difference near a tie changes a token by a whole expert's output.  So
    where the stack has float kernels, the logits held to ``limits`` come
    from a kernel run with the plain run's expert choices forced, as its
    tokens are; the unforced run's drift is printed beside it.

    With ``codes`` the integer codes are treated the same way
    (:class:`CodeLog`): where the kernel run rounds a value to another
    code than the plain run, at a boundary within :data:`FLIP_TOL` of a
    step, the held logits come from a kernel run with those codes forced
    to the plain run's, and any code that differs farther fails.  An int4
    step is 1/7 of a row's range, so one float32 last bit at a boundary
    moves a row by a whole step.  With ``held`` False the drift is printed
    and not held to ``limits``."""
    from contextlib import nullcontext

    max_rel, min_cos = limits
    plain_log = CodeLog() if codes else None
    with plain_log or nullcontext():
        plain = run("plain", None)
    seen = CodeLog(plain_log) if codes else None
    with seen or nullcontext():
        kernel = run(None, None)
    notes = []
    if plain[2]:
        routes = [[sorted_idx for _, sorted_idx, _ in r[2]] for r in (kernel, plain)]
        check(len(routes[0]) == len(routes[1]), f"{label}: the two paths routed differently often")
        same = sum(int((a == b).sum()) for a, b in zip(*routes))
        total = sum(a.numel() for a in routes[1])
        margin = min(float(m) for r in (kernel, plain) for _, _, m in r[2])
        print(f"kernel vs plain routing ({label}): {same}/{total} (token, k) choices agree "
              f"({same / total:.6f}), smallest top-k router margin {margin:.3e}")
        check(same == total or not exact_routes,
              f"{label}: the all-exact stack routed differently ({same}/{total})")
        if not exact_routes:
            rel, cos, agree = _drift((kernel[0], plain[0]))
            print(f"kernel vs plain path, routes unforced ({label}): max rel err {rel:.3e}, min "
                  f"cosine {cos:.6f}, argmax agree {agree}/{len(plain[0])} (not held: "
                  f"{total - same} expert choices differ)")
            kernel = run(None, plain[2])
            notes.append("the plain path's expert choices")
    if codes:
        rel, cos, agree = _drift((kernel[0], plain[0]))
        print(f"kernel vs plain path, codes unforced ({label}): max rel err {rel:.3e}, min cosine "
              f"{cos:.6f}, argmax agree {agree}/{len(plain[0])}; {seen.differ} of the codes "
              f"rounded in {len(plain_log.calls)} calls differ, {seen.far} of them farther than "
              f"{FLIP_TOL} of a step from their boundary (after a first flip the runs part: "
              f"not held)")
        if seen.differ:
            forced = CodeLog(plain_log, force=True)
            with forced:
                kernel = run(None, None)
            call, shape, v, vp = forced.first
            print(f"codes forced ({label}): {forced.forced} of {forced.differ} differing codes "
                  f"lay within {FLIP_TOL} of a step of their boundary in both runs (farthest "
                  f"{forced.edge:.3e}), {forced.far} farther; largest |Δ value| {forced.drift:.3e} "
                  f"steps; the first at rounding call {call} of {len(plain_log.calls)} (a "
                  f"{list(shape)} tensor), value {v!r} against the plain run's {vp!r}")
            check(forced.far == 0, f"{label}: {forced.far} codes differ away from a rounding "
                  f"boundary with the boundary codes forced (a kernel at fault)")
            notes.append(f"{forced.forced} boundary codes forced to the plain path's")
    traces = (kernel[0], plain[0])
    kinds = [[(k, s) for k, s, _ in t] for t in traces]
    check(kinds[0] == kinds[1], f"{label}: kernel and plain paths scheduled differently")
    check(kernel[1] == plain[1], f"{label}: kernel and plain paths emitted different tokens")
    worst_rel, worst_cos, agree = _drift(traces)
    limit = (f"limit {max_rel}), min cosine {worst_cos:.6f} (limit {min_cos})" if held else
             f"printed, not held), min cosine {worst_cos:.6f}")
    print(f"kernel vs plain path ({label}{''.join(f', with {n}' for n in notes)}): "
          f"{len(traces[0])} logit vectors, max rel err {worst_rel:.3e} ({limit}, argmax agree "
          f"{agree}/{len(traces[0])}")
    check(not held or worst_rel <= max_rel and worst_cos >= min_cos,
          f"{label}: kernel path logits drift from the plain path")


def _kernel_vs_plain(engine, params, cfg, mode, cache, sched, dtype_name, limits, device,
                     exact_routes=False, schedule=CUT_SCHEDULE, held=True):
    """:func:`_hold` on one teacher-forced serve of a cut under ``schedule``."""
    arch = "" if cfg.name == "qwen3-1.7b" else f"{cfg.name}, "
    _hold(f"{arch}{mode}, cache {cache}, {sched}, {cfg.n_layers} layers, {dtype_name}",
          lambda impl, forced: _serve_cut(engine, params, cfg, mode, cache, sched, impl, device,
                                          forced=forced, schedule=schedule),
          limits, held=held, exact_routes=exact_routes)


def _cross_run(torch, qparams, cfg, impl, device):
    """One teacher-forced :class:`CrossDrive` of a cut (prompts
    :data:`CROSS_CUT_LENS`, :data:`CROSS_CUT_STEPS` decode steps, inputs
    from ``SEED``) → (logit trace, tokens, no routes)."""
    import numpy as np

    forced = np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, size=(CROSS_CUT_STEPS + 1, len(CROSS_CUT_LENS)))
    drive = CrossDrive(torch, qparams, cfg, CROSS_CUT_LENS, device, impl=impl, forced=forced)
    drive.prefill()
    for _ in range(CROSS_CUT_STEPS):
        drive.step()
    return drive.logits, [t.tolist() for t in drive.out], []


#: each kernel's entry in the ``kernels`` line: its most frequent serving shape
PICK = {"bsdp_gemv": "w_in M=1", "bsdp_gemm_fused": "w_in M=4", "bsdp_gemm": "w_in M=4",
        "dequant_matmul": "M=4 N=2048", "plane_decode_attention": "R=32 G=2 ",
        "matmul_int8": "wq M=4 N=2048 K=2048", "matmul_int4_packed": "wq M=4",
        "matmul_w16a8": "M=4 N=2048"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_line()
    t0 = time.perf_counter()

    def done(phase):
        print(f"elapsed {time.perf_counter() - t0:.1f} s after {phase}", flush=True)

    phase_toolchain(torch)
    timer = Timer(torch, device)
    rows = phase_kernels(torch, device, timer)
    del timer
    torch.cuda.empty_cache()
    done("phases 1-2 (build, kernels)")
    counts = phase_serve(torch, device, card)
    done("paths A-C, E, F")
    counts.update(phase_configs(torch, device, card))
    done("paths G-J")
    counts.update(phase_full_paths(torch, device, card, MLA_PATHS))
    done("paths K-N")
    counts.update(phase_full_paths(torch, device, card, WINDOW_SSM_PATHS))
    done("paths O-R")
    counts["S"] = phase_window(torch, device, card)
    done("path S")
    counts.update(phase_cross(torch, device, card))
    done("paths T-W")
    counts["D"] = phase_ops_path(torch, device)
    torch.cuda.empty_cache()
    phase_paths(torch, device)
    done("path D, phase 4")

    launches: dict = {}
    for path_counts in counts.values():
        for name, v in path_counts.items():
            launches[name] = launches.get(name, 0) + v
    kernels = []
    for name, prefix in PICK.items():
        row = next(r for r in rows if r["name"] == name and r["shape"].startswith(prefix)
                   and "out_int32" not in r["shape"])
        err = max(r["max_abs_err"] for r in rows if r["name"] == name)
        check(launches.get(name, 0) > 0, f"{name} never launched on its path")
        kernels.append({k: row[k] for k in ("name", "route", "source", "replaces")}
                       | {"launches": launches[name], "max_abs_err": err}
                       | {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "library_note", "shape")})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
