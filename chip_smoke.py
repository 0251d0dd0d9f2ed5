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

and, after E, two paths of path A's weights over ``paged_int4_bp_fused``
pages (8 tokens a page, 64 a slot at max_len 512):

  X  under ``fcfs`` with the default pool (slots × 64 pages), phase 3's
     mix: every token and logit row equal to A's serves, A's launches a
     decode step, the cache's bytes the analytic pool + tables + pos_ids
     count, and the block-table gathers profiled alone
  Y  under ``prefix_cache`` at slots=4 on a 176-page pool, the first
     ``Y_DEPTH`` (8) of the 28 layers: twelve
     requests behind one 256-token system prompt, the last wrapping its
     ring into the shared pages, traced (``trace=True`` and a Chrome-trace
     sink): prefix hits, copy-on-write, the shared pages' bytes intact,
     the trace valid, stats, ``kernel.dispatch`` and ``pages.*`` equal to
     their twins; an untraced rerun bitwise equal; the contiguous cache's
     agreement printed

then the two further dense configs at their full published width, depth
cut to 4 layers (below), each on path A's and path B's stack (the same
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
8 layers, on the same two stacks:

  O  mixtral-8x7b (8 of its 32 layers, 8 experts top 2, window 4096, untied head) on
     path A's stack: the experts through one grouped ``bsdp_gemm_fused``
     per projection at E = 8, K 4096 / N 28672
  P  mixtral-8x7b on path B's stack: grouped ``matmul_int8``, the head too
  Q  falcon-mamba-7b (8 of its 64 Mamba-1 layers, d_inner 8192, no attention,
     tied head) on path A's stack: ``dequant_matmul`` on in_proj, x_proj (N =
     288) and out_proj
  R  falcon-mamba-7b on path B's stack: ``matmul_int8`` on the same

and one windowed serve:

  S  mixtral-8x7b at full width, depth cut to 1 layer, path A's stack,
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

and then training (``phase_train``), which no kernel of the eight serves:

  Z  (a) qwen3-1.7b at full width and depth drawn from ``SEED`` (bf16
     layers), trained ``TRAIN_STEPS`` steps of ``make_train_step`` +
     ``adamw`` (f32 moments, remat) on ``SyntheticLM`` batches of 4 x 1024
     tokens, each step's loss, device ms (CUDA events), tokens/s, share of
     the bf16 bound and peak allocation printed, the loss finite and falling,
     a 2-microbatch step on the first batch held to the reference's
     tolerance against the 1-microbatch step; (b) a 2-layer cut in float32,
     one step on the card against the same step on the CPU (loss, grad norm,
     every gradient leaf and every updated leaf within stated bounds); (c)
     the 2-layer cut in bf16 with int8 moments: a step repeated from one
     state compared bit for bit, a state saved through ``AsyncCheckpointer``
     and restored bit for bit, the trainer's restart after ``FailureSim``
     (its step history the reference trainer's pattern, its final parameters
     an uninterrupted run's to the bit); none of (a)-(c) may reach a kernel
     wrapper; (d) (a)'s trained weights converted to path A's stack and
     served as path A is, A's exact launches a decode step (these launches
     stay out of the kernels line)

and then tensor-parallel serving (``phase_tp``, after the dry run), each
part in processes of its own spawned with ``torch.multiprocessing``:

  (a) NCCL at one rank on cuda:0: all-reduce SUM (int32, float32), MAX
      and all-gather on CUDA tensors, each checked, the group destroyed
  (b) two gloo ranks on the one card (NCCL refuses two ranks on one
      device), a ``(data=1, model=2)`` ``DeviceMesh``, both ranks on
      cuda:0: qwen3-1.7b at full width and ``TP_DEPTH`` (8) of its 28
      layers on path B's and path A's stacks at tp = 2, then (``TP_SERVES``)
      deepseek-v2-lite-16b at full width and 4 layers (its dense layer 0 and
      3 MoE layers: MLA on a rank's 8 of 16 heads over the whole latent, 32
      of 64 experts a rank, the shared experts column- then row-parallel) on
      B's and A's stacks, and mixtral-8x7b at full width and 1 layer (4 of 8
      experts a rank, the 4096 window) on B's, 4 requests of 16-128 tokens,
      16 new tokens each,
      slots=4, ``fcfs``, each rank's shards placed from a host copy of the
      converted weights (``transfer.place_shard``), and the same mix served
      at tp = 1 in the rank's process on the same weights, tp = 2
      teacher-forced to tp = 1's tokens: B bit for bit or, where a float op
      outside the kernels parts the two, that first op named (``OpLog``) and
      the rows within ``PATH_LIMITS``; A's bf16 drift printed with its first
      differing op, and A in float32 with the int4 boundary codes forced to
      tp = 1's (a rank holds its share of the heads' and the experts' codes:
      ``ShardCodeLog``) within ``PATH_LIMITS``; a MoE router choice that
      differs from tp = 1's counted, and that run then held with tp = 1's
      choices forced (``_record_routes``); every rank's tokens equal;
      each rank's resident bytes equal to the dry run's count of a rank's
      (``dryrun.rank_bytes``: the meta trees cut by the formats'
      ``data_axes`` and ``cache_pspecs``); the serve's collectives, by kind
      in count and raw bytes, equal to the dry run's count of its model
      calls (``dryrun.serve_collectives``, ``ModelCallLog``); each kernel's
      launches a decode step equal to tp = 1's; a decode step profiled on
      each rank, its busy ms over the dry run's step bound at tp = 2
      (collective term included) and the collectives' host time printed.  Phase 2 times the kernels at
      the shard shapes (``TP_PROJ``; the row-parallel wo and w_out through
      ``matmul_int8``'s raw int32 route; ``_rows_tp_moe``: the grouped
      launches over a rank's 32 and 4 experts, MLA's wq on 8 heads).  The tp = 2 runs are no speed
      result: two processes time-share one card

and then training over a mesh (``phase_train_mesh``, after the tp phase),
two spawned gloo ranks on cuda:0, which no kernel of the eight serves:

  (a) qwen3-1.7b at full width, depth cut to ``MESH_DEPTH``, over a
      ``(data=2, model=1)`` mesh with FSDP at path Z's settings, 3 steps:
      each step's ms (CUDA events), tokens/s, each rank's peak allocation
      against its shard of the analytic train state, the collectives'
      counts and host ms; every step's collectives, by kind in count and
      raw bytes, equal to ``dryrun.train_step_collectives``' count, and
      each rank's parameter shards and optimizer state to
      ``dryrun.rank_bytes``'; every replicated leaf bitwise equal on both
      ranks after each step; the first loss the one-rank loss on the same
      weights and batch within path Z's bf16 limit
  (b) the 2-layer float32 cut over FSDP (data=2), TP (model=2) and the
      int8 pod hop (pod=2) against (data=1, model=1) on the same weights
      and batches: loss and gradients within 1e-5 of each leaf's largest,
      the parameters after 2 steps likewise but for Adam's sign moves
      (counted), the hop's output the quantized global gradient exactly,
      a whole step's collectives equal to the dry run's count
  (c) the cut's trainer at data=2 failing before step 3 and restarting
      from its step-2 checkpoint, bitwise equal to an uninterrupted run,
      and restored on ``plan_elastic_mesh(1, model_parallel=1)``'s one
      device within (b)'s limits of an uninterrupted run there
  (d) ``pipeline_apply`` at pipe=2 over the cut's two layers against the
      sequential stack

and then the example twins (``phase_examples``): ``repro_torch.examples.
quickstart`` (train the reduced qwen3, convert to ``w8a8``, prefill and
decode) and ``repro_torch.examples.serve_quantized`` (every weight format,
the mixed policies with their cache suffixes, the traced all-fused row) on
the card, no plain version on CUDA.

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
plain version ran on the card and its resident bytes equal the dry run's
twins to the byte (``ServeEngine.resident_bytes()`` against
``dryrun.analytic_weight_bytes`` and ``dryrun.analytic_cache_bytes``;
where the latter raises, for the Mamba and VLM configs Q, R, T and U, or
leaves the context K/V out, for V and W, against the bytes of
``model.init_cache`` on the meta device; T-W hold the caches their
``model.prefill`` built).  Then the dry-run phase (after Z): each profiled
path's decode step against its analytic traffic and H100 step bound
(``dryrun.analytic_traffic``, ``hlo_stats.roofline_terms``, a
``ShapeCell`` of the path's slots and max_len), busy ms over the bound;
``dryrun.analyze_cell`` for all 33 arch × shape cells under path A's
stack, one line each, then at the pod and multi-pod meshes and
jamba-1.5-large-398b's decode cell on 4 and 8 cards (a rank's bytes, fits
80 GB, wire bytes or the check that raises); ``hlo_stats.HW``'s HBM bytes
against the card's.  Phase 4 compares the kernel path with the plain path on a 2-layer
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
made to keep the run well inside the 1200 s it may take: paths G-J serve
their configs at 4 layers and K-R at 8 (``CONFIG_DEPTH``; on one H100, G-N
at full depth took ~380 s of a 1,063 s run with O-S, G-J at 8 layers 30 s,
and O-R at full depth ~100-157 s of runs up to 897 s), and S serves
mixtral-8x7b at 1 of its
32 layers (its 4,160-token prefill and its plain-path comparisons at
full depth would take many minutes; at 2 layers S took ~175 s of runs
up to 1,001 s); the mesh phase trains qwen3-1.7b at 4 of its 28 layers
(``MESH_DEPTH``: gloo's collectives through the host set its step time,
12.4-30.4 s a step at 28 layers, the phase 240.8 s).  A cut layer
launches what a full-depth layer does, at the same shapes.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit; the one before that a JSON object with every
kernel's launches, error against its plain version and times.
"""

from __future__ import annotations

import json
import math
import os
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
#: per decode step at slots=4 on 4 layers: on A's stack 2 BSDP GEMMs, 4
#: W8A16 projections and one plane attention a layer, the head left in bf16;
#: on B's 6 W8A8 projections a layer and the head)
CONFIG_PATHS = {
    "G": ("starcoder2-3b", "A",
          {"bsdp_gemm_fused": 8, "dequant_matmul": 16, "plane_decode_attention": 4}),
    "H": ("starcoder2-3b", "B", {"matmul_int8": 25}),
    "I": ("qwen1.5-32b", "A",
          {"bsdp_gemm_fused": 8, "dequant_matmul": 16, "plane_decode_attention": 4}),
    "J": ("qwen1.5-32b", "B", {"matmul_int8": 25}),
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
#: paths G-J serve their configs at 4 layers (8 before the tp phase took its
#: time) and K-R at 8 (deepseek-v2-lite-16b's dense layer 0 and 7 MoE
#: layers), so that the run stays well inside its time limit: at full depth
#: G-N took ~380 s of a 1,063 s run on one H100, O-R ~100-157 s of runs up
#: to 897 s; at 8 layers G-J 30 s.  K and L stay at 8: minicpm3-4b's
#: conversion peaks while its 752 MB float32 embedding is drawn, whatever
#: the depth, and at 4 layers that peak (1.88 GB) exceeds draw_converted's
#: bound (resident + 2 x the largest layer leaf + slack: 1.81 GB).  A layer's
#: shapes, and so each kernel launch, are those of the full depth.
CONFIG_DEPTH = {"starcoder2-3b": 4, "qwen1.5-32b": 4, "minicpm3-4b": 8,
                "deepseek-v2-lite-16b": 8, "mixtral-8x7b": 8, "falcon-mamba-7b": 8}
#: the mesh phase's (a) trains qwen3-1.7b at full width and this many of its 28
#: layers (None: all), its ranks' gloo collectives through the host setting
#: the time: at 28 layers a step took 12.4-30.4 s by CUDA events (11.6-17.0 s
#: of collective host time) and the phase 240.8 s of its 150 s budget, at 8
#: layers 4.3-23.1 s and 201.7 s (NVIDIA H100 80GB HBM3, 700.00 W)
MESH_DEPTH = 4


def config_for(arch: str):
    """The config a serving path of G-R serves: the registry's, cut to
    :data:`CONFIG_DEPTH` where it names the arch."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg.scaled(n_layers=CONFIG_DEPTH[arch]) if arch in CONFIG_DEPTH else cfg


#: the sliding-window MoE and Mamba configs at full width, depth cut by
#: CONFIG_DEPTH: path → (arch, the stack's path, kernels that must launch by
#: slots, launches per decode step at slots=4 on 8 layers).  On A's stack:
#: mixtral-8x7b's 4 W8A16 attention projections, 2 grouped BSDP GEMMs (w_in,
#: w_out over 8 experts) and one plane attention a layer, the head left in
#: bf16; falcon-mamba-7b's 3 W8A16 projections a layer (in_proj, x_proj,
#: out_proj; its head tied).  On B's stack the same projections through
#: ``matmul_int8``, mixtral's head too.
WINDOW_SSM_PATHS = {
    "O": ("mixtral-8x7b", "A",
          {4: ("bsdp_gemm_fused", "dequant_matmul", "plane_decode_attention"),
           1: ("bsdp_gemv", "bsdp_gemm_fused", "dequant_matmul", "plane_decode_attention")},
          {"dequant_matmul": 32, "bsdp_gemm_fused": 16, "plane_decode_attention": 8}),
    "P": ("mixtral-8x7b", "B", {4: ("matmul_int8",), 1: ("matmul_int8",)},
          {"matmul_int8": 49}),
    "Q": ("falcon-mamba-7b", "A", {4: ("dequant_matmul",), 1: ("dequant_matmul",)},
          {"dequant_matmul": 24}),
    "R": ("falcon-mamba-7b", "B", {4: ("matmul_int8",), 1: ("matmul_int8",)},
          {"matmul_int8": 24}),
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


#: the paged paths: path A's weights over the paged lifting of its cache,
#: path → (scheduler, ``page_pool_pages``; None: the default slots × 64)
PAGED_CACHE = "paged_int4_bp_fused"
PAGED_PATHS = {"X": ("fcfs", None), "Y": ("prefix_cache", 176)}


def path_spec(path: str) -> tuple:
    """(weights, cache, kernels that must launch by slots, launches a decode
    step at slots=4) of any serving path (Z serves its trained weights on
    path A's)."""
    if path in PATHS:
        return PATHS[path]
    if path == "Z":
        return PATHS["A"]
    if path in PAGED_PATHS:
        mode, _, must, per_step = PATHS["A"]
        return mode, PAGED_CACHE, must, per_step
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
    _rows_tp(torch, device, gen, timer, rows, min_m)
    _rows_tp_moe(torch, device, gen, timer, rows, min_m)
    dequant_accuracy(torch, device, gen)
    for row in rows:
        print("kernel " + json.dumps(row))
    one = torch.zeros(1, device=device)
    print(f"launch floor: {timer.ms(lambda: one.zero_()):.5f} ms (median of a one-element "
          f"zero_() under the same timer, {card_line()})")
    step_gaps(rows)
    return rows


#: qwen3-1.7b's projections as one rank of tp = 2 holds them: (K, N) of the
#: column-parallel wq, wk / wv and w_in (N halved) and of the row-parallel wo
#: and w_out (K halved; int8 formats only: the bit-plane w_out stays whole)
TP_PROJ = {"wq": (2048, 1024), "wk": (2048, 512), "w_in": (2048, 6144), "wo": (1024, 2048),
           "w_out": (3072, 2048)}


def _rows_tp(torch, device, gen, timer, rows, min_m):
    """The tp phase's shard shapes at slots=4: ``matmul_int8`` at the
    column-parallel projections and through its raw int32 route (the
    row-parallel ones, whose partial sums are all-reduced before the
    epilogue), ``dequant_matmul`` (bf16 x) at wq, wk and wo, the BSDP
    kernels at w_in's half, plane attention over 8 of the 16 heads."""
    from repro_torch.kernels import gemv_int8

    for layer in ("wq", "wk", "w_in"):
        _int8_rows_at(torch, device, gen, timer, rows, min_m, f"tp2 {layer}", *TP_PROJ[layer],
                      (4,))
    for layer in ("wo", "w_out"):
        k, n = TP_PROJ[layer]
        w, x = _int8(torch, gen, device, k, n), _int8(torch, gen, device, 4, k)
        ones_m = torch.ones((4, 1), device=device)
        ones_n = torch.ones((1, n), device=device)
        got = gemv_int8.matmul_int8(x, w, ones_m, ones_n, out_int32=True)
        err = _int_err(got, gemv_int8.matmul_int8_plain(x, w, ones_m, ones_n, out_int32=True))
        check(err == 0, f"matmul_int8 tp2 {layer} out_int32: not bit-exact (max err {err})")
        lib, note = _int_mm(torch, x, w, min_m)
        check(torch.equal(got, lib()[:4]), f"matmul_int8 tp2 {layer}: != torch._int_mm")
        _row(rows, "matmul_int8", gemv_int8.KERNEL, f"tp2 {layer} M=4 N={n} K={k} out_int32",
             err, timer, lambda: gemv_int8.matmul_int8(x, w, ones_m, ones_n, out_int32=True),
             timer.ms(lambda: gemv_int8.matmul_int8_plain(x, w, ones_m, ones_n,
                                                          out_int32=True)),
             bound(4 * k + k * n + 4 * 4 * n, 2 * 4 * n * k / INT8_OPS_PER_S), timer.ms(lib),
             note or "torch._int_mm")
    for layer in ("wq", "wk", "wo"):
        _dequant_rows_at(torch, device, gen, timer, rows, f"tp2 {layer} ", *TP_PROJ[layer],
                         (torch.bfloat16,), (4,))
    _bsdp_rows_at(torch, device, gen, timer, rows, min_m, "tp2 w_in", *TP_PROJ["w_in"],
                  {"bsdp_gemv": (1,), "bsdp_gemm_fused": (4,)})
    _attention_decode_row(torch, device, gen, timer, rows, 4, 4, 2)


#: deepseek-v2-lite-16b's MLA query projection as one rank of tp = 2 holds it:
#: 8 of 16 heads of 128 + 64 columns
TP_MLA_WQ = (2048, 1536)


def _rows_tp_moe(torch, device, gen, timer, rows, min_m):
    """The MLA and MoE layers' shard shapes at tp = 2, decode at slots=4
    (capacity 1 a row, so 4 rows an expert): deepseek-v2-lite-16b's 32
    experts a rank (w_in, w_out; ``bsdp_gemv`` at M = 1, ``bsdp_gemm_fused``
    and ``matmul_int8`` at M = 4), mixtral-8x7b's 4 (w_in on
    ``matmul_int8``), and deepseek's wq on 8 heads (``matmul_int8``,
    ``dequant_matmul`` with bf16 x)."""
    _rows_grouped(torch, device, gen, timer, rows, e=EXPERTS // TP_WORLD, proj=EXPERT_PROJ,
                  grouped_m={"bsdp_gemv": (1,), "bsdp_gemm_fused": (4,), "matmul_int8": (4,)},
                  prefix="tp2 ")
    _rows_grouped(torch, device, gen, timer, rows, e=MIXTRAL_EXPERTS // TP_WORLD,
                  proj={"w_in": MIXTRAL_EXPERT_PROJ["w_in"]}, grouped_m={"matmul_int8": (4,)},
                  prefix="tp2 mixtral ")
    _int8_rows_at(torch, device, gen, timer, rows, min_m, "tp2 mla wq", *TP_MLA_WQ, (4,))
    _dequant_rows_at(torch, device, gen, timer, rows, "tp2 mla wq ", *TP_MLA_WQ,
                     (torch.bfloat16,), (4,))


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
    arch, stack, _, _ = WINDOW_SSM_PATHS[path]
    layers = config_for(arch).n_layers
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


def cache_twin(cfg, slots: int, max_len: int, num_pages=None) -> tuple[int, str]:
    """The dry run's count of the cache a ``slots``-slot engine at
    ``max_len`` holds, and how it was made: ``dryrun.analytic_cache_bytes``
    over the ring the engine allocates (``min(window, max_len)`` for a
    windowed config), less the pages a capped pool (``num_pages``) leaves
    out, each page its inner format's slot bytes × ``page_size``; where
    that count raises (a Mamba or cross-attention layer), the bytes of
    ``model.init_cache`` on the meta device."""
    from repro_torch.core import kvcache
    from repro_torch.launch import dryrun
    from repro_torch.models import attention
    from repro_torch.models import model as model_lib

    ring = attention.cache_len_for(cfg, max_len)
    try:
        want = dryrun.analytic_cache_bytes(cfg, slots, ring)
    except NotImplementedError:
        caches = model_lib.init_cache(cfg, slots, max_len, device="meta")
        return kvcache.cache_resident_bytes(caches), "init_cache on the meta device"
    if num_pages is None:
        return want, "analytic_cache_bytes"
    fmt = kvcache.format_for(cfg)
    check(cfg.attn_type != "mla", "a capped page pool is counted for K and V channels only")
    page = fmt.inner.slot_bytes((cfg.n_kv_heads,), cfg.d_head, cfg.dtype) * fmt.page_size
    unused = slots * fmt.pages_per_slot(ring) - num_pages
    return (want - 2 * cfg.n_layers * unused * page,
            f"analytic_cache_bytes less {unused} pages of {page} B a channel and layer")


def hold_resident(eng, label: str) -> dict:
    """Hold a live engine's ``resident_bytes()`` to the dry run's twins, to
    the byte: the weights to ``dryrun.analytic_weight_bytes(cfg, mode)``,
    the cache to :func:`cache_twin`.  Returns the engine's count."""
    from repro_torch.launch import dryrun

    got = eng.resident_bytes()
    want_w = dryrun.analytic_weight_bytes(eng.cfg, eng.mode)
    pool = eng.page_pool
    capped = pool is not None and pool.num_pages != eng.slots * eng._npp
    want_c, how = cache_twin(eng.cfg, eng.slots, eng.max_len,
                             pool.num_pages if capped else None)
    print(f"{label}: resident weights {got['weights']} B (analytic_weight_bytes "
          f"{want_w} B), cache {got['cache']} B ({how} {want_c} B)")
    check(got["weights"] == want_w,
          f"{label}: resident weights {got['weights']} B != the dry run's {want_w} B")
    check(got["cache"] == want_c, f"{label}: cache {got['cache']} B != the dry run's {want_c} B")
    return got


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
    from repro_torch.launch import dryrun
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
        got, want = engine.resident_bytes(qparams[path]), dryrun.analytic_weight_bytes(cfg, mode)
        print(f"path {path}: residency convert ({mode}): {time.perf_counter() - t0:.2f} s, "
              f"{got} B resident (analytic_weight_bytes {want} B)")
        check(got == want, f"path {path}: resident bytes {got} != the dry run's {want}")
    del params
    torch.cuda.empty_cache()
    counts = {}
    for path in PATHS:
        served = [] if path == "A" else None
        counts[path] = _serve_path(torch, device, card, engine, qparams[path], cfg, path,
                                   keep=served)
        if path == "A":
            counts["E"] = phase_chunked(torch, device, card, engine, qparams[path], cfg)
            counts["X"] = phase_paged(torch, device, card, engine, qparams[path], cfg, served)
            del served
            counts["Y"] = phase_prefix(torch, device, card, engine, qparams[path], cfg)
        if path == "B":
            counts["F"] = phase_int8_cache(torch, device, card, engine, qparams[path], cfg)
        phase_profile(torch, device, engine, qparams.pop(path), cfg, card, path)
        torch.cuda.empty_cache()
    return counts


def draw_converted(torch, device, cfg, path, header, largest, what, prepare=None):
    """``path``'s weights for ``cfg``, drawn from ``SEED`` and converted leaf
    by leaf (``engine.materialize_converted``), then ``prepare(params)`` if
    given; resident bytes held to ``dryrun.analytic_weight_bytes`` to the
    byte and the peak allocation to resident + 2 x ``largest`` (``what``:
    the largest float32 leaf drawn whole) + :data:`STREAM_SLACK_BYTES`."""
    from repro_torch.launch import dryrun
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
    got, want = engine.resident_bytes(qparams), dryrun.analytic_weight_bytes(cfg, mode)
    peak = torch.cuda.max_memory_allocated() - base
    limit = got + 2 * largest + STREAM_SLACK_BYTES
    print(f"path {path}: {header} drawn and converted leaf by leaf ({mode}): "
          f"{time.perf_counter() - t0:.2f} s, {got} B resident (analytic_weight_bytes {want} "
          f"B), peak allocated {peak} B (bound {limit} B = resident + "
          f"2 x {largest} B, {what}, + {STREAM_SLACK_BYTES} B)")
    check(got == want, f"path {path}: resident bytes {got} != the dry run's {want}")
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


def _serve_path(torch, device, card, engine, qparams, cfg, path, keep=None) -> dict:
    """Phase 3's mix on ``path``; returns kernel → launches, and appends
    each serve's (engine, its launches) to ``keep`` if given."""
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
        if keep is not None:
            keep.append((eng, ran))
        hold_resident(eng, f"path {path} slots={slots}")
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


#: path → (config, weights, slots, max_len, wall ms, device-busy ms) of its
#: profiled decode step (:func:`phase_profile`, the cross paths), which the
#: dry-run phase sets beside the step's analytic bound
DECODE_PROFILES: dict = {}


def phase_profile(torch, device, engine, qparams, cfg, card, path, steps: int = 3):
    """Where a decode step's time goes on one path: the launches of one
    decode step at slots=4 (checked against the path's count), then
    :func:`profile_steps` over a few steady decode steps.  Returns the
    engine."""
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
    DECODE_PROFILES[path] = (eng.cfg, mode, 4, 512) + profile_steps(
        torch, eng.step, steps, f"path {path} profile decode step (slots=4, "
        f"{cfg.n_layers} layers, {card}, under the profiler)")
    return eng


def profile_steps(torch, step, steps: int, label: str) -> tuple:
    """``torch.profiler`` over ``steps`` calls of ``step`` (an engine step,
    or a decode step of the cross paths): wall time, device-busy
    time (the sum of the device-side kernel and copy durations), idle share,
    device operations per step and the kernels taking most device time.
    Returns (wall ms, busy ms) a step."""
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
    return wall_ms, busy_ms


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
        hold_resident(eng, f"path E {sched}")
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


# ---------------------------------------------------------------------------
# Paths X and Y: path A's stack over paged bit-plane pages
# ---------------------------------------------------------------------------


def profile_gather(torch, eng, steps: int, card) -> None:
    """The block-table gathers of one decode step alone (K and V of every
    layer, as the fused read takes them) on the engine's live caches, under
    :func:`profile_steps`: their device time and operations a step."""
    fmt = eng._fmt

    def gathers():
        for layer in eng.caches:
            for prefix in ("k", "v"):
                fmt._gather(fmt.channel(layer, prefix))

    profile_steps(torch, gathers, steps, f"path X profile gather alone ({len(eng.caches)} "
                  f"layers x K and V, slots={eng.slots}, {card}, under the profiler)")


def phase_paged(torch, device, card, engine, qparams, cfg, served_a) -> dict:
    """Path X: path A's weights over ``paged_int4_bp_fused`` pages under
    ``fcfs``, the default pool (slots × 64 pages), phase 3's mix from the
    same seed.  Each serve must equal path A's serve of the same requests
    (``served_a``) bit for bit, every token and every logit row, with the
    same launches and no plain version on the card; the cache's bytes (the
    default pool, its block tables and pos_ids) are held to the dry run's
    in :func:`_serve_path`.  Then the decode-step
    profile, launches per step equal to A's, and the gathers' share of it
    alone.  Returns the kernel launches."""
    import numpy as np

    served: list = []
    counts = _serve_path(torch, device, card, engine, qparams, cfg, "X", keep=served)
    for (eng, ran), (ref, ran_a), slots in zip(served, served_a, (4, 1)):
        check(ran == ran_a, f"path X slots={slots}: launches {ran} != path A's {ran_a}")
        check([r.out for r in eng.requests] == [r.out for r in ref.requests],
              f"path X slots={slots}: tokens differ from path A's")
        check([(k, s) for k, s, _ in eng.logit_trace] == [(k, s) for k, s, _ in ref.logit_trace]
              and all(np.array_equal(a, b) for (_, _, a), (_, _, b)
                      in zip(eng.logit_trace, ref.logit_trace)),
              f"path X slots={slots}: logits differ from path A's")
        print(f"path X slots={slots}: {len(eng.logit_trace)} logit rows and "
              f"{sum(len(r.out) for r in eng.requests)} tokens bit-identical to path A's; "
              f"cache {eng.resident_bytes()['cache']} B (path A's "
              f"{ref.resident_bytes()['cache']} B), pages {eng.stats().pages}")
    del served
    eng = phase_profile(torch, device, engine, qparams, cfg, card, "X")
    profile_gather(torch, eng, 3, card)
    return counts


#: path Y's mix: one system prompt of Y_SHARED tokens (32 pages) before
#: every request; Y_REQUESTS with 16-64 distinct tokens after it and 32 new
#: tokens each, then one with Y_LONG distinct tokens and Y_LONG_NEW new
#: tokens, whose positions run to 551 and wrap its ring into pages 0-4,
#: which the prefix index still holds.  All are submitted at step 0.
Y_SHARED, Y_REQUESTS, Y_LONG, Y_LONG_NEW = 256, 11, 200, 96
#: path Y's layers: the first Y_DEPTH of path A's converted tree (its three
#: serves of 211 steps are host-bound: at all 28 layers they took ~130 s)
Y_DEPTH = 8


def _prefix_mix(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    shared = rng.integers(0, cfg.vocab_size, size=Y_SHARED).astype(np.int32)
    lens = [int(n) for n in rng.integers(16, 65, size=Y_REQUESTS)] + [Y_LONG]
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)])
               for n in lens]
    return shared, prompts, [32] * Y_REQUESTS + [Y_LONG_NEW]


def _serve_prefix(engine, qparams, cfg, device, cache, prompts, max_news, trace=False,
                  on_register=None):
    """One serve of path Y's mix on path A's weights and ``cache`` under
    ``prefix_cache`` (slots=4, max_len 512, the pool of PAGED_PATHS["Y"]
    for a paged cache).  Returns (engine, wall ms a step, most slots live at
    once, uid → the first token's logits)."""
    import numpy as np

    kw = {"page_pool_pages": PAGED_PATHS["Y"][1]} if cache.startswith("paged") else {}
    eng = engine.ServeEngine(qparams, cfg, mode=PATHS["A"][0], cache_format=cache,
                             scheduler="prefix_cache", slots=4, max_len=512, trace=trace,
                             trace_logits=True, device=device, **kw)
    first, emit, register = {}, eng._emit, eng._register_prefix

    def emit_first(req, row):
        if not req.out:
            first[req.uid] = np.array(row)
        emit(req, row)

    def registering(slot, req):
        register(slot, req)
        if on_register is not None:
            on_register(eng, slot)

    eng._emit, eng._register_prefix = emit_first, registering
    reqs = [eng.submit(p, n) for p, n in zip(prompts, max_news)]
    live, t0 = 0, time.perf_counter()
    while eng.step():
        live = max(live, sum(r is not None for r in eng.active))
    wall_ms = (time.perf_counter() - t0) * 1e3 / eng.step_index
    for req, n in zip(reqs, max_news):
        check(req.state == "done" and len(req.out) == n, f"path Y: request {req.uid} unfinished")
        check(all(0 <= t < cfg.vocab_size for t in req.out), "token out of vocab")
    for kind, _, logits in eng.logit_trace:
        check(bool(np.isfinite(logits).all()), f"path Y: {kind} logits not finite")
    return eng, wall_ms, live, first


def phase_prefix(torch, device, card, engine, qparams, cfg) -> dict:
    """Path Y: path A's weights over ``paged_int4_bp_fused`` pages under
    ``prefix_cache``, slots=4, a pool of 176 pages (two private reservations
    of 64, or four attached slots: 32 shared + 4 × 32), on :func:`_prefix_mix`.
    Traced (``trace=True`` and a Chrome-trace sink), it must hold: (a) 10
    prefix hits saving 2,560 tokens (all but the two requests that prefill
    the shared prompt first), a copy-on-write, the pool's peak within 176
    and 4 slots live at once; (b) the 32 indexed pages' bytes in every
    layer's K and V pool, taken when the first request registers them,
    unchanged after the run; (c) the trace valid under
    ``repro_torch.obs.validate``; (d) the per-request stats rebuilt from the
    events equal to ``stats()``; (e) the ``kernel.dispatch`` totals equal to
    the launch counts; (f) the ``pages.*`` counters equal to
    ``stats().pages`` and the last ``bytes.cache`` gauge to the cache's
    bytes.  Run again with no sink, its tokens and logits must equal the
    traced run's bit for bit (wall ms a step of both: obs's overhead).  The
    contiguous ``int4_bp_fused`` cache under ``prefix_cache`` serves the
    same mix: the share of equal tokens and each request's first-logit
    distance are printed, not held (an attached request reads K/V its donor
    computed at another M).  Served on the first :data:`Y_DEPTH` layers.
    Returns the traced run's kernel launches."""
    import json
    import os
    import tempfile

    import numpy as np

    from repro_torch import obs
    from repro_torch.kernels import ops

    cfg = cfg.scaled(n_layers=Y_DEPTH)
    qparams = dict(qparams, layers=qparams["layers"][:Y_DEPTH])
    shared, prompts, max_news = _prefix_mix(cfg)
    snap: dict = {}

    def on_register(eng, slot):
        if snap:
            return
        pages = torch.from_numpy(eng.prefix_index.match(shared)).to(device)
        check(len(pages) == Y_SHARED // 8, f"path Y: {len(pages)} indexed prefix pages")
        snap["pages"] = pages
        snap["bytes"] = [{k: layer[k][pages].clone() for k in ("k", "k_scale", "v", "v_scale")}
                         for layer in eng.caches]

    obs.clear_sinks()
    obs.reset_metrics()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        chrome = obs.register_sink(obs.ChromeTraceSink(path))
        torch.cuda.synchronize()
        ops.reset_counts()
        eng, wall_traced, live, first_paged = _serve_prefix(
            engine, qparams, cfg, device, PAGED_CACHE, prompts, max_news,
            trace=obs.RingSink(capacity=1 << 22), on_register=on_register)
        torch.cuda.synchronize()
        launches, plain = ops.launch_counts(), ops.plain_cuda_counts()
        timeline = eng.timeline()
        counters = {name: obs.counter_total(name) for name in (
            "pages.alloc", "pages.free", "pages.cow", "pages.evict", "pages.prefix_hit",
            "pages.prefix_tokens_saved")}
        bytes_gauge = obs.gauge_value("bytes.cache")
        n_records = len(chrome)
        chrome.close()
        obs.clear_sinks()
        obs.reset_metrics()
        with open(path) as f:
            valid = obs.validate_chrome(json.load(f))
    ran = {k: v for k, v in launches.items() if v}
    st = eng.stats()
    pages = st.pages
    print(f"path Y serve (prefix_cache, slots=4, pool {pages['num_pages']} pages, traced) on "
          f"{card}: {st.total_tokens} tokens, {st.tok_per_s:.2f} tok/s, TTFT p50 "
          f"{st.percentile('ttft_s', 50) * 1e3:.2f} ms p95 {st.percentile('ttft_s', 95) * 1e3:.2f}"
          f" ms, TPOT p50 {st.percentile('tpot_s', 50) * 1e3:.2f} ms, steps {st.steps}, "
          f"{live} slots live at most, launches {ran}; pages {pages}")
    check(all(v == 0 for v in plain.values()), f"path Y: a plain version ran on the card: {plain}")
    for name in PATHS["A"][2][4]:
        check(launches[name] > 0, f"path Y: {name} never launched")
    # (a)
    check(pages["prefix_hits"] == Y_REQUESTS - 1
          and pages["prefix_tokens_saved"] == (Y_REQUESTS - 1) * Y_SHARED,
          f"path Y: prefix hits {pages['prefix_hits']}, tokens saved "
          f"{pages['prefix_tokens_saved']}")
    check(pages["cow_copies"] >= 1, "path Y: no copy-on-write")
    check(pages["peak_in_use"] <= pages["num_pages"] and live == 4,
          f"path Y: peak {pages['peak_in_use']} pages, {live} slots live at most")
    # (b)
    same = all(torch.equal(layer[k][snap["pages"]], t0)
               for layer, before in zip(eng.caches, snap["bytes"]) for k, t0 in before.items())
    print(f"path Y: the {len(snap['pages'])} indexed prefix pages of {len(eng.caches)} layers' "
          f"K and V pools bit-identical after the run: {same}")
    check(same, "path Y: an indexed prefix page changed (a write missed its copy)")
    # (c)
    print(f"path Y trace: {n_records} records, valid: {valid['events']} events, "
          f"{valid['spans']} spans, {valid['counters']} counter samples, "
          f"{valid['instants']} instants")
    # (d)
    check(obs.request_stats_from_events(timeline) == st.requests,
          "path Y: the request stats rebuilt from the trace differ from stats()")
    # (e)
    dispatched: dict = {}
    for key, n in obs.dispatch_table(timeline).items():
        labels = dict(key)
        check(labels["impl"] == "cuda", f"path Y: a plain dispatch {labels}")
        dispatched[labels["kernel"]] = dispatched.get(labels["kernel"], 0) + n
    check(dispatched == ran, f"path Y: kernel.dispatch {dispatched} != launches {ran}")
    # (f)
    want = {"pages.alloc": pages["total_allocated"], "pages.free": pages["total_freed"],
            "pages.cow": pages["cow_copies"], "pages.evict": pages["evictions"],
            "pages.prefix_hit": pages["prefix_hits"],
            "pages.prefix_tokens_saved": pages["prefix_tokens_saved"]}
    check(counters == want, f"path Y: pages counters {counters} != stats {want}")
    cache_bytes = hold_resident(eng, "path Y")["cache"]
    check(bytes_gauge == cache_bytes, f"path Y: bytes.cache {bytes_gauge} != {cache_bytes}")
    summary = obs.summarize_spans(timeline)
    print("path Y spans (host ms, p50 / p95 / count): " + ", ".join(
        f"{name.split('.')[1]} {summary[name]['p50_s'] * 1e3:.3f} / "
        f"{summary[name]['p95_s'] * 1e3:.3f} / {summary[name]['count']}"
        for name in ("engine.step", "engine.plan", "engine.reserve", "engine.prefill",
                     "engine.cow", "engine.decode", "engine.complete") if name in summary))
    traced = eng
    del timeline, eng
    untraced, wall_plain, _, _ = _serve_prefix(engine, qparams, cfg, device, PAGED_CACHE,
                                               prompts, max_news)
    check([r.out for r in untraced.requests] == [r.out for r in traced.requests]
          and all(np.array_equal(a, b) for (_, _, a), (_, _, b)
                  in zip(untraced.logit_trace, traced.logit_trace))
          and len(untraced.logit_trace) == len(traced.logit_trace),
          "path Y: the untraced run differs from the traced run")
    print(f"path Y obs overhead on {card}: wall {wall_traced:.2f} ms/step traced, "
          f"{wall_plain:.2f} ms/step with no sink ({traced.step_index} steps each); tokens and "
          f"logits bitwise equal")
    del untraced
    ring, _, _, first_ring = _serve_prefix(engine, qparams, cfg, device, "int4_bp_fused",
                                           prompts, max_news)
    pairs = list(zip(traced.requests, ring.requests))
    equal = sum(a == b for x, y in pairs for a, b in zip(x.out, y.out))
    dist = [float(np.abs(first_paged[x.uid] - first_ring[y.uid]).max()
                  / np.abs(first_ring[y.uid]).max()) for x, y in pairs]
    print(f"path Y against the contiguous int4_bp_fused cache under prefix_cache (printed, not "
          f"held): {equal} of {sum(max_news)} tokens equal ({equal / sum(max_news):.4f}); "
          f"first logits max |d| / max |logit| by request {['%.3g' % d for d in dist]}; "
          f"contiguous run {ring.step_index} steps, {ring.stats().tok_per_s:.2f} tok/s")
    return ran


def phase_int8_cache(torch, device, card, engine, qparams, cfg) -> dict:
    """Path F: ``w8a8`` weights with the ``int8`` cache under ``sjf`` at
    slots=4, the phase-3 mix.  ``matmul_int8`` must launch with no plain
    version on the card, every request finish, and the weights' and the live
    cache's bytes equal the dry run's (:func:`hold_resident`)."""
    import numpy as np

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
    st = eng.stats()
    print(f"path F serve (w8a8, int8 cache, sjf, slots=4) on {card}: {st.total_tokens} tokens, "
          f"{st.tok_per_s:.2f} tok/s, TTFT p50 {st.percentile('ttft_s', 50) * 1e3:.2f} ms, "
          f"TPOT p50 {st.percentile('tpot_s', 50) * 1e3:.2f} ms, steps {st.steps}; "
          f"launches {ran}")
    hold_resident(eng, "path F")
    return ran


# ---------------------------------------------------------------------------
# Path S: the sliding window across a 4096-position ring
# ---------------------------------------------------------------------------

#: path S: mixtral-8x7b at full width, depth cut to S_LAYERS, path A's stack,
#: slots=4, a ring of min(window, S_MAX_LEN) = 4096 positions; one prompt
#: longer than the window and three short ones, S_NEW new tokens each, under
#: each of S_SCHEDULERS (token_budget's chunk rows run past position 4096,
#: plane attention at G up to 4 query heads a kv head · 256)
S_LAYERS = 1
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
        hold_resident(eng, f"path S {sched}")
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


def hold_cross_cache(cfg, caches, slots: int, label: str) -> None:
    """Hold the caches ``model.prefill`` built for a cross-attention config
    to the bytes of ``model.init_cache`` on the meta device, to the byte.
    ``dryrun.analytic_cache_bytes`` raises on a VLM's cross layers; for an
    encoder-decoder it counts the self-attention rings and leaves each
    layer's context K/V out, so there it must equal the cache less the
    contexts."""
    from repro_torch.core import kvcache
    from repro_torch.launch import dryrun
    from repro_torch.models import model as model_lib

    got = kvcache.cache_resident_bytes(caches)
    abstract = model_lib.init_cache(cfg, slots, CROSS_MAX_LEN, device="meta")
    want = kvcache.cache_resident_bytes(abstract)
    context = sum(kvcache.cache_resident_bytes(layer.get("cross", layer))
                  for i, layer in enumerate(abstract) if cfg.mixer_kind(i) != "attn")
    try:
        analytic = dryrun.analytic_cache_bytes(cfg, slots, CROSS_MAX_LEN)
    except NotImplementedError:
        analytic = None
    print(f"{label}: cache {got} B (init_cache on the meta device {want} B, of which context "
          f"K/V {context} B; analytic_cache_bytes "
          f"{'raises on the cross layers' if analytic is None else f'{analytic} B'})")
    check(got == want, f"{label}: cache {got} B != init_cache's {want} B")
    check(analytic is None or analytic + context == want,
          f"{label}: analytic_cache_bytes {analytic} B + context {context} B != {want} B")


def phase_cross(torch, device, card) -> dict[str, dict]:
    """Paths T-W: llama-3.2-vision-11b and seamless-m4t-medium at full width
    and depth on A's and B's stacks, drawn from ``SEED`` and converted leaf
    by leaf, every cross gate set to :data:`CROSS_GATE`, resident bytes held
    to the dry run's to the byte (the cross and encoder leaves included),
    each serve's caches to :func:`hold_cross_cache`, and the peak allocation
    to its bound.  Each serves, through ``model.prefill``
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
            hold_cross_cache(cfg, drive.caches, slots, f"path {path} slots={slots}")
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
        DECODE_PROFILES[path] = (cfg, path_spec(path)[0], 4, CROSS_MAX_LEN) + profile_steps(
            torch, drive.step, 3, f"path {path} profile decode step (slots=4, "
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
# Path Z: training qwen3-1.7b, then serving the trained weights on path A
# ---------------------------------------------------------------------------

#: path Z (a): steps of the train step at full width and depth, each on
#: TRAIN_BATCH rows of TRAIN_SEQ tokens (bf16 parameters, f32 moments,
#: remat on), the learning rate ``cosine_schedule(**TRAIN_LR)`` (the
#: reference trainer's default peak; at 1e-3 from the first step the loss
#: read 12.05, 16.57, 12.61, 22.34, 11.74, 9.53 on an NVIDIA H100 80GB HBM3
#: at 700 W); then one more step under the profiler
TRAIN_STEPS = 6
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_LR = dict(peak_lr=3e-4, warmup=1, total=TRAIN_STEPS + 1)
#: dense bf16 tensor-core peak of an H100 SXM (NVIDIA data sheet, 700 W)
BF16_OPS_PER_S = 989e12
#: the reference's own check of a 2-microbatch step against a 1-microbatch
#: step (tests/test_serve_train_loop.py), on bf16 parameters
MICROBATCH_TOL = dict(rtol=5e-2, atol=5e-3)
#: path Z (b)-(c): the 2-layer cut at full width, CUT_BATCH rows of CUT_SEQ
CUT_LAYERS, CUT_BATCH, CUT_SEQ = 2, 2, 256
CUT_LR = 1e-3
#: (b) card against CPU (float32, TF32 off): the loss and the grad norm
#: relative, each gradient leaf relative to its largest element (float32
#: sums over 512 tokens in another order on each device)
CARD_CPU_LOSS_RTOL, CARD_CPU_GNORM_RTOL, CARD_CPU_GRAD_RTOL = 1e-5, 1e-4, 1e-3
#: (c) the restart: steps, checkpoint period and the injected failure
RESTART = dict(steps=4, ckpt_every=2, fail_at=(3,))


def restart_pattern(steps: int, ckpt_every: int, fail_at) -> list:
    """The steps the reference's trainer logs (``log_every=1``) when it fails
    before each step of ``fail_at`` (once each) and restarts from its latest
    checkpoint: one is written after every ``ckpt_every``-th step, so a
    failure at step s resumes at ``s // ckpt_every * ckpt_every``."""
    out, start, pending = [], 0, sorted(fail_at)
    while True:
        for s in range(start, steps):
            if pending and s == pending[0]:
                pending.pop(0)
                start = s // ckpt_every * ckpt_every
                break
            out.append(s)
        else:
            return out


def _timed_ms(torch, device, fn):
    """fn() → (its result, device ms by CUDA events, host ms to the end of
    its device work)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def train_state_bytes(params) -> dict:
    """The train state's bytes from the shapes: the parameters in their
    dtypes, float32 gradients, float32 mu and nu."""
    from repro_torch import tree as tree_lib

    leaves = tree_lib.leaves(params)
    n = sum(t.numel() for t in leaves)
    return {"params": sum(t.numel() * t.element_size() for t in leaves), "n": n,
            "grads": 4 * n, "moments": 8 * n}


def phase_train_full(torch, device, card):
    """Path Z (a): qwen3-1.7b at full width and depth drawn from ``SEED``,
    trained :data:`TRAIN_STEPS` steps (``make_train_step`` + ``adamw``, f32
    moments, remat, ``SyntheticLM`` batches of TRAIN_BATCH x TRAIN_SEQ); a
    2-microbatch step on the first batch, from a copy of the same
    parameters, held to the reference's tolerance against the 1-microbatch
    step.  The loss must be finite and fall from the first step to the
    last; one more step runs under the profiler (busy time, idle share,
    the kernels taking most device time).  Returns (cfg, the trained
    parameters)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.train import trainstep

    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    params = model_lib.draw(cfg, SEED, device)
    torch.cuda.synchronize()
    sizes = train_state_bytes(params)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 8 * sizes["n"] * tokens  # 6 N T, and the remat forward's 2 N T
    bound_ms = flops / BF16_OPS_PER_S * 1e3
    print(f"path Z (a): qwen3-1.7b ({describe(cfg)}) drawn in {time.perf_counter() - t0:.2f} "
          f"s: {sizes['n']} parameters; analytic train state {sizes['params']} B params "
          f"(bf16 layers, float32 embedding and norms) + {sizes['grads']} B f32 grads + "
          f"{sizes['moments']} B f32 mu and nu = "
          f"{(sizes['params'] + sizes['grads'] + sizes['moments']) / 1e9:.3f} GB; a step of "
          f"{tokens} tokens is {flops:.4e} FLOP (8 N T), {bound_ms:.2f} ms at the dense bf16 "
          f"peak ({card})")
    opt = adamw.adamw(adamw.cosine_schedule(**TRAIN_LR), moment_dtype="f32")
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH, seed=SEED))
    first = to_device(src.batch(0), device)
    twin = tree_lib.map_leaves(torch.clone, params)
    step2 = trainstep.make_train_step(cfg, opt,
                                      step_cfg=trainstep.TrainStepConfig(microbatches=2))
    torch.cuda.reset_peak_memory_stats()
    (_, _, m2), ms2, _ = _timed_ms(torch, device, lambda: step2(
        twin, trainstep.init_opt_state(opt, twin, cfg), first))
    print(f"path Z (a) microbatches=2 on batch 0 on {card}: loss {m2['loss'].item():.6f}, "
          f"{ms2:.2f} ms (the first step: allocator and library warm-up), peak "
          f"{torch.cuda.max_memory_allocated()} B")
    torch.cuda.empty_cache()
    step = trainstep.make_train_step(cfg, opt)
    state = trainstep.init_opt_state(opt, params, cfg)
    losses = []
    for i in range(TRAIN_STEPS):
        batch = first if i == 0 else to_device(src.batch(i), device)
        torch.cuda.reset_peak_memory_stats()
        (params, state, m), ms, wall = _timed_ms(torch, device,
                                                lambda: step(params, state, batch))
        loss = m["loss"].item()
        losses.append(loss)
        print(f"path Z (a) step {i} on {card}: loss {loss:.6f} (ce {m['ce'].item():.6f}, z "
              f"{m['z'].item():.3f}, grad norm {m['grad_norm'].item():.4f}), {ms:.2f} ms "
              f"(CUDA events; host {wall:.2f} ms), {tokens / ms * 1e3:.1f} tokens/s, "
              f"{bound_ms / ms:.3f} of the bf16 bound, peak "
              f"{torch.cuda.max_memory_allocated()} B")
        check(math.isfinite(loss), f"path Z (a): step {i} loss {loss} not finite")
        if i == 0:
            worst = 0.0
            for a, b in zip(tree_lib.leaves(params), tree_lib.leaves(twin)):
                a, b = a.float(), b.float()
                bad = (a - b).abs() > MICROBATCH_TOL["atol"] + MICROBATCH_TOL["rtol"] * b.abs()
                check(not bool(bad.any()), "path Z (a): the 2-microbatch step is off the "
                      f"1-microbatch step beyond {MICROBATCH_TOL}")
                worst = max(worst, (a - b).abs().max().item())
            print(f"path Z (a) microbatches 2 vs 1 after step 0: loss {m2['loss'].item():.6f} "
                  f"vs {loss:.6f}, largest parameter difference {worst:.3e} (held to "
                  f"{MICROBATCH_TOL})")
            del twin
    check(losses[-1] < losses[0], f"path Z (a): loss did not fall: {losses}")
    batch = to_device(src.batch(TRAIN_STEPS), device)
    profile_steps(torch, lambda: step(params, state, batch), 1,
                  f"path Z (a) profile train step {TRAIN_STEPS} ({cfg.n_layers} layers, "
                  f"{tokens} tokens, {card}, under the profiler)")
    del state
    torch.cuda.empty_cache()
    return cfg, params


def phase_train_vs_cpu(torch, device, card, cfg) -> None:
    """Path Z (b): one train step of the 2-layer cut at full width in
    float32 on the card and on the CPU from the same parameters and batch:
    the loss, the grad norm and every gradient leaf within their stated
    tolerances, and every updated leaf within what AdamW's first update
    lets the measured gradient difference move it.  That update is
    ``g / (|g| + eps)`` of the clipped gradient (then weight decay, the
    same on both devices), whose slope is at most 1 / eps, so an element
    may differ by ``lr · min(2, |dg| / eps)`` (``dg`` the clipped
    gradients' difference) plus float32 rounding."""
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.train import trainstep

    cut = cfg.scaled(n_layers=CUT_LAYERS, dtype=torch.float32)
    host = SyntheticLM(DataConfig(vocab_size=cut.vocab_size, seq_len=CUT_SEQ,
                                  global_batch=CUT_BATCH, seed=SEED)).batch(0)
    eps = 1e-8
    opt = adamw.adamw(CUT_LR, eps=eps, moment_dtype="f32")
    cpu_params = model_lib.draw(cut, SEED, "cpu")
    runs = {}
    for dev in ("cpu", device):
        params = tree_lib.map_leaves(lambda t: t.to(dev, copy=True), cpu_params)
        t0 = time.perf_counter()
        loss, _, grads = trainstep.compute_grads(params, to_device(host, dev), cut)
        state, gnorm = trainstep.apply_grads(opt, params, trainstep.init_opt_state(
            opt, params, cut), grads, cut)
        # the gradients as the update saw them: scaled by the clip, as adamw does
        scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = tree_lib.map_leaves(lambda g: g * scale, grads)
        if dev != "cpu":
            torch.cuda.synchronize()
        runs[str(dev)] = (loss.item(), gnorm.item(), grads, params, time.perf_counter() - t0)
        del state
    (l0, n0, g0, p0, sec0), (l1, n1, g1, p1, sec1) = runs["cpu"], runs[str(device)]
    print(f"path Z (b) 2-layer float32 step, CPU {sec0:.2f} s / {card} {sec1:.2f} s: loss "
          f"{l0:.7f} / {l1:.7f}, grad norm {n0:.6f} / {n1:.6f}")
    check(abs(l1 - l0) <= CARD_CPU_LOSS_RTOL * abs(l0), f"path Z (b): loss {l1} vs CPU {l0}")
    check(abs(n1 - n0) <= CARD_CPU_GNORM_RTOL * n0, f"path Z (b): grad norm {n1} vs {n0}")
    worst_g = worst_p = 0.0
    f32_eps = 2.0 ** -23
    for (path, gc), gd, pc, pd in zip(tree_lib.flatten(g0), tree_lib.leaves(g1),
                                      tree_lib.leaves(p0), tree_lib.leaves(p1)):
        gc, pc = gc.to(device), pc.to(device)
        err = ((gd - gc).abs().max() / gc.abs().max().clamp_min(1e-30)).item()
        worst_g = max(worst_g, err)
        check(err <= CARD_CPU_GRAD_RTOL, f"path Z (b): gradient {'.'.join(path)} off the CPU's "
              f"by {err:.3e} of its largest element")  # (clipped: one scale per device)
        dg = (gd - gc).abs()
        allowed = (CUT_LR * torch.clamp(dg / eps, max=2.0) * (1 + 1e-3) + CUT_LR * 1e-6
                   + 4 * f32_eps * (pc.abs() + CUT_LR))
        dp = (pd - pc).abs()
        check(bool((dp <= allowed).all()), f"path Z (b): updated leaf {'.'.join(path)} off the "
              f"CPU's beyond what its gradient difference allows")
        worst_p = max(worst_p, (dp.max() / CUT_LR).item())
    print(f"path Z (b) {card} vs CPU: gradients within {worst_g:.3e} of each leaf's largest "
          f"element (limit {CARD_CPU_GRAD_RTOL}); updated leaves within {worst_p:.3e} lr, each "
          f"element within lr · min(2, |dg| / eps) + float32 rounding")
    del runs, g0, g1, p0, p1, cpu_params
    torch.cuda.empty_cache()


def directory_bytes(directory: str) -> int:
    """Bytes of every file under ``directory``."""
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(directory) for f in files)


def _equal_trees(torch, a, b) -> list:
    """The key paths where two trees of tensors differ (bitwise)."""
    from repro_torch import tree as tree_lib

    return [".".join(path) for (path, x), y in zip(tree_lib.flatten(a), tree_lib.leaves(b))
            if not torch.equal(x, y)]


def phase_train_restart(torch, device, card, cfg) -> None:
    """Path Z (c): the 2-layer cut at full width, bf16 parameters, int8
    moments.  First whether a train step is repeatable on the card (two
    steps from one state, compared bit for bit).  Then one step's state
    saved through ``AsyncCheckpointer`` into a temporary directory and
    restored bit for bit; then the trainer with ``FailureSim`` (its step
    history the reference trainer's pattern, :func:`restart_pattern`)
    against an uninterrupted run: final parameters equal to the bit where
    the step is repeatable.  Prints the bytes written and the seconds;
    the directory is deleted."""
    import shutil
    import tempfile

    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import ckpt as ckpt_lib
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.distributed.resilience import FailureSim
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as trainer_lib
    from repro_torch.train import trainstep

    cut = cfg.scaled(n_layers=CUT_LAYERS)
    data = DataConfig(vocab_size=cut.vocab_size, seq_len=CUT_SEQ, global_batch=CUT_BATCH,
                      seed=SEED)
    opt = adamw.adamw(CUT_LR, moment_dtype="int8")
    step = trainstep.make_train_step(cut, opt)
    batch = to_device(SyntheticLM(data).batch(0), device)
    params = model_lib.draw(cut, SEED, device)
    state = trainstep.init_opt_state(opt, params, cut)
    twin = tree_lib.map_leaves(torch.clone, params)
    twin_state = trainstep.init_opt_state(opt, twin, cut)
    params, state, _ = step(params, state, batch)
    twin, twin_state, _ = step(twin, twin_state, batch)
    differ = _equal_trees(torch, params, twin) + _equal_trees(
        torch, trainer_lib.state_tree(params, state, cut)["opt_state"],
        trainer_lib.state_tree(twin, twin_state, cut)["opt_state"])
    repeatable = not differ
    print(f"path Z (c) a train step repeated from one state on {card}: "
          + ("bitwise equal (the step is deterministic on the card)" if repeatable else
             f"{len(differ)} leaves differ: {differ[:8]}"))
    del twin, twin_state
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        print(f"path Z (c) checkpoint directory {tmp}: "
              f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB free")
        tree = trainer_lib.state_tree(params, state, cut)
        ac = ckpt_lib.AsyncCheckpointer()
        t0 = time.perf_counter()
        ac.save(tree, os.path.join(tmp, "one"), 1, extra={"step": 1})
        snap = time.perf_counter() - t0
        ac.wait()
        wrote = time.perf_counter() - t0
        nbytes = directory_bytes(os.path.join(tmp, "one"))
        t0 = time.perf_counter()
        back, extra = ckpt_lib.restore(os.path.join(tmp, "one"))
        r_params, r_state = trainer_lib.state_from_tree(back, cut, device, "int8")
        torch.cuda.synchronize()
        read = time.perf_counter() - t0
        check(extra == {"step": 1} and not _equal_trees(torch, params, r_params)
              and not _equal_trees(torch, tree["opt_state"], trainer_lib.state_tree(
                  r_params, r_state, cut)["opt_state"]),
              "path Z (c): the restored state is not the saved one")
        print(f"path Z (c) AsyncCheckpointer on {card}: {nbytes} B in {wrote:.2f} s ({snap:.2f} "
              f"s of it the snapshot to the host, {nbytes / wrote / 1e9:.2f} GB/s), restored "
              f"and verified (CRC per leaf) in {read:.2f} s, bit for bit")
        del params, state, r_params, r_state, back, tree
        shutil.rmtree(os.path.join(tmp, "one"))
        torch.cuda.empty_cache()

        steps, every, fail_at = RESTART["steps"], RESTART["ckpt_every"], RESTART["fail_at"]

        def run(ckpt_dir, failure):
            tr = trainer_lib.Trainer(
                cut, data, trainer_lib.TrainerConfig(
                    steps=steps, ckpt_every=every, ckpt_dir=ckpt_dir, log_every=1,
                    seed=SEED, peak_lr=CUT_LR, warmup=1, moment_dtype="int8"),
                failure_sim=failure, device=device)
            t0 = time.perf_counter()
            return tr.run(), time.perf_counter() - t0

        failed, sec = run(os.path.join(tmp, "run"), FailureSim(fail_at=fail_at))
        written = directory_bytes(os.path.join(tmp, "run"))
        clean, sec_clean = run(None, None)
        got = [h["step"] for h in failed["history"]]
        want = restart_pattern(steps, every, fail_at)
        print(f"path Z (c) trainer on {card} with FailureSim(fail_at={fail_at}): history "
              f"{got} (the reference's pattern {want}), {sec:.2f} s with {written} B of "
              f"checkpoints left "
              f"(steps {every}..{steps}); uninterrupted {sec_clean:.2f} s")
        check(got == want, f"path Z (c): step history {got}, expected {want}")
        differ = _equal_trees(torch, failed["params"], clean["params"])
        worst = max(((a.float() - b.float()).abs().max().item() for a, b in zip(
            tree_lib.leaves(failed["params"]), tree_lib.leaves(clean["params"]))), default=0.0)
        print(f"path Z (c) resumed vs uninterrupted final parameters: {len(differ)} leaves "
              f"differ, largest difference {worst:.3e}")
        check(repeatable and not differ,
              f"path Z (c): resumed parameters differ from the uninterrupted run's in "
              f"{differ[:8]} (the step repeatable on the card: {repeatable})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"path Z (c) checkpoint directory deleted: {not os.path.exists(tmp)}")
    torch.cuda.empty_cache()


def phase_train(torch, device, card) -> dict:
    """Path Z: (a) training at full width and depth, (b) the card against
    the CPU, (c) checkpoint and restart, none of which launches any of the
    eight kernels; then (d) the trained weights converted to path A's
    stack and served as path A is, A's exact launches a decode step.
    Returns (d)'s launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.serve import engine

    ops.reset_counts()
    cfg, params = phase_train_full(torch, device, card)
    phase_train_vs_cpu(torch, device, card, cfg)
    phase_train_restart(torch, device, card, cfg)
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    plain = {k: v for k, v in ops.plain_cuda_counts().items() if v}
    print(f"path Z (a)-(c) kernel launches {launched}, plain versions on the card {plain}")
    check(not launched and not plain, "path Z: the training path reached a kernel wrapper")
    mode = path_spec("Z")[0]
    qparams = engine.convert_params(params, cfg, mode)
    del params
    torch.cuda.empty_cache()
    got, want = engine.resident_bytes(qparams), dryrun.analytic_weight_bytes(cfg, mode)
    print(f"path Z (d): the trained weights on path A's stack ({mode}): {got} B resident "
          f"(analytic_weight_bytes {want} B)")
    check(got == want, f"path Z: resident bytes {got} != the dry run's {want}")
    counts = _serve_path(torch, device, card, engine, qparams, cfg, "Z")
    phase_profile(torch, device, engine, qparams, cfg, card, "Z")
    del qparams
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# The dry run: each profiled decode step against its bound, and every cell
# ---------------------------------------------------------------------------


def phase_dryrun(torch, card) -> None:
    """(a) ``hlo_stats.HW``'s HBM bytes against the card's total memory;
    (b) each profiled decode step (:data:`DECODE_PROFILES`) beside its
    analytic bound: the step's HBM traffic (``dryrun.analytic_traffic`` of
    a ``ShapeCell`` of the path's slots and max_len, on the config and
    depth it served), ``roofline_terms``' ``step_lower_bound`` and busy ms
    over it; (c) ``dryrun.analyze_cell`` for every arch × applicable shape
    under path A's stack, one line each (fits one card, dominant term,
    bound); (d) the same cells at the 16 × 16 pod and the 2 × 16 × 16
    multi-pod mesh, and jamba-1.5-large-398b's decode cell at (data, model)
    = (1, 4) and (1, 8) (:data:`DRYRUN_JAMBA_MESHES`), one ``dry run mesh``
    line each: a rank's bytes and whether they fit the card, the step's
    collective wire bytes or the check that keeps the port from running the
    cell there, the dominant term and the bound (probes skipped: the port's
    counts are its full-depth counts).  Host arithmetic over meta tensors:
    no kernel runs."""
    from repro_torch.configs import ARCH_NAMES, applicable_shapes, get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun, hlo_stats

    total = torch.cuda.get_device_properties(0).total_memory
    hbm = hlo_stats.HW["hbm_bytes"]
    print(f"dry run: HW hbm_bytes {hbm:.0f} B (the data sheet's 80 GB), the card's "
          f"total_memory {total} B = {total / hbm:.4f} x ({card})")
    check(hbm <= total <= 1.1 * hbm,
          f"HW hbm_bytes {hbm:.0f} B does not describe the card's {total} B")
    check(set(DECODE_PROFILES) >= {"A", "B", "C", "X", "Z", *CONFIG_PATHS, *MLA_PATHS,
                                   *WINDOW_SSM_PATHS, *CROSS_PATHS},
          f"profiled decode steps {sorted(DECODE_PROFILES)}")
    for path, (cfg, mode, slots, max_len, wall_ms, busy_ms) in DECODE_PROFILES.items():
        cell = ShapeCell(f"path {path}", max_len, slots, "decode")
        traffic = dryrun.analytic_traffic(cfg, cell, mode)
        terms = hlo_stats.roofline_terms(dryrun.model_flops(cfg, cell), traffic["total"], 0.0)
        bound_ms = terms["step_lower_bound"] * 1e3
        check(bound_ms > 0 and busy_ms > 0, f"path {path}: bound {bound_ms} ms, busy {busy_ms}")
        print(f"path {path} dry run: decode step of {cfg.name} ({cfg.n_layers} layers, {mode}, "
              f"cache {cfg.cache_format}, slots={slots}, max_len {max_len}): analytic traffic "
              f"{traffic['total']:.0f} B (weights {traffic['weight_traffic']:.0f}, cache "
              f"{traffic['cache_traffic']:.0f}, activations {traffic['act_traffic']:.0f}), "
              f"step_lower_bound {bound_ms:.4f} ms ({terms['dominant']}); busy "
              f"{busy_ms:.3f} ms = {busy_ms / bound_ms:.2f} x the bound, wall {wall_ms:.3f} ms "
              f"({card})")
    qmode, cache = PATHS["A"][:2]
    cells = [(a, s) for a in ARCH_NAMES for s in applicable_shapes(get_config(a))]
    check(len(cells) == 33, f"{len(cells)} arch x shape cells")
    for arch, shape in cells:
        rec = dryrun.analyze_cell(arch, shape, qmode=qmode, cache_format=cache)
        one, roof = rec["one_card"], rec["roofline"]
        print(f"dry run {arch} {shape} ({qmode}, cache {cache}): fits one card {one['fits']} "
              f"({one['total_bytes']} B), dominant {roof['dominant']}, step_lower_bound "
              f"{roof['step_lower_bound'] * 1e3:.4f} ms")
    t0 = time.perf_counter()
    for mesh in ("pod", "multipod"):
        for arch, shape in cells:
            _mesh_line(dryrun.analyze_cell(arch, shape, mesh=mesh, qmode=qmode,
                                           cache_format=cache, skip_probes=True), mesh)
    for mesh_shape in DRYRUN_JAMBA_MESHES:
        _mesh_line(dryrun.analyze_cell("jamba-1.5-large-398b", "decode_32k", qmode=qmode,
                                       cache_format=cache, mesh_shape=mesh_shape,
                                       skip_probes=True), f"(data, model) = {mesh_shape}")
    print(f"dry run at the meshes: {2 * len(cells) + len(DRYRUN_JAMBA_MESHES)} records in "
          f"{time.perf_counter() - t0:.1f} s of host arithmetic")


#: jamba-1.5-large-398b's decode cell on four and on eight cards of one host
DRYRUN_JAMBA_MESHES = ((1, 4), (1, 8))


def _mesh_line(rec: dict, mesh: str) -> None:
    """One ``dry run mesh`` line: a rank's bytes and whether they fit the
    card, the step's wire bytes or why the port runs no count there, the
    dominant roofline term and the bound."""
    mine, roof = rec["rank"], rec["roofline"]
    wire = (f"collectives null ({rec['unsupported']})" if rec["collectives"] is None
            else f"wire {rec['collective_wire_bytes']:.0f} B/device ("
            + ", ".join(f"{k} {v['count']}" for k, v in sorted(rec["collectives"].items()))
            + ")")
    print(f"dry run mesh {mesh} ({rec['devices']} devices, tp {rec['mesh_shape'].get('model')})"
          f" {rec['arch']} {rec['shape']} ({rec['qmode']}): a rank {mine['total']} B (weights "
          f"{mine.get('weights', mine.get('params'))}, cache {mine.get('cache', 0)}, batch "
          f"{mine['batch']}), fits 80 GB {mine['fits']}; {wire}; dominant {roof['dominant']}, "
          f"step_lower_bound {roof['step_lower_bound'] * 1e3:.4f} ms (collective "
          f"{roof['t_collective'] * 1e3:.4f} ms)")
    check(mine["total"] > 0 and (rec["collectives"] is None) == (rec["unsupported"] is not None),
          f"dry run mesh {mesh} {rec['arch']} {rec['shape']}: {mine}, {rec['unsupported']}")


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

    log, route, router_logits = [], moe._route, moe._router_logits

    def recording(params, x, cfg, tp=None):
        seen = []  # the logits _route takes (no second router product, no second all-reduce)

        def capture(*args, **kw):
            seen.append(router_logits(*args, **kw))
            return seen[-1]

        moe._router_logits = capture
        try:
            idx, gate, aux = route(params, x, cfg, tp)
        finally:
            moe._router_logits = router_logits
        probs = torch.softmax(seen[-1], dim=-1)
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


# ---------------------------------------------------------------------------
# The tp phase: tensor-parallel serving over a (data=1, model=2) mesh
# ---------------------------------------------------------------------------

#: the two-rank phase's ranks, both on cuda:0 under gloo (NCCL refuses two
#: ranks on one device)
TP_WORLD = 2
#: the mix: prompts of 16-128 tokens, new tokens each, slots, ring length
TP_REQUESTS, TP_NEW, TP_SLOTS, TP_MAX_LEN = 4, 16, 4, 256
#: seconds the parent waits for the NCCL child and for the two ranks
NCCL_JOIN_S, TP_JOIN_S = 120, 720
#: seconds a rank's collective waits for the other before it raises
TP_COLLECTIVE_TIMEOUT_S = 300
#: the device both ranks serve on
TP_DEVICE = "cuda:0"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _nccl_one_rank(port: int, outdir: str) -> None:
    """(a) NCCL at one rank on cuda:0: the four collectives on CUDA tensors,
    each checked, then the group destroyed."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import mesh as mesh_lib

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    mesh_lib.init(rank=0, world_size=1, init_method=f"tcp://localhost:{port}", device=device,
                  backend="nccl", timeout_s=60)
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
    tp = mesh_lib.TensorParallel(size=1, rank=0, group=dist.group.WORLD)
    out = {"sum_int32": tp.all_reduce_sum(torch.arange(4, dtype=torch.int32, device=device)),
           "sum_float32": tp.all_reduce_sum(torch.linspace(0, 1, 4, device=device)),
           "max": tp.all_reduce_max(torch.linspace(-1, 1, 4, device=device)),
           "gather": tp.all_gather(torch.arange(4, dtype=torch.bfloat16, device=device))}
    torch.cuda.synchronize()
    want = {"sum_int32": torch.arange(4, dtype=torch.int32, device=device),
            "sum_float32": torch.linspace(0, 1, 4, device=device),
            "max": torch.linspace(-1, 1, 4, device=device),
            "gather": torch.arange(4, dtype=torch.bfloat16, device=device)}
    for name, t in out.items():
        check(t.is_cuda and torch.equal(t, want[name]), f"NCCL {name}: {t} != {want[name]}")
    dist.destroy_process_group()
    with open(f"{outdir}/nccl.json", "w") as f:
        json.dump({"collectives": sorted(out), "s": time.perf_counter() - t0}, f)


def tp_step_bound(cfg, mode: str, cache: str, tp: int, slots: int, max_len: int) -> dict:
    """The dry run's bound of a ``tp``-way decode step at ``slots`` and
    ``max_len``: ``roofline_terms`` of the rank's model FLOPs (over ``tp``),
    its analytic traffic and the wire bytes of the step's collectives at
    NVLink's rate."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun, hlo_stats

    cfg = cfg.scaled(cache_format=cache)
    cell = ShapeCell("tp decode step", max_len, slots, "decode")
    traffic = dryrun.analytic_traffic(cfg, cell, mode, tp=tp, mesh_axes={"data": 1, "model": tp})
    wire = hlo_stats.collective_stats(
        dryrun.call_collectives(cfg, mode, "decode", batch=slots, seq=1, tp=tp)).wire_bytes
    return hlo_stats.roofline_terms(dryrun.model_flops(cfg, cell, tp) / tp, traffic["total"], wire)


def _rank_share(full, local, rank: int, tp: int):
    """The rank's share of a one-device tensor ``full`` that ``local``
    holds: ``full`` itself when the shapes agree, else its slice along the
    one dim that is ``tp`` times as long; None when there is no such dim."""
    if full.shape == local.shape:
        return full
    dims = [d for d in range(local.ndim) if full.ndim == local.ndim
            and full.shape[d] == tp * local.shape[d]]
    if len(dims) != 1 or any(full.shape[d] != local.shape[d]
                             for d in range(local.ndim) if d != dims[0]):
        return None
    n = local.shape[dims[0]]
    return full.narrow(dims[0], rank * n, n)


class ShardCodeLog(CodeLog):
    """:class:`CodeLog` against a one-device run's log, read by one rank of
    ``tp``: a rounding whose tensor holds the rank's share of the heads
    (the cache's K / V and the plane queries) is compared with its share of
    the one-device tensor (:func:`_rank_share`)."""

    def __init__(self, plain, rank: int, tp: int, force=False):
        super().__init__(plain, force)
        self.rank, self.tp = rank, tp

    def codes(self, v, q):
        i = len(self.calls)
        if self.plain is not None and i < len(self.plain.calls):
            vp, qp = self.plain.calls[i]
            share = _rank_share(qp, q, self.rank, self.tp)
            check(share is not None,
                  f"rounding {i}: {tuple(q.shape)} is no rank's share of {tuple(qp.shape)}")
            self.plain.calls[i] = (_rank_share(vp, v, self.rank, self.tp), share)
        return super().codes(v, q)


class OpLog:
    """The outputs of the model's float ops outside the kernels, in call
    order: the norms, the embedding, the q / k / v projections (after rope),
    the prefill and decode attention, the activation, every row-parallel
    projection's (whole) output and the logits.  Without ``plain`` it keeps
    each output; with ``plain`` (a one-device run's log) it compares each
    with its rank's share of that run's (:func:`_rank_share`) and keeps the
    first that differs: ``first`` = (call, op, model call, max |Δ|, shape),
    ``differ`` the count.  A context manager around one drive."""

    SITES = (("layers", "norm_apply"), ("layers", "embed_apply"), ("layers", "logits_apply"),
             ("layers", "activation"), ("layers", "row_parallel"),
             ("attention", "row_parallel"), ("attention", "_project_qkv"),
             ("attention", "chunked_attention"), ("attention", "_decode_attention"))

    def __init__(self, plain=None, rank: int = 0, tp: int = 1):
        self.plain, self.rank, self.tp = plain, rank, tp
        self.records: list = []
        self.model_calls = self.differ = 0
        self.first = None

    def _note(self, name: str, out) -> None:
        import torch

        for j, t in enumerate(out if isinstance(out, tuple) else (out,)):
            i = len(self.records)
            if self.plain is None:
                self.records.append((name, t.detach().clone()))
                continue
            self.records.append(None)
            check(i < len(self.plain.records) and self.plain.records[i][0] == name,
                  f"op {i} ({name}) is not the one-device run's")
            want = _rank_share(self.plain.records[i][1], t, self.rank, self.tp)
            check(want is not None, f"op {i} ({name}): {tuple(t.shape)} is no rank's share")
            if not torch.equal(want, t):
                self.differ += 1
                if self.first is None:
                    diff = (want.double() - t.double()).abs().max().item()
                    self.first = (i, f"{name}[{j}]" if isinstance(out, tuple) else name,
                                  self.model_calls, diff, list(t.shape))
        if name == "logits_apply":
            self.model_calls += 1

    def __enter__(self):
        from repro_torch.models import attention, layers

        mods = {"layers": layers, "attention": attention}
        self._undo = []
        for mod_name, fn_name in self.SITES:
            mod = mods[mod_name]
            fn = getattr(mod, fn_name)

            def wrapped(*args, _fn=fn, _name=fn_name, **kwargs):
                out = _fn(*args, **kwargs)
                self._note(_name, out)
                return out

            setattr(mod, fn_name, wrapped)
            self._undo.append((mod, fn_name, fn))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, fn in self._undo:
            setattr(mod, fn_name, fn)


def _tp_mix(cfg):
    """The tp phase's prompts: :data:`TP_REQUESTS` of 16-128 tokens (seeded)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 25)
    return [rng.integers(0, cfg.vocab_size, size=(int(n),)).astype(np.int32)
            for n in rng.integers(16, 129, size=TP_REQUESTS)]


def _tp_serve(engine, params, cfg, mode, cache, device, *, tp=1, mesh=None, force=None):
    """One serve of the tp mix (greedy, or teacher-forced to ``force``) →
    (engine, logit trace, tokens, wall s)."""
    import torch

    eng = engine.ServeEngine(params, cfg, tp=tp, mesh=mesh, mode=mode, cache_format=cache,
                             scheduler="fcfs", slots=TP_SLOTS, max_len=TP_MAX_LEN,
                             trace_logits=True, device=device)
    for i, prompt in enumerate(_tp_mix(cfg)):
        eng.submit(prompt, TP_NEW, force=None if force is None else force[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return eng, eng.logit_trace, [r.out for r in eng.requests], time.perf_counter() - t0


def _first_difference(a, b):
    """(call index, kind, max |Δ|) of the first logit row that differs."""
    import numpy as np

    for i, ((kind, _, x), (_, _, y)) in enumerate(zip(a, b)):
        if not np.array_equal(x, y):
            return i, kind, float(np.abs(np.asarray(x, np.float64) - y).max())
    return None


#: qwen3-1.7b's layers in the tp phase (28 in PR 25: cut to make room for the
#: MLA and MoE serves; a cut layer launches what a full one does)
TP_DEPTH = 8
#: the tp phase's serves: label → (arch, the path whose stack it serves, layers):
#: deepseek-v2-lite-16b's dense layer 0 and 3 MoE layers, mixtral-8x7b's one
#: layer (as path S)
TP_SERVES = {
    "qwen3-1.7b B": ("qwen3-1.7b", "B", TP_DEPTH),
    "qwen3-1.7b A": ("qwen3-1.7b", "A", TP_DEPTH),
    "deepseek-v2-lite-16b B": ("deepseek-v2-lite-16b", "B", 4),
    "deepseek-v2-lite-16b A": ("deepseek-v2-lite-16b", "A", 4),
    "mixtral-8x7b B": ("mixtral-8x7b", "B", 1),
}


def _step_launches(torch, eng, cfg) -> dict:
    """Each kernel's launches in one decode step of ``eng`` at slots=4: four
    64-token prompts (9 new tokens each) refilled, one decode step run, the
    next counted."""
    import numpy as np

    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED + 1)
    for _ in range(4):
        eng.submit(rng.integers(0, cfg.vocab_size, size=64).astype(np.int32), 9)
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    ops.reset_counts()
    eng.step()
    torch.cuda.synchronize()
    return {k: v for k, v in ops.launch_counts().items() if v}


def _route_differences(log, want) -> tuple:
    """(differing, total) (token, k) expert choices of a serve's routing log
    against another's (the same calls in the same order)."""
    check(len(log) == len(want), "the two serves routed a different number of times")
    differ = sum(int((a[1] != b[1]).sum()) for a, b in zip(log, want))
    return differ, sum(b[1].numel() for b in want)


def _tp_rank(rank: int, world: int, port: int, outdir: str, card: str) -> None:
    """One rank of (b): every serve of :data:`TP_SERVES` at full width, at
    tp = ``world`` on the (1, world) mesh and, in this process, at tp = 1
    on the same weights; writes what it held and measured to
    ``outdir/rank<r>.json``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import mesh as mesh_lib
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.serve import engine

    device = torch.device(TP_DEVICE)
    mesh_lib.init(rank=rank, world_size=world, init_method=f"tcp://localhost:{port}",
                  device=device, backend="gloo", timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    mesh = mesh_lib.device_mesh(device, (1, world), ("data", "model"))
    check(torch.cuda.current_device() == 0, f"rank {rank} on cuda:{torch.cuda.current_device()}")
    out: dict = {"rank": rank, "device": torch.cuda.get_device_name(torch.cuda.current_device()),
                 "current_device": torch.cuda.current_device(), "mesh": str(mesh)}
    for label, (arch, path, depth) in TP_SERVES.items():
        cfg = get_config(arch).scaled(n_layers=depth)
        mode, cache = PATHS[path][:2]
        moe = bool(cfg.n_experts)
        t0 = time.perf_counter()
        host = engine.materialize_converted(cfg, mode, seed=SEED, device=device, tp=world,
                                            keep=lambda leaf: engine.tree_to(leaf, "cpu"))
        res = {"draw_s": time.perf_counter() - t0, "layers": depth}

        def routed(run, forced=None):
            """``run()`` with the MoE routing recorded (and forced to
            ``forced``'s choices) → (its result, the routing log)."""
            if not moe:
                return run(), []
            log, undo = _record_routes(forced)
            try:
                return run(), log
            finally:
                undo()

        one_log = CodeLog() if path == "A" else None
        one_ops = OpLog()
        with one_log or _Null(), one_ops:
            (eng1, trace1, toks1, _), routes1 = routed(
                lambda: _tp_serve(engine, engine.tree_to(host, device), cfg, mode, cache,
                                  device))
        res["tp1_weights"] = eng1.resident_bytes()["weights"]
        trace1 = list(trace1)  # the launch count below steps eng1 on
        res["tp1_step_launches"] = _step_launches(torch, eng1, cfg)
        del eng1
        torch.cuda.empty_cache()

        def serve_tp(codes, op_log, forced=None, c=cfg, force=toks1):
            with codes or _Null(), op_log or _Null():
                return routed(lambda: _tp_serve(engine, host, c, mode, cache, device, tp=world,
                                                mesh=mesh, force=force), forced)

        ops.reset_counts()
        codes = ShardCodeLog(one_log, rank, world) if path == "A" else None
        op_log = OpLog(one_ops, rank, world)
        with dryrun.ModelCallLog() as served:
            (eng, trace, toks, wall), routes = serve_tp(codes, op_log)
        res["collectives"] = dryrun.held_collectives(eng._tp,
                                                     dryrun.serve_collectives(eng, served.calls))
        res["model_calls"] = len(served.calls)
        plain = ops.plain_cuda_counts()
        check(all(v == 0 for v in plain.values()), f"tp {label}: a plain version ran on CUDA")
        res["routes"] = _route_differences(routes, routes1) if moe else None
        got = eng.resident_bytes()
        res.update(wall_s=wall, collective_s=eng._tp.collective_s,
                   collective_calls=dict(eng._tp.calls), weights=got["weights"],
                   cache=got["cache"],
                   launches={k: v for k, v in ops.launch_counts().items() if v})
        counted = dryrun.rank_bytes(eng.cfg, "decode", mesh_axes={"data": 1, "model": world},
                                    rules=eng.rules, qmode=mode, batch=TP_SLOTS,
                                    cache_len=TP_MAX_LEN)
        res.update(weights_twin=counted["weights"], cache_twin=counted["cache"])
        del eng
        if moe and res["routes"][0]:  # held with tp = 1's expert choices forced
            codes = ShardCodeLog(one_log, rank, world) if path == "A" else None
            op_log = OpLog(one_ops, rank, world)
            (_, trace, toks, _), _ = serve_tp(codes, op_log, forced=routes1)
        res.update(
            tokens=toks, tp1_tokens=toks1,
            kinds_equal=[(k, s) for k, s, _ in trace] == [(k, s) for k, s, _ in trace1],
            bitwise=_first_difference(trace, trace1) is None,
            first_difference=_first_difference(trace, trace1), drift=_drift((trace, trace1)),
            first_op=op_log.first, ops_differ=op_log.differ, ops=len(op_log.records))
        del one_ops, op_log
        if codes is not None:
            res["codes"] = dict(differ=codes.differ, far=codes.far, calls=len(codes.calls),
                                first=codes.first)
            del one_log, codes
            torch.cuda.empty_cache()
            # the float32 drive: the same weights, every activation in float32,
            # the int4 boundary codes forced to the one-device run's
            f32 = dataclasses.replace(cfg, dtype=torch.float32)
            log32 = CodeLog()
            with log32:
                (_, trace32_1, toks32, _), routes32_1 = routed(lambda: _tp_serve(
                    engine, engine.tree_to(host, device), f32, mode, cache, device))
            torch.cuda.empty_cache()
            forced = ShardCodeLog(log32, rank, world, force=True)
            (_, trace32, _, _), routes32 = serve_tp(forced, None, c=f32, force=toks32)
            routes_f32 = _route_differences(routes32, routes32_1) if moe else None
            if moe and routes_f32[0]:
                forced = ShardCodeLog(log32, rank, world, force=True)
                (_, trace32, _, _), _ = serve_tp(forced, None, forced=routes32_1, c=f32,
                                                 force=toks32)
            res["f32"] = dict(forced=_drift((trace32, trace32_1)), differ=forced.differ,
                              forced_codes=forced.forced, far=forced.far, edge=forced.edge,
                              calls=len(log32.calls), first=forced.first, routes=routes_f32)
            del log32, forced
        torch.cuda.empty_cache()
        # launches of one decode step, then a profiled decode step, at slots=4
        prof = engine.ServeEngine(host, cfg, tp=world, mesh=mesh, mode=mode, cache_format=cache,
                                  slots=4, max_len=512, device=device)
        res["step_launches"] = _step_launches(torch, prof, cfg)
        prof._tp.reset_counts()
        res["profile_wall_ms"], res["profile_busy_ms"] = profile_steps(
            torch, prof.step, 3, f"tp phase rank {rank} {label} profile decode step "
            f"(slots=4, tp={world}, {cfg.n_layers} layers, {card}, under the profiler)")
        res["profile_collective_ms"] = prof._tp.collective_s * 1e3 / 3
        res["profile_collective_calls"] = {k: v / 3 for k, v in prof._tp.calls.items()}
        del prof, host
        torch.cuda.empty_cache()
        out[label] = res
    torch.distributed.destroy_process_group()
    with open(f"{outdir}/rank{rank}.json", "w") as f:
        json.dump(out, f)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _run_children(targets, join_s: float, label: str) -> None:
    """Start ``targets`` ((function, args) pairs) as spawned processes and
    wait for all within ``join_s``; any that is still running then is
    killed, and any that failed fails the phase."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=args) for fn, args in targets]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + join_s
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    check(not alive, f"{label}: {len(alive)} process(es) still running after {join_s} s: killed")
    check(all(p.exitcode == 0 for p in procs),
          f"{label}: exit codes {[p.exitcode for p in procs]}")


def phase_tp(torch, card) -> None:
    """(a) NCCL's four collectives at one rank; (b) two gloo ranks on the one
    card serving :data:`TP_SERVES` (qwen3-1.7b, deepseek-v2-lite-16b and
    mixtral-8x7b at full width, cut in depth) at tp = 2, each held against
    tp = 1 on the same weights: B bit for bit or its first differing op
    named and its rows within PATH_LIMITS, A within PATH_LIMITS in float32
    with the int4 boundary codes forced (its bf16 serve's drift and first
    differing op printed), a MoE serve whose expert choices differ from
    tp = 1's held with tp = 1's forced, every rank's tokens equal, each
    rank's resident bytes equal to its shard twin, each kernel's launches a
    decode step equal to tp = 1's; each rank's profiled decode step and
    collective host time printed."""
    import tempfile

    from repro_torch.configs import get_config

    with tempfile.TemporaryDirectory() as outdir:
        t0 = time.perf_counter()
        _run_children([(_nccl_one_rank, (_free_port(), outdir))], NCCL_JOIN_S, "tp (a) NCCL")
        with open(f"{outdir}/nccl.json") as f:
            nccl = json.load(f)
        print(f"tp (a): NCCL at one rank on cuda:0: {', '.join(nccl['collectives'])} on CUDA "
              f"tensors held, group destroyed; {nccl['s']:.2f} s in the child "
              f"({time.perf_counter() - t0:.2f} s with its start) on {card}")
        t0 = time.perf_counter()
        port = _free_port()
        _run_children([(_tp_rank, (r, TP_WORLD, port, outdir, card)) for r in range(TP_WORLD)],
                      TP_JOIN_S, "tp (b) ranks")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(TP_WORLD):
            with open(f"{outdir}/rank{r}.json") as f:
                ranks.append(json.load(f))
    print(f"tp (b): {TP_WORLD} gloo ranks on one card, collectives staged through the host: "
          f"none (gloo takes CUDA tensors for SUM on int32 and float32, MAX and all-gather); ranks on cuda:{[r['current_device'] for r in ranks]} ({ranks[0]['mesh']}); "
          f"{wall:.1f} s for the ranks' whole run, start to exit, on {card}")
    for label, (arch, path, depth) in TP_SERVES.items():
        for r in ranks:
            res = r[label]
            tag = f"tp {label} rank {r['rank']}"
            check(res["tokens"] == ranks[0][label]["tokens"],
                  f"tp {label}: rank {r['rank']}'s tokens differ from rank 0's")
            check(res["tokens"] == res["tp1_tokens"], f"{tag} did not emit the forced tokens")
            check(res["kinds_equal"], f"tp {label}: tp=2 scheduled other steps than tp=1")
            check(res["weights"] == res["weights_twin"],
                  f"{tag}: weights {res['weights']} B != twin {res['weights_twin']} B")
            check(res["cache"] == res["cache_twin"],
                  f"{tag}: cache {res['cache']} B != twin {res['cache_twin']} B")
            check(res["step_launches"] == res["tp1_step_launches"],
                  f"{tag}: {res['step_launches']} a decode step, tp=1 launches "
                  f"{res['tp1_step_launches']}")
            have, want = res["collectives"]
            check(have == want, f"{tag}: the serve's collectives {have} != the dry run's {want}")
            cfg = get_config(arch).scaled(n_layers=depth)
            terms = tp_step_bound(cfg, *PATHS[path][:2], TP_WORLD, 4, 512)
            bound_ms = terms["step_lower_bound"] * 1e3
            print(f"tp {label} rank {r['rank']}: the serve's collectives (kind, [count, raw "
                  f"bytes]) {have} = the dry run's count (call_collectives of its "
                  f"{res['model_calls']} model calls and the token "
                  f"check); profiled decode step busy {res['profile_busy_ms']:.3f} ms = "
                  f"{res['profile_busy_ms'] / bound_ms:.2f} x the dry run's step bound at "
                  f"tp={TP_WORLD} {bound_ms:.4f} ms ({terms['dominant']}; compute "
                  f"{terms['t_compute'] * 1e3:.4f}, memory {terms['t_memory'] * 1e3:.4f}, "
                  f"collective {terms['t_collective'] * 1e3:.4f} ms at NVLink's rate); the wall "
                  f"time is gloo's: it stages each collective through the host at 2-4.4 ms a "
                  f"call; on {card}")
            rel, cos, agree = res["drift"]
            print(f"tp {label} rank {r['rank']} ({r['device']}, {depth} layers): resident "
                  f"weights {res['weights']} B of tp=1's {res['tp1_weights']} B (twin "
                  f"{res['weights_twin']} B), cache {res['cache']} B (twin {res['cache_twin']} B); "
                  f"launches a decode step {res['step_launches']} (tp=1's); serve of "
                  f"{TP_REQUESTS} x {TP_NEW} tokens {res['wall_s'] * 1e3:.1f} ms wall, collectives "
                  f"{res['collective_s'] * 1e3:.1f} ms host {res['collective_calls']}; draw + "
                  f"convert {res['draw_s']:.1f} s; profiled decode step wall "
                  f"{res['profile_wall_ms']:.2f} ms, device busy {res['profile_busy_ms']:.2f} ms, "
                  f"collectives {res['profile_collective_ms']:.2f} ms host "
                  f"{res['profile_collective_calls']}; on {card}")
            routes = ""
            if res["routes"] is not None:
                differ, total = res["routes"]
                routes = (f"; {differ} of {total} (token, k) expert choices differ from tp=1's"
                          + (", held with tp=1's choices forced" if differ else ""))
            print(f"tp {label} rank {r['rank']} vs tp=1 (bf16): bit for bit "
                  f"{res['bitwise']}, first differing logit row {res['first_difference']}, max "
                  f"rel err {rel:.3e}, min cosine {cos:.6f}, argmax agree {agree}; first "
                  f"differing op (call, op, model call, max |d|, shape) {res['first_op']}, "
                  f"{res['ops_differ']} of {res['ops']} op outputs differ{routes}")
            if path == "B":
                check(res["bitwise"] or rel <= PATH_LIMITS["bfloat16"][0]
                      and cos >= PATH_LIMITS["bfloat16"][1],
                      f"{tag}: drift {rel}, {cos} past PATH_LIMITS")
                continue
            c, f = res["codes"], res["f32"]
            print(f"tp {label} rank {r['rank']} codes (bf16): {c['differ']} of the codes "
                  f"rounded in {c['calls']} calls differ from tp=1's, {c['far']} farther than "
                  f"{FLIP_TOL} of a step from their boundary, the first at {c['first']}: after "
                  f"a first flip the runs part, and over the depth in bf16 (a cast moves a "
                  f"value by up to 2^-8) they may part by more than PATH_LIMITS; printed, not "
                  f"held")
            routes32 = "" if f["routes"] is None else (
                f"; {f['routes'][0]} of {f['routes'][1]} expert choices differed from tp=1's"
                + (", held with tp=1's forced" if f["routes"][0] else ""))
            print(f"tp {label} rank {r['rank']} vs tp=1 in float32, with {f['forced_codes']} of "
                  f"{f['differ']} differing codes forced ({f['far']} farther than {FLIP_TOL} of "
                  f"a step, farthest {f['edge']:.3e}, of {f['calls']} rounding calls; the first "
                  f"at {f['first']}): max rel err {f['forced'][0]:.3e} (limit "
                  f"{PATH_LIMITS['float32'][0]}), min cosine {f['forced'][1]:.6f} (limit "
                  f"{PATH_LIMITS['float32'][1]}), argmax agree {f['forced'][2]}{routes32}")
            check(f["far"] == 0, f"{tag}: {f['far']} codes differ away from a boundary in "
                  "float32")
            check(f["forced"][0] <= PATH_LIMITS["float32"][0]
                  and f["forced"][1] >= PATH_LIMITS["float32"][1],
                  f"{tag}: float32 drift past PATH_LIMITS")


# ---------------------------------------------------------------------------
# Training over a mesh: two gloo ranks on the one card
# ---------------------------------------------------------------------------

#: the mesh phase's ranks, both on cuda:0 under gloo, and its device
MESH_WORLD = 2
MESH_DEVICE = "cuda:0"
#: (a): full-width qwen3-1.7b at (data=2, model=1), FSDP, path Z's settings:
#: bf16 layers, f32 moments, remat, TRAIN_BATCH x TRAIN_SEQ tokens a step
#: (2 rows a rank), MESH_STEPS steps, the depth cut to MESH_DEPTH (beside
#: CONFIG_DEPTH), width full
MESH_STEPS = 3
#: (b)-(d): the 2-layer float32 cut (CUT_LAYERS, CUT_SEQ, CUT_BATCH), each
#: mesh against (data=1, model=1) on the same weights and batches: the loss,
#: every gradient leaf and the parameters after MESH_CUT_STEPS steps within
#: MESH_RTOL of each leaf's largest |value|, an element past it allowed only
#: Adam's sign(g) move (at most 2 · lr a step), counted and printed
MESH_CUT_STEPS = 2
MESH_RTOL = 1e-5
#: (c): the trainer's moments (bf16: its checkpoints, the global state
#: gathered through gloo at ~0.4 GB/s, are 3.3 GB, not f32's 5.0 GB)
MESH_MOMENTS = "bf16"
#: (d): the pipeline's microbatches and their rows
MESH_PIPE_M, MESH_PIPE_ROWS = 4, 1
#: seconds a rank's collective waits for the other, and the ranks' wall limit
MESH_COLLECTIVE_TIMEOUT_S = 300
MESH_JOIN_S = 600


def _step_ms(torch, device, fn):
    """fn() → (its result, ms: CUDA events on the card, the host clock on the
    CPU)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3
    out, ms, _ = _timed_ms(torch, device, fn)
    return out, ms


def _peak(torch, device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _reset_peak(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _replicated_digest(params, tm) -> str:
    """sha256 of the rank's leaves no mesh axis shards, in leaf order."""
    import hashlib

    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.sharding import partitioning as P

    h = hashlib.sha256()
    for (path, leaf), (_, spec) in zip(tree_lib.flatten(params), tree_lib.flatten(tm.spec)):
        if not P.sharded_dims(spec, tm.rules, tm.view.sizes):
            h.update(".".join(path).encode())
            h.update(leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree of dicts, lists and tuples (the
    optimizer state's named tuples, ``Stacked`` leaves)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(tree_bytes(v) for v in (tree.values() if isinstance(tree, dict) else tree))


def _state_bytes_of_specs(spec_tree) -> int:
    """:func:`train_state_bytes`'s total over a ParamSpec tree (meta tensors)."""
    import torch

    from repro_torch import tree as tree_lib

    meta = tree_lib.map_leaves(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                               spec_tree)
    sizes = train_state_bytes(meta)
    return sizes["params"] + sizes["grads"] + sizes["moments"]


def _mesh_full(torch, device, rank: int) -> dict:
    """(a): qwen3-1.7b at full width (depth MESH_DEPTH) over (data=2, model=1)
    with FSDP; rank 0 first takes the one-rank loss of the first batch on
    the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch, to_device
    from repro_torch.distributed import mesh as mesh_lib
    from repro_torch.launch import dryrun
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.train import trainstep

    cfg = get_config("qwen3-1.7b")
    if MESH_DEPTH is not None:
        cfg = cfg.scaled(n_layers=MESH_DEPTH)
    mesh = mesh_lib.device_mesh(device, (MESH_WORLD, 1), ("data", "model"))
    opt = adamw.adamw(adamw.cosine_schedule(**TRAIN_LR), moment_dtype="f32")
    step = trainstep.make_train_step(cfg, opt, mesh=mesh)
    tm = step.mesh
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH, seed=SEED))
    out: dict = {"layers": cfg.n_layers, "steps": []}
    if rank == 0:
        t0 = time.perf_counter()
        full = model_lib.draw(cfg, SEED, device)
        with torch.no_grad():
            loss, _ = model_lib.loss_fn(full, to_device(src.batch(0), device), cfg)
        out["one_rank_loss"], out["one_rank_s"] = loss.item(), time.perf_counter() - t0
        del full, loss
        if device.type == "cuda":
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model_lib.draw(cfg, SEED, device, leaf=tm.shard_leaf)
    state = trainstep.init_opt_state(opt, params, cfg, tm)
    out["draw_s"] = time.perf_counter() - t0
    axes = {k: a.size for k, a in tm.view.axes.items()}
    mine = dryrun.rank_bytes(cfg, "train", mesh_axes=axes, rules=tm.rules, moments="f32",
                             batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    out["analytic"] = mine["params"] + mine["grads"] + mine["moments"]
    out["state_bytes"] = [[tree_bytes(params), tree_bytes(state)],
                          [mine["params"], mine["moments"]]]
    out["analytic_full"] = _state_bytes_of_specs(model_lib.specs(cfg))
    for i in range(MESH_STEPS):
        batch = to_device(shard_batch(src.batch(i), tm.view, tm.rules), device)
        _reset_peak(torch, device)
        tm.view.reset_counts()
        (params, state, m), ms = _step_ms(torch, device, lambda: step(params, state, batch))
        want = dryrun.train_step_collectives(cfg, mesh_axes=axes, rules=tm.rules,
                                             rows=batch["tokens"].shape[0], seq=TRAIN_SEQ,
                                             moments="f32")
        out["steps"].append({
            "loss": m["loss"].item(), "ce": m["ce"].item(), "grad_norm": m["grad_norm"].item(),
            "tokens": m["tokens"].item(), "ms": ms, "peak": _peak(torch, device),
            "calls": tm.view.calls, "collective_ms": tm.view.collective_s * 1e3,
            "collectives": dryrun.held_collectives(tm.view, want),
            "replicated": _replicated_digest(params, tm)})
    del params, state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _one_device_steps(torch, cut, opt, params, batches, quantize: bool):
    """The (data=1, model=1) reference of (b): the first batch's loss and
    float32 gradients, then len(batches) steps (the gradients replaced by
    their chunked int8 round trip with ``quantize``, the compressed hop at one
    rank) → (loss, grads of step 0, params after the steps)."""
    from repro_torch import convert
    from repro_torch import tree as tree_lib
    from repro_torch.core import quant
    from repro_torch.train import trainstep

    state = trainstep.init_opt_state(opt, params, cut)
    first = None
    for batch in batches:
        loss, _, grads = trainstep.compute_grads(params, batch, cut)
        if first is None:
            first = (loss.item(), tree_lib.map_leaves(torch.clone, grads))
        if quantize:
            layout = convert.reference_layout(grads, cut)
            for leaf in tree_lib.leaves(layout):
                pieces = tuple(leaf) if isinstance(leaf, convert.Stacked) else (leaf,)
                whole = torch.stack(pieces)
                q, s, n = quant.quantize_chunked(whole)
                back = quant.dequantize_chunked(q, s, n, whole.shape)
                for piece, b in zip(pieces, back.unbind(0)):
                    piece.copy_(b)
        state, _ = trainstep.apply_grads(opt, params, state, grads, cut)
    return first[0], first[1], params


def _held(torch, got: dict, want: dict, steps=None) -> dict:
    """Leaf by leaf (port layout trees): the largest difference over the
    leaf's largest |value|; with ``steps``, the elements past MESH_RTOL of it
    (each must be within Adam's 2 · lr a step)."""
    from repro_torch import tree as tree_lib

    worst, signs, n, bad = 0.0, 0, 0, []
    for (path, g), w in zip(tree_lib.flatten(got), tree_lib.leaves(want)):
        d = (g.double() - w.double()).abs()
        scale = w.double().abs().max().clamp_min(1e-30)
        worst = max(worst, (d.max() / scale).item())
        n += d.numel()
        if steps is not None:
            loose = d > MESH_RTOL * scale
            signs += int(loose.sum())
            if bool((d[loose] > 2 * CUT_LR * steps * (1 + 1e-3)).any()):
                bad.append(".".join(path))
    return {"worst": worst, "signs": signs, "n": n, "bad": bad}


def _mesh_cut(torch, device, rank: int) -> dict:
    """(b): the 2-layer float32 cut at full width over FSDP (data=2), TP
    (model=2) and the compressed pod hop (pod=2, data=1, model=1), each
    against (data=1, model=1) on the same weights and batches."""
    from repro_torch import convert
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch, to_device
    from repro_torch.distributed import mesh as mesh_lib
    from repro_torch.launch import dryrun
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.train import trainstep

    cut = get_config("qwen3-1.7b").scaled(n_layers=CUT_LAYERS, dtype=torch.float32)
    src = SyntheticLM(DataConfig(vocab_size=cut.vocab_size, seq_len=CUT_SEQ,
                                 global_batch=CUT_BATCH, seed=SEED))
    hosts = [src.batch(i) for i in range(MESH_CUT_STEPS)]
    opt = adamw.adamw(CUT_LR, moment_dtype="f32")
    initial = model_lib.draw(cut, SEED, device)
    one = {}  # (data=1, model=1), unquantized and through the hop's round trip
    for compress in (False, True):
        t0 = time.perf_counter()
        one[compress] = _one_device_steps(
            torch, cut, opt, tree_lib.map_leaves(torch.clone, initial),
            [to_device(h, device) for h in hosts], quantize=compress) + (
            time.perf_counter() - t0,)
    out = {}
    for name, shape, names, tp, compress in (
            ("fsdp", (2, 1), ("data", "model"), 1, False),
            ("tp", (1, 2), ("data", "model"), 2, False),
            ("pod", (2, 1, 1), ("pod", "data", "model"), 1, True)):
        loss1, grads1, params1, one_s = one[compress]
        t0 = time.perf_counter()
        mesh = mesh_lib.device_mesh(device, shape, names)
        step_cfg = trainstep.TrainStepConfig(compress_pod_grads=compress)
        step = trainstep.make_train_step(cut, opt, tp=tp, mesh=mesh, step_cfg=step_cfg)
        tm = step.mesh
        params = tm.shard(initial)
        state = trainstep.init_opt_state(opt, params, cut, tm)
        batches = [to_device(shard_batch(h, tm.view, tm.rules), device) for h in hosts]
        tm.view.reset_counts()
        # step 0 by the train step's pieces, to hold the gradients it applies
        share, _, grads = trainstep.compute_grads(params, batches[0], cut, step_cfg, tm)
        grads = trainstep.sync_grads(grads, tm)
        res = {"grads": _held(torch, tm.gather(grads), grads1),
               "losses": [tm.view.all_reduce_sum(share, tm.batch_axes).item()]}
        if compress:  # the hop, code for code: dequantize(quantize(g)) of each global leaf
            before = convert.reference_layout(tm.gather(grads), cut)
            grads = trainstep.compress_pod(grads, cut, tm)
            after = convert.reference_layout(tm.gather(grads), cut)
            differ = 0
            for b, a in zip(tree_lib.leaves(before), tree_lib.leaves(after)):
                b = torch.stack(tuple(b)) if isinstance(b, convert.Stacked) else b
                a = torch.stack(tuple(a)) if isinstance(a, convert.Stacked) else a
                q, s, n = quant.quantize_chunked(b)
                differ += int((quant.dequantize_chunked(q, s, n, b.shape) != a).sum())
            res["hop_differ"] = differ
        state, _ = trainstep.apply_grads(opt, params, state, grads, cut, tm)
        del grads
        for b in batches[1:]:  # whole steps: their collectives held to the dry run's count
            tm.view.reset_counts()
            params, state, m = step(params, state, b)
            res["losses"].append(m["loss"].item())
        res["collectives"] = dryrun.held_collectives(tm.view, dryrun.train_step_collectives(
            cut, mesh_axes={k: a.size for k, a in tm.view.axes.items()}, rules=tm.rules,
            rows=b["tokens"].shape[0], seq=CUT_SEQ, compress_pod_grads=compress, moments="f32"))
        res["params"] = _held(torch, tm.gather(params), params1, MESH_CUT_STEPS)
        res.update(step_loss=res["losses"][0], one_loss=loss1, calls=tm.view.calls,
                   s=time.perf_counter() - t0, one_s=one_s)
        out[name] = res
        del params, state
    del one, initial
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _mesh_elastic(torch, device, rank: int, ckpt_dir: str) -> dict:
    """(c): the float32 cut's trainer at (data=2, model=1), a checkpoint every
    2 steps and a failure before step 3, against an uninterrupted run at
    data=2 (bitwise) and, restored from the step-2 checkpoint on the mesh
    ``plan_elastic_mesh(1, model_parallel=1)`` gives (one device), against an
    uninterrupted run there."""
    import shutil

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed import mesh as mesh_lib
    from repro_torch.distributed.resilience import FailureSim, plan_elastic_mesh
    from repro_torch.train import trainer as trainer_lib

    cut = get_config("qwen3-1.7b").scaled(n_layers=CUT_LAYERS, dtype=torch.float32)
    data = DataConfig(vocab_size=cut.vocab_size, seq_len=CUT_SEQ, global_batch=CUT_BATCH,
                      seed=SEED)
    steps, every, fail_at = RESTART["steps"], RESTART["ckpt_every"], RESTART["fail_at"]

    def run(mesh, ckpt, failure, every=every):
        tr = trainer_lib.Trainer(
            cut, data, trainer_lib.TrainerConfig(steps=steps, ckpt_every=every, ckpt_dir=ckpt,
                                                 log_every=1, seed=SEED, peak_lr=CUT_LR,
                                                 warmup=1, moment_dtype=MESH_MOMENTS),
            mesh=mesh, failure_sim=failure, device=device)
        t0 = time.perf_counter()
        return tr.run(), time.perf_counter() - t0

    mesh = mesh_lib.device_mesh(device, (MESH_WORLD, 1), ("data", "model"))
    failed, sec = run(mesh, ckpt_dir, FailureSim(fail_at=fail_at))
    clean, clean_s = run(mesh, None, None)
    out = {"history": [h["step"] for h in failed["history"]], "s": sec,
           "bitwise": all(torch.equal(a, b) for a, b in zip(
               tree_lib.leaves(failed["params"]), tree_lib.leaves(clean["params"])))}
    plan = plan_elastic_mesh(1, model_parallel=1)
    out["plan"] = list(plan)
    out["clean_s"] = clean_s
    if rank == 0:  # the shrunk job on one device, from the step-2 checkpoint
        check(plan == (1, 1), f"plan_elastic_mesh(1, model_parallel=1) gave {plan}")
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{steps:09d}"))
        resumed, out["shrunk_s"] = run(None, ckpt_dir, None, every=steps + 1)
        one, out["one_s"] = run(None, None, None)
        out["shrunk_history"] = [h["step"] for h in resumed["history"]]
        out["shrunk"] = _held(torch, resumed["params"], one["params"], steps - every)
    return out


def _mesh_pipe(torch, device) -> dict:
    """(d): ``pipeline_apply`` at pipe=2 over the float32 cut's two layers (one
    a stage) against the sequential stack."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.distributed import mesh as mesh_lib
    from repro_torch.distributed import pipeline
    from repro_torch.distributed.mesh import MeshView
    from repro_torch.models import model as model_lib
    from repro_torch.models import stack
    from repro_torch.tree import map_leaves

    cut = get_config("qwen3-1.7b").scaled(n_layers=CUT_LAYERS, dtype=torch.float32)
    params = model_lib.draw(cut, SEED, device)
    view = MeshView.from_mesh(mesh_lib.device_mesh(device, (MESH_WORLD,), ("pipe",)))
    layers = convert.reference_layout(params, cut)["stack"]["slot0"]
    stages = pipeline.split_stages(map_leaves(lambda t: torch.stack(tuple(t)), layers),
                                   MESH_WORLD)
    gen = torch.Generator(device=device).manual_seed(SEED)
    h = torch.randn((MESH_PIPE_M, MESH_PIPE_ROWS, CUT_SEQ, cut.d_model), generator=gen,
                    device=device)

    def stage_fn(p, x):
        for j in range(p["ln1"]["scale"].shape[0]):
            x, _, _ = stack.layer_apply(map_leaves(lambda a: a[j], p), x, cut, mode="train")
        return x

    got, ms = _step_ms(torch, device, lambda: pipeline.pipeline_apply(stage_fn, stages, h, view))
    with torch.no_grad():
        want = torch.stack([stack.stack_apply(params["layers"], x, cut, mode="train")[0]
                            for x in h])
    err = ((got - want).abs().max() / want.abs().max()).item()
    return {"err": err, "ms": ms, "calls": view.calls, "ticks": MESH_PIPE_M + MESH_WORLD - 1}


def _mesh_rank(rank: int, world: int, port: int, outdir: str) -> None:
    """One rank of the mesh phase: (a)-(d) in turn, then what it measured to
    ``outdir/mesh<r>.json``."""
    import torch

    from repro_torch.distributed import mesh as mesh_lib
    from repro_torch.kernels import ops

    device = torch.device(MESH_DEVICE)
    mesh_lib.init(rank=rank, world_size=world, init_method=f"tcp://localhost:{port}",
                  device=device, backend="gloo", timeout_s=MESH_COLLECTIVE_TIMEOUT_S)
    ops.reset_counts()
    out = {"rank": rank}
    t0 = time.perf_counter()
    out["a"] = _mesh_full(torch, device, rank)
    out["a_s"] = time.perf_counter() - t0
    out["b"] = _mesh_cut(torch, device, rank)
    out["c"] = _mesh_elastic(torch, device, rank, os.path.join(outdir, "ckpt"))
    out["d"] = _mesh_pipe(torch, device)
    out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    out["plain"] = {k: v for k, v in ops.plain_cuda_counts().items() if v}
    torch.distributed.destroy_process_group()
    with open(f"{outdir}/mesh{rank}.json", "w") as f:
        json.dump(out, f)


def phase_train_mesh(torch, card) -> None:
    """Training over a mesh: two gloo ranks on the one card.  (a) qwen3-1.7b
    at full width over (data=2, model=1) with FSDP at path Z's settings,
    MESH_STEPS steps: each step's ms (CUDA events), tokens/s, each rank's
    peak allocation against its shard of the analytic train state, the
    collectives' counts and host ms and the losses printed; every replicated
    leaf bitwise equal on the two ranks after each step; the first step's
    loss equal to the one-rank loss on the same weights and batch within
    path Z's bf16 limit (``MICROBATCH_TOL``).  (b) the 2-layer float32 cut
    over FSDP, TP and the compressed pod hop against (data=1, model=1): the
    first step's loss and gradients, the parameters after MESH_CUT_STEPS
    steps (Adam's sign elements counted), the hop's output code for code.
    (c) the trainer's restart at data=2 bitwise equal to an uninterrupted
    run, and restored on ``plan_elastic_mesh(1, model_parallel=1)``'s one
    device within (b)'s limits of an uninterrupted run there.  (d)
    ``pipeline_apply`` at pipe=2 against the sequential stack.  No kernel of
    the eight may launch."""
    import tempfile

    with tempfile.TemporaryDirectory() as outdir:
        t0 = time.perf_counter()
        port = _free_port()
        _run_children([(_mesh_rank, (r, MESH_WORLD, port, outdir)) for r in range(MESH_WORLD)],
                      MESH_JOIN_S, "mesh training ranks")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_WORLD):
            with open(f"{outdir}/mesh{r}.json") as f:
                ranks.append(json.load(f))
    a0 = ranks[0]["a"]
    depth = "full depth" if MESH_DEPTH is None else f"depth cut to {MESH_DEPTH} (MESH_DEPTH)"
    print(f"mesh (a): qwen3-1.7b at full width, {a0['layers']} layers ({depth}), (data=2, "
          f"model=1) FSDP, {MESH_WORLD} gloo ranks on {MESH_DEVICE}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
          f"a step ({TRAIN_BATCH // MESH_WORLD} rows a rank), bf16 layers, f32 moments, remat; "
          f"one-rank loss of batch 0 {a0['one_rank_loss']:.6f} ({a0['one_rank_s']:.1f} s); on "
          f"{card}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i in range(MESH_STEPS):
        for r in ranks:
            st = r["a"]["steps"][i]
            print(f"mesh (a) step {i} rank {r['rank']}: loss {st['loss']:.6f} (ce "
                  f"{st['ce']:.6f}, grad norm {st['grad_norm']:.4f}, {st['tokens']:.0f} tokens), "
                  f"{st['ms']:.2f} ms (CUDA events), {tokens / st['ms'] * 1e3:.1f} tokens/s, peak "
                  f"{st['peak']} B against its shard of the analytic state {r['a']['analytic']} B "
                  f"({st['peak'] / r['a']['analytic']:.2f}x; the whole state "
                  f"{r['a']['analytic_full']} B), collectives {st['calls']} "
                  f"{st['collective_ms']:.1f} ms host; on {card}")
            have, want = st["collectives"]
            print(f"mesh (a) step {i} rank {r['rank']}: collectives (kind, [count, raw bytes]) "
                  f"{have} = the dry run's count (train_step_collectives)")
            check(have == want, f"mesh (a) step {i} rank {r['rank']}: collectives {have} != "
                  f"the dry run's {want}")
            check(math.isfinite(st["loss"]), f"mesh (a): step {i} loss {st['loss']}")
            check(st["loss"] == ranks[0]["a"]["steps"][i]["loss"],
                  f"mesh (a) step {i}: the ranks' losses differ")
            check(st["replicated"] == ranks[0]["a"]["steps"][i]["replicated"],
                  f"mesh (a) step {i}: a replicated leaf differs between the ranks")
    for r in ranks:
        (p_have, s_have), (p_want, s_want) = r["a"]["state_bytes"]
        print(f"mesh (a) rank {r['rank']}: parameter shards {p_have} B, optimizer state "
              f"{s_have} B = the dry run's (rank_bytes) {p_want} B, {s_want} B")
        check([p_have, s_have] == [p_want, s_want],
              f"mesh (a) rank {r['rank']}: state bytes {p_have}, {s_have} != {p_want}, {s_want}")
    first, one = a0["steps"][0]["loss"], a0["one_rank_loss"]
    tol = MICROBATCH_TOL["atol"] + MICROBATCH_TOL["rtol"] * abs(one)
    print(f"mesh (a): every replicated leaf bitwise equal on both ranks after each step; step "
          f"0's loss {first:.6f} vs the one-rank loss {one:.6f} (|d| {abs(first - one):.3e}, "
          f"limit {tol:.3e}, path Z's bf16 MICROBATCH_TOL)")
    check(abs(first - one) <= tol, f"mesh (a): step 0's loss {first} vs one rank's {one}")
    for name, res in ranks[0]["b"].items():
        for r in ranks:
            other = r["b"][name]
            g, p = other["grads"], other["params"]
            print(f"mesh (b) {name} rank {r['rank']} (2-layer float32 cut, {CUT_BATCH} x "
                  f"{CUT_SEQ} tokens): loss {other['step_loss']:.7f} vs one device "
                  f"{other['one_loss']:.7f}; gradients within {g['worst']:.3e} of each leaf's "
                  f"largest; parameters after {MESH_CUT_STEPS} steps within {p['worst']:.3e}, "
                  f"{p['signs']} of {p['n']} elements past {MESH_RTOL} (Adam's sign(g), each "
                  f"within 2 lr a step)"
                  + (f"; the hop's output off dequantize(quantize(g)) in "
                     f"{other['hop_differ']} elements" if "hop_differ" in other else "")
                  + f"; collectives {other['calls']}; {other['s']:.1f} s (one device "
                  f"{other['one_s']:.1f} s); on {card}")
            check(abs(other["step_loss"] - other["one_loss"]) <= MESH_RTOL * abs(
                other["one_loss"]), f"mesh (b) {name}: loss off the one-device loss")
            check(g["worst"] <= MESH_RTOL, f"mesh (b) {name}: gradients {g['worst']} off")
            check(not p["bad"] and p["signs"] <= 1e-3 * p["n"],
                  f"mesh (b) {name}: parameters off beyond Adam's sign moves: {p['bad'][:4]}, "
                  f"{p['signs']} elements")
            check(other.get("hop_differ", 0) == 0, f"mesh (b) {name}: the hop is not the "
                  "dequantized quantization of the global gradient")
            have, want = other["collectives"]
            print(f"mesh (b) {name} rank {r['rank']}: a step's collectives {have} = the dry "
                  f"run's count")
            check(have == want, f"mesh (b) {name} rank {r['rank']}: collectives {have} != the "
                  f"dry run's {want}")
    c0 = ranks[0]["c"]
    want = restart_pattern(RESTART["steps"], RESTART["ckpt_every"], RESTART["fail_at"])
    print(f"mesh (c) trainer at (data=2, model=1), FailureSim(fail_at={RESTART['fail_at']}): "
          f"history {c0['history']} (the reference's pattern {want}), {c0['s']:.1f} s (the "
          f"uninterrupted run {c0['clean_s']:.1f} s, the one-device runs {c0['shrunk_s']:.1f} "
          f"and {c0['one_s']:.1f} s, checkpoints of the global state, {MESH_MOMENTS} moments, "
          f"included); resumed "
          f"vs uninterrupted bitwise on rank 0 {c0['bitwise']}, rank 1 {ranks[1]['c']['bitwise']}; "
          f"plan_elastic_mesh(1, model_parallel=1) = {c0['plan']}: restored from step "
          f"{RESTART['ckpt_every']} there, history {c0['shrunk_history']}, within "
          f"{c0['shrunk']['worst']:.3e} of an uninterrupted one-device run, "
          f"{c0['shrunk']['signs']} of {c0['shrunk']['n']} elements past {MESH_RTOL}; on {card}")
    for r in ranks:
        check(r["c"]["history"] == want and r["c"]["bitwise"],
              f"mesh (c) rank {r['rank']}: history {r['c']['history']}, bitwise "
              f"{r['c']['bitwise']}")
    check(c0["shrunk_history"] == list(range(RESTART["ckpt_every"], RESTART["steps"]))
          and not c0["shrunk"]["bad"] and c0["shrunk"]["signs"] <= 1e-3 * c0["shrunk"]["n"],
          f"mesh (c): the run restored at one device is off: {c0['shrunk']}")
    for r in ranks:
        d = r["d"]
        print(f"mesh (d) pipeline_apply rank {r['rank']}: pipe=2, {MESH_PIPE_M} microbatches "
              f"of {MESH_PIPE_ROWS} x {CUT_SEQ} tokens, {d['ticks']} ticks, {d['ms']:.1f} ms, "
              f"within {d['err']:.3e} of the sequential stack's largest; collectives "
              f"{d['calls']}; on {card}")
        check(d["err"] <= MESH_RTOL, f"mesh (d) rank {r['rank']}: {d['err']} off")
        check(not r["launches"] and not r["plain"],
              f"mesh rank {r['rank']}: a kernel wrapper ran: {r['launches']} {r['plain']}")
    print(f"mesh phase: training over a mesh launched none of the eight kernels; "
          f"{wall:.1f} s for the ranks, start to exit, on {card}")


# ---------------------------------------------------------------------------
# The example twins on the card
# ---------------------------------------------------------------------------


def phase_examples(torch, card) -> None:
    """The twins of ``examples/quickstart.py`` (train the reduced qwen3 40
    steps, convert to ``w8a8``, prefill and greedy decode) and
    ``examples/serve_quantized.py`` (every registered format, the mixed
    policies with their cache suffixes, the traced all-fused row) on the
    card at the reference's sizes: no plain version may run on CUDA
    (``ops.plain_cuda_counts()``), the quantized rows launch their kernels."""
    from repro_torch.examples import quickstart, serve_quantized
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ops.reset_counts()
    q = quickstart.main(["--device", "cuda"])
    q_launches = {k: v for k, v in ops.launch_counts().items() if v}
    q_plain = {k: v for k, v in ops.plain_cuda_counts().items() if v}
    losses = [h["loss"] for h in q["history"]]
    print(f"examples: quickstart on {card}: losses {[round(x, 4) for x in losses]}, "
          f"{len(q['tokens'])} tokens generated on w8a8 weights, launches {q_launches}, "
          f"plain versions on CUDA {q_plain or 'none'}, {time.perf_counter() - t0:.1f} s")
    check(len(q["tokens"]) == 9 and all(0 <= t < q["cfg"].vocab_size for t in q["tokens"])
          and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"quickstart: tokens {q['tokens']}, losses {losses}")
    check(not q_plain, f"examples: a plain version ran on CUDA in quickstart: {q_plain}")
    check(q_launches.get("matmul_int8", 0) > 0, f"quickstart launched {q_launches}")
    t0 = time.perf_counter()
    ops.reset_counts()
    sq = serve_quantized.main(["--device", "cuda"])
    s_launches = {k: v for k, v in ops.launch_counts().items() if v}
    plain = {k: v for k, v in ops.plain_cuda_counts().items() if v}
    print(f"examples: serve_quantized on {card}: {len(sq['rows'])} rows, traced run "
          f"{sq['traced']['records']} records, launches {s_launches}, plain versions on CUDA "
          f"{plain or 'none'}, {time.perf_counter() - t0:.1f} s")
    check(not plain, f"examples: a plain version ran on CUDA: {plain}")
    check(len(sq["rows"]) == len(serve_quantized.MODES)
          and all(r["tokens"] > 0 for r in sq["rows"]), "serve_quantized: a row served nothing")
    want = {"bsdp_gemm_fused", "bsdp_gemm", "dequant_matmul", "matmul_int8",
            "matmul_int4_packed", "plane_decode_attention"}
    check(want <= set(s_launches), f"serve_quantized launched {sorted(s_launches)}, not all "
          f"of {sorted(want)}")


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
    done("paths A-C, E, F, X, Y")
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
    phase_train(torch, device, card)  # its serve's launches stay out of the kernels line
    done("path Z")
    phase_dryrun(torch, card)
    done("dry run")
    torch.cuda.empty_cache()
    phase_tp(torch, card)
    done("tp phase")
    phase_train_mesh(torch, card)
    done("mesh training phase")
    phase_examples(torch, card)
    torch.cuda.empty_cache()
    done("examples")
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
