"""Fused GQA decode attention on the int4 bit-plane KV cache.

Replaces ``repro/kernels/plane_attn.py:_plane_attn_kernel``
(``plane_decode_attention``, the ``pallas_call`` at ``:141``) with
``csrc/plane_attn.cu``: the integer plane-space scores by ``__popc`` over
the 16 plane pairs (exact, identical to the reference's contraction), the
q and k scales, ``sm_scale`` and the additive bias folded after the
integer math, the softmax over L in float32, and the weights — with
``(1, 2, 4, -8)·v_scale`` folded in — contracted against the raw V bits.
L is split over a cluster of up to 8 blocks per (batch × kv-head) row
(flash-decoding); the splits' softmax statistics and partial outputs are
combined in a fixed order through distributed shared memory, in the same
launch.  The query rows G (chunk × group under chunked prefill) are tiled
over the grid's third axis, so one launch takes any G and a (row, query)'s
result does not depend on G.

The K/V planes are read in the cache's stored layout ``[B, L, Hkv, 4, Fw]``
and the bias ``[B, Hkv, G, L]`` through strides: no transposed copy of the
cache and no copy of the caller's expanded (stride-0) bias is made per
step.  On the card the kernel is bound by the bytes of the K/V planes,
scales and bias.  A row whose bias is all ``NEG_INF`` (an idle slot) gets
uniform weights, as in the reference, because the bias is finite.

:func:`plane_decode_attention_plain` is the same read in plain PyTorch —
the ``int4_bp`` cache format's plane math (integer scores by the
plane-interleaved contraction, masked softmax, V decoded to int4 values).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitplane
from repro_torch.core.bsdp import bsdp_matmul_planes
from repro_torch.kernels import _build

KERNEL = _build.CudaKernel(
    "plane_decode_attention", "plane_attn.cu", "plane_decode_attention",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 10
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    replaces="src/repro/kernels/plane_attn.py:141",
)


def _check(q_planes, q_scale, k_planes, k_scale, v_planes, v_scale, bias):
    b, h, g, p, fw = q_planes.shape
    l = k_planes.shape[1]
    want = {
        "q_scale": (q_scale, (b, h, g), torch.float32),
        "k_planes": (k_planes, (b, l, h, 4, fw), torch.int32),
        "k_scale": (k_scale, (b, l, h), torch.float32),
        "v_planes": (v_planes, (b, l, h, 4, fw), torch.int32),
        "v_scale": (v_scale, (b, l, h), torch.float32),
        "bias": (bias, (b, h, g, l), torch.float32),
    }
    if p != 4 or q_planes.dtype != torch.int32:
        raise ValueError(f"plane_decode_attention: q planes {tuple(q_planes.shape)} "
                         f"{q_planes.dtype}")
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"plane_decode_attention: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, want {shape} {dtype}")
        if t.device != q_planes.device:
            raise ValueError(f"plane_decode_attention: {name} on {t.device}")
    return b, h, g, l, fw


def plane_decode_attention_plain(q_planes, q_scale, k_planes, k_scale, v_planes,
                                 v_scale, bias, *, sm_scale: float,
                                 signed: bool = True) -> torch.Tensor:
    """Plain version → ``[B, Hkv, G, Fw·32]`` float32."""
    _check(q_planes, q_scale, k_planes, k_scale, v_planes, v_scale, bias)
    KERNEL.note_plain(q_planes)
    kp = k_planes.permute(0, 2, 1, 3, 4)  # [B, H, L, 4, Fw]
    s_int = bsdp_matmul_planes(q_planes, kp, signed=signed)  # [B, H, G, L]
    ks = k_scale.permute(0, 2, 1)
    vs = v_scale.permute(0, 2, 1)
    scores = (s_int.to(torch.float32) * q_scale[..., None] * ks[..., None, :]
              * sm_scale + bias)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    w = p / p.sum(dim=-1, keepdim=True)
    vals = bitplane.decode(v_planes.permute(0, 2, 1, 3, 4), signed=signed)
    return torch.einsum("bhgl,bhlf->bhgf", w * vs[..., None, :],
                        vals.to(torch.float32))


def plane_decode_attention(q_planes, q_scale, k_planes, k_scale, v_planes,
                           v_scale, bias, *, sm_scale: float,
                           signed: bool = True) -> torch.Tensor:
    """Fused plane-layout decode attention → ``[B, Hkv, G, Fw·32]`` float32.

    ``q_planes [B, Hkv, G, 4, Fw]`` / ``q_scale [B, Hkv, G]`` are the int4
    query planes (G folds chunk × group); K/V planes ``[B, L, Hkv, 4, Fw]``
    and scales ``[B, L, Hkv]`` are the cache as stored; ``bias
    [B, Hkv, G, L]`` is the additive mask (0 / -1e30), read through its
    strides (an expanded view is not copied).
    """
    b, h, g, l, fw = _check(q_planes, q_scale, k_planes, k_scale, v_planes,
                            v_scale, bias)
    if q_planes.device.type == "cpu":
        return plane_decode_attention_plain(
            q_planes, q_scale, k_planes, k_scale, v_planes, v_scale, bias,
            sm_scale=sm_scale, signed=signed)
    _build.require_cuda("plane_decode_attention", q_planes, q_scale, k_planes,
                        k_scale, v_planes, v_scale, bias)
    if k_planes.stride() != v_planes.stride() or k_scale.stride() != v_scale.stride():
        raise ValueError("plane_decode_attention: K and V must share one layout")
    if k_planes.stride(-1) != 1 or k_planes.stride(-2) != fw:
        raise ValueError("plane_decode_attention: each slot's [4, Fw] planes "
                         "must be contiguous")
    q = q_planes.contiguous()
    qs = q_scale.contiguous()
    out = torch.empty((b, h, g, fw * bitplane.WORD), dtype=torch.float32,
                      device=q.device)
    pb, pl_, ph = k_planes.stride()[:3]
    sb, sl, sh = k_scale.stride()
    KERNEL.launch(
        _build.ptr(q), _build.ptr(qs), _build.ptr(k_planes), _build.ptr(k_scale),
        _build.ptr(v_planes), _build.ptr(v_scale), _build.ptr(bias), _build.ptr(out),
        b, h, g, l, fw, pb, pl_, ph, sb, sl, sh, *bias.stride(), float(sm_scale),
        int(signed), _build.stream())
    return out
