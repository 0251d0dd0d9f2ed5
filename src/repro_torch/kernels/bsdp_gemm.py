"""Bit-plane GEMMs on the tensor cores (prefill and multi-slot decode).

Two kernels, as in the reference module, both on the binary tensor-core
instruction (``mma.sync`` m16n8k256 ``.b1 .and.popc``, one AND-popcount
over 256 K elements) fed the packed plane words as they lie, with K split
over a block's warps and 16 tokens a block above M = 4
(``csrc/bsdp_mma.cuh``, shared by both sources).  Its 16 A rows are 4
tokens × 4 activation planes.

``bsdp_gemm_fused`` replaces ``repro/kernels/bsdp_gemm.py:_bsdp_gemm_fused_kernel``
(``bsdp_gemm_fused``, the ``pallas_call`` at ``:197``) with
``csrc/bsdp_gemm_fused.cu``: ONE contraction over plane-interleaved rows.
The 8 B columns of a fragment are 2 weight columns × 4 weight planes (rows
``n·4+k`` of the weight viewed as ``[N·4, Kw]``, its memory layout), so one
instruction yields the pair table of 4 tokens × 2 columns, which the
``[4, 4]`` ``s_jk·2^(j+k)`` weights reduce into int32.  ``bsdp_fused``
routes M > 1 here.

``bsdp_gemm`` replaces ``repro/kernels/bsdp_gemm.py:_bsdp_gemm_kernel``
(``bsdp_gemm``, the ``pallas_call`` at ``:242``) with ``csrc/bsdp_gemm.cu``:
the unrolled form, the rung ``bsdp_fused`` is measured against, where each
of the 16 plane pairs is its own contraction (one chain per weight plane
over 8 weight columns), weighted by ``s_jk·2^(j+k)`` into int32.  ``bsdp``
routes M > 1 here.

On the card both are bound by the weight planes' bytes at decode (M =
slots) and take the same bytes and instructions per output.  Both are exact
integer sums, so they agree with each other to the bit.

:func:`bsdp_gemm_fused_plain` is the fused contraction in plain PyTorch
(:func:`repro_torch.core.bsdp.bsdp_matmul_planes`); :func:`bsdp_gemm_plain`
is the unrolled one: 16 plane-pair matmuls of 0/1 rows, weighted and summed.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bsdp import bits_to_int8, bsdp_matmul_planes, plane_weights
from repro_torch.kernels import _build
from repro_torch.kernels.bsdp_kernel import _check_planes, check_grouped_planes

KERNEL = _build.CudaKernel(
    "bsdp_gemm_fused", "bsdp_gemm_fused.cu", "bsdp_gemm_fused",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="src/repro/kernels/bsdp_gemm.py:197",
)
KERNEL_UNROLLED = _build.CudaKernel(
    "bsdp_gemm", "bsdp_gemm.cu", "bsdp_gemm",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="src/repro/kernels/bsdp_gemm.py:242",
)


def bsdp_gemm_fused_plain(x_planes: torch.Tensor, w_planes: torch.Tensor, *,
                          signed: bool = True) -> torch.Tensor:
    """Plain version: the plane-interleaved contraction + ``[4,4]`` reduce."""
    _check_planes("bsdp_gemm_fused", x_planes, w_planes)
    KERNEL.note_plain(x_planes)
    return bsdp_matmul_planes(x_planes, w_planes, signed=signed)


def bsdp_gemm_fused(x_planes: torch.Tensor, w_planes: torch.Tensor, *,
                    signed: bool = True) -> torch.Tensor:
    """``x_planes [M,4,Kw] × w_planes [N,4,Kw] → [M,N] int32`` (exact)."""
    m, n, kw = _check_planes("bsdp_gemm_fused", x_planes, w_planes)
    if x_planes.device.type == "cpu":
        return bsdp_gemm_fused_plain(x_planes, w_planes, signed=signed)
    _build.require_cuda("bsdp_gemm_fused", x_planes, w_planes)
    x = x_planes.contiguous()
    w = w_planes.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    KERNEL.launch(_build.ptr(x), _build.ptr(w), _build.ptr(out), 1, m, n, kw,
                  int(signed), _build.stream())
    return out


def bsdp_gemm_plain(x_planes: torch.Tensor, w_planes: torch.Tensor, *,
                    signed: bool = True) -> torch.Tensor:
    """Plain version of the unrolled form: per plane pair ``(j, k)`` one
    contraction of 0/1 rows (float32, exact below 2^24), weighted by
    ``s_jk·2^(j+k)`` into int32."""
    _check_planes("bsdp_gemm", x_planes, w_planes)
    KERNEL_UNROLLED.note_plain(x_planes)
    xbits = [bits_to_int8(x_planes[:, j]).to(torch.float32) for j in range(4)]
    wbits = [bits_to_int8(w_planes[:, k]).to(torch.float32) for k in range(4)]
    weight = plane_weights(signed).tolist()
    acc = torch.zeros((x_planes.shape[0], w_planes.shape[0]), dtype=torch.int32,
                      device=x_planes.device)
    for j in range(4):
        for k in range(4):
            acc += weight[j][k] * (xbits[j] @ wbits[k].T).to(torch.int32)
    return acc


def bsdp_gemm(x_planes: torch.Tensor, w_planes: torch.Tensor, *,
              signed: bool = True) -> torch.Tensor:
    """``x_planes [M,4,Kw] × w_planes [N,4,Kw] → [M,N] int32`` (exact), the
    unrolled 16-contraction form."""
    m, n, kw = _check_planes("bsdp_gemm", x_planes, w_planes)
    if x_planes.device.type == "cpu":
        return bsdp_gemm_plain(x_planes, w_planes, signed=signed)
    _build.require_cuda("bsdp_gemm", x_planes, w_planes)
    x = x_planes.contiguous()
    w = w_planes.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    KERNEL_UNROLLED.launch(_build.ptr(x), _build.ptr(w), _build.ptr(out), 1, m, n, kw,
                           int(signed), _build.stream())
    return out


def _grouped(kernel, plain, name):
    """The grouped form of one of the two GEMMs: ``G`` stacked products
    ``x_planes [G,M,4,Kw] × w_planes [G,N,4,Kw] → [G,M,N] int32`` in one
    launch, the groups on the grid's third axis (the experts of a MoE
    layer); on CPU tensors, ``plain`` once per group."""

    def grouped_plain(x_planes, w_planes, *, signed=True):
        check_grouped_planes(name, x_planes, w_planes)
        return torch.stack([plain(x, w, signed=signed) for x, w in zip(x_planes, w_planes)])

    def grouped(x_planes, w_planes, *, signed=True):
        g, m, n, kw = check_grouped_planes(name, x_planes, w_planes)
        if x_planes.device.type == "cpu":
            return grouped_plain(x_planes, w_planes, signed=signed)
        _build.require_cuda(name, x_planes, w_planes)
        x = x_planes.contiguous()
        w = w_planes.contiguous()
        out = torch.empty((g, m, n), dtype=torch.int32, device=x.device)
        kernel.launch(_build.ptr(x), _build.ptr(w), _build.ptr(out), g, m, n, kw,
                      int(signed), _build.stream())
        return out

    return grouped, grouped_plain


bsdp_gemm_fused_grouped, bsdp_gemm_fused_grouped_plain = _grouped(
    KERNEL, bsdp_gemm_fused_plain, "bsdp_gemm_fused")
bsdp_gemm_grouped, bsdp_gemm_grouped_plain = _grouped(
    KERNEL_UNROLLED, bsdp_gemm_plain, "bsdp_gemm")
