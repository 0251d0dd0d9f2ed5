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
from repro_torch.kernels.bsdp_kernel import _check_planes

KERNEL = _build.CudaKernel(
    "bsdp_gemm_fused", "bsdp_gemm_fused.cu", "bsdp_gemm_fused",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    replaces="src/repro/kernels/bsdp_gemm.py:197",
)
KERNEL_UNROLLED = _build.CudaKernel(
    "bsdp_gemm", "bsdp_gemm.cu", "bsdp_gemm",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
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
    KERNEL.launch(_build.ptr(x), _build.ptr(w), _build.ptr(out), m, n, kw,
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
    KERNEL_UNROLLED.launch(_build.ptr(x), _build.ptr(w), _build.ptr(out), m, n, kw,
                           int(signed), _build.stream())
    return out
