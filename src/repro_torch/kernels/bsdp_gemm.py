"""Bit-plane GEMMs on the tensor cores (prefill and multi-slot decode).

Two kernels, as in the reference module.

``bsdp_gemm_fused`` replaces ``repro/kernels/bsdp_gemm.py:_bsdp_gemm_fused_kernel``
(``bsdp_gemm_fused``, the ``pallas_call`` at ``:197``) with
``csrc/bsdp_gemm_fused.cu``: each block unpacks its activation and weight
plane tiles into plane-interleaved 0/1 int8 rows in shared memory (row
``r·4+j`` holds plane ``j`` of row ``r``), runs ONE int8 tensor-core
contraction (``nvcuda::wmma`` s8, m16n16k16) into the ``[BM·4, BN·4]`` pair
table, and reduces it with the ``[4, 4]`` ``s_jk·2^(j+k)`` weights into
int32.  The K loop runs inside the block, so nothing carries between
blocks.  ``bsdp_fused`` routes M > 1 here.

``bsdp_gemm`` replaces ``repro/kernels/bsdp_gemm.py:_bsdp_gemm_kernel``
(``bsdp_gemm``, the ``pallas_call`` at ``:242``) with ``csrc/bsdp_gemm.cu``:
the unrolled form, the rung ``bsdp_fused`` is measured against, where each
of the 16 plane pairs is its own contraction, weighted by ``s_jk·2^(j+k)``
into int32.  The plane words go packed into the binary tensor-core
instruction (``mma.sync`` m16n8k256 ``.b1 .and.popc``, one AND-popcount over
256 K elements), K split over a block's warps, 16 tokens a block above
M = 4.  ``bsdp`` routes M > 1 here.

On the card both are bound by the weight planes' bytes at decode (M =
slots); at prefill the fused kernel is bound by its 16·M·N·K int8
tensor-core operations.  Both are exact integer sums, so they agree with
each other to the bit.

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
