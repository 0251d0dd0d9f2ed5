"""Bit-serial dot-product GEMV — the faithful port of §IV Algorithm 2.

Replaces ``repro/kernels/bsdp_kernel.py:_bsdp_kernel`` (``bsdp_matmul``,
the ``pallas_call`` at ``:94``) with ``csrc/bsdp_gemv.cu``: ``__popc`` on
the 32-bit ANDs of activation and weight plane words, the counterpart of
UPMEM's ``cao``, with the 16 plane pairs weighted by ±2^(j+k) into an int32
sum.  The bit-plane formats route M == 1 here, and ``w4a4_bsdp`` every M.

On the card the kernel is bound by device-memory bytes of the weight planes
(N·4·Kw·4 B per call) at M = 1, and by the integer issue rate of the
popcounts at M > 1: 16 lanes share a column, each loading a 16-byte slice
of its four plane rows, the next K pass's loads in flight while one is
contracted; one block per 16 columns and row of x walks the whole K.

:func:`bsdp_matmul_plain` is the same function in plain PyTorch (AND +
SWAR popcount); :func:`bsdp_matmul` runs it for CPU tensors and launches
the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bsdp import bsdp_popcount
from repro_torch.kernels import _build

KERNEL = _build.CudaKernel(
    "bsdp_gemv", "bsdp_gemv.cu", "bsdp_gemv",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="src/repro/kernels/bsdp_kernel.py:94",
)


def _check_planes(name, x_planes, w_planes):
    if x_planes.dtype != torch.int32 or w_planes.dtype != torch.int32:
        raise TypeError(f"{name}: planes must be int32 words, got "
                        f"{x_planes.dtype}, {w_planes.dtype}")
    m, px, kw = x_planes.shape
    n, pw, kw2 = w_planes.shape
    if px != 4 or pw != 4 or kw != kw2:
        raise ValueError(f"{name}: bad plane shapes {tuple(x_planes.shape)} "
                         f"× {tuple(w_planes.shape)}")
    if x_planes.device != w_planes.device:
        raise ValueError(f"{name}: planes on {x_planes.device} and {w_planes.device}")
    return m, n, kw


def check_grouped_planes(name, x_planes, w_planes):
    """Shapes of a grouped call, ``x [G, M, 4, Kw] × w [G, N, 4, Kw]``;
    returns ``(g, m, n, kw)``."""
    if x_planes.ndim != 4 or w_planes.ndim != 4 or x_planes.shape[0] != w_planes.shape[0]:
        raise ValueError(f"{name}: bad grouped plane shapes {tuple(x_planes.shape)} "
                         f"× {tuple(w_planes.shape)}")
    return (x_planes.shape[0], *_check_planes(name, x_planes[0], w_planes[0]))


def bsdp_matmul_plain(x_planes: torch.Tensor, w_planes: torch.Tensor, *,
                      signed: bool = True) -> torch.Tensor:
    """Plain version: ``[M,4,Kw] × [N,4,Kw] → [M,N]`` int32 by AND + popcount."""
    _check_planes("bsdp_gemv", x_planes, w_planes)
    KERNEL.note_plain(x_planes)
    return bsdp_popcount(x_planes[:, None], w_planes[None], signed=signed)


def bsdp_matmul(x_planes: torch.Tensor, w_planes: torch.Tensor, *,
                signed: bool = True) -> torch.Tensor:
    """``x_planes [M,4,Kw] × w_planes [N,4,Kw] → [M,N] int32`` (exact)."""
    m, n, kw = _check_planes("bsdp_gemv", x_planes, w_planes)
    if x_planes.device.type == "cpu":
        return bsdp_matmul_plain(x_planes, w_planes, signed=signed)
    _build.require_cuda("bsdp_gemv", x_planes, w_planes)
    x = x_planes.contiguous()
    w = w_planes.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    KERNEL.launch(_build.ptr(x), _build.ptr(w), _build.ptr(out), 1, m, n, kw,
                  int(signed), _build.stream())
    return out


def bsdp_matmul_grouped_plain(x_planes: torch.Tensor, w_planes: torch.Tensor, *,
                              signed: bool = True) -> torch.Tensor:
    """Plain version of the grouped call: :func:`bsdp_matmul_plain` once per
    group."""
    check_grouped_planes("bsdp_gemv", x_planes, w_planes)
    return torch.stack([bsdp_matmul_plain(x, w, signed=signed)
                        for x, w in zip(x_planes, w_planes)])


def bsdp_matmul_grouped(x_planes: torch.Tensor, w_planes: torch.Tensor, *,
                        signed: bool = True) -> torch.Tensor:
    """``G`` stacked products ``x_planes [G,M,4,Kw] × w_planes [G,N,4,Kw] →
    [G,M,N] int32`` in one launch, the groups on the grid's third axis (the
    experts of a MoE layer)."""
    g, m, n, kw = check_grouped_planes("bsdp_gemv", x_planes, w_planes)
    if x_planes.device.type == "cpu":
        return bsdp_matmul_grouped_plain(x_planes, w_planes, signed=signed)
    _build.require_cuda("bsdp_gemv", x_planes, w_planes)
    x = x_planes.contiguous()
    w = w_planes.contiguous()
    out = torch.empty((g, m, n), dtype=torch.int32, device=x.device)
    KERNEL.launch(_build.ptr(x), _build.ptr(w), _build.ptr(out), g, m, n, kw,
                  int(signed), _build.stream())
    return out
