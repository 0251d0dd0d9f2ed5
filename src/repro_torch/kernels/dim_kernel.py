"""W16A8 decomposed-integer-multiplication (DIM) matmul — §III-C.

Replaces ``repro/kernels/dim_kernel.py:_dim_kernel`` (``matmul_w16a8``, the
``pallas_call`` at ``:74``) with ``csrc/matmul_w16a8.cu``.  No int8 unit
takes int16, so the int16 weight is split in the kernel into its signed
high byte ``hi = w >> 8`` and its low byte, and contracted in two int8
passes.  At decode (M <= 16) the weight is read as the int8 matrix of its
bytes and the low byte is taken unsigned by the mixed-sign ``__dp4a``::

    x @ w = 256·(x @ hi) + x @ lo                        (mod 2^32)

and at prefill the tensor cores take the centred low byte
``lo_c = (w & 0xFF) - 128``::

    x @ w = 256·(x @ hi) + x @ lo_c + 128·rowsum(x)      (mod 2^32)

Exact: the result is defined modulo 2^32, as the reference's int32
arithmetic wraps, and every sum in the kernel is taken modulo 2^32.

On the card: bound by the int16 weight's bytes (2·K·N) at decode and by the
two int8 passes (4·M·N·K operations) at prefill.

:func:`matmul_w16a8_plain` is the kernel's decomposition in plain PyTorch:
the two passes and the row-sum correction as exact integer sums, combined
in int64 and wrapped to int32.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.dim import dot_i64, wrap_i32
from repro_torch.kernels import _build

KERNEL = _build.CudaKernel(
    "matmul_w16a8", "matmul_w16a8.cu", "matmul_w16a8",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="src/repro/kernels/dim_kernel.py:74",
)

#: each int8 pass sums K terms of magnitude <= 128·128 in int32
MAX_K = (2**31 - 1) // (128 * 128)


def _check(x, w):
    if x.dtype != torch.int8 or w.dtype != torch.int16:
        raise TypeError(f"matmul_w16a8: want int8 x and int16 w, got {x.dtype}, {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_w16a8: bad shapes {tuple(x.shape)}, {tuple(w.shape)}")
    if x.shape[1] > MAX_K:
        raise ValueError(f"matmul_w16a8: K={x.shape[1]} exceeds the int32-exact pass "
                         f"bound {MAX_K}; split the contraction")
    if x.device != w.device:
        raise ValueError("matmul_w16a8: operands on different devices")
    return x.shape[0], w.shape[1], x.shape[1]


def matmul_w16a8_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``256·(x @ hi) + x @ lo_c + 128·rowsum(x)``, wrapped."""
    _check(x, w)
    KERNEL.note_plain(x)
    w32 = w.to(torch.int32)
    hi = w32 >> 8
    lo_c = (w32 & 0xFF) - 128
    row_sum = x.to(torch.int64).sum(dim=1, keepdim=True)
    return wrap_i32((dot_i64(x, hi) << 8) + dot_i64(x, lo_c) + (row_sum << 7))


def matmul_w16a8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact ``x [M,K] int8 @ w [K,N] int16`` → int32 ``[M,N]`` (mod 2^32)."""
    m, n, k = _check(x, w)
    if x.device.type == "cpu":
        return matmul_w16a8_plain(x, w)
    _build.require_cuda("matmul_w16a8", x, w)
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    KERNEL.launch(_build.ptr(x), _build.ptr(w), _build.ptr(out), m, n, k, _build.stream())
    return out
