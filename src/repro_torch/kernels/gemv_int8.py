"""W8A8 int8 x int8 matmul on the tensor cores, scales fused.

Replaces ``repro/kernels/gemv_int8.py:_matmul_int8_kernel`` and
``_matmul_int8_kernel_i32`` (``matmul_int8``, the ``pallas_call`` at
``:81``) with ``csrc/matmul_int8.cu``: both operands stay int8 (the §III-B
native-instruction path) and the sums exact int32 — at M <= 16 (decode) by
``__dp4a`` over K split across a thread-block cluster, above by the int8
tensor cores — and the epilogue applies ``(float(acc) · x_scale[m]) ·
w_scale[n]`` once on the whole sum in the reference's order, or, with
``out_int32``, writes the raw int32 sums.  ``w8a8`` routes every projection
here.

On the card: bound by the int8 weight's bytes (K·N) at decode and by the
2·M·N·K int8 operations at prefill (see the source's header for the design).

:func:`matmul_int8_plain` is the same function in plain PyTorch: the exact
integer sum (:func:`repro_torch.kernels.ref.dot_i32`), then the same float32
epilogue in the same order, so kernel and plain version agree to the bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dot_i32

KERNEL = _build.CudaKernel(
    "matmul_int8", "matmul_int8.cu", "matmul_int8",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="src/repro/kernels/gemv_int8.py:81",
)


def check_scaled(name, x, w, x_scale, w_scale, *, k_per_row: int = 1):
    """Shapes, types and devices of an int8 activation ``x [M, K]``, an int8
    weight with ``K / k_per_row`` rows, a per-token scale of ``M`` values and
    a per-channel scale of ``N`` values; returns ``(m, n, k)``."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{name}: want int8 x and w, got {x.dtype}, {w.dtype}")
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"{name}: want 2-D x and w, got {tuple(x.shape)}, {tuple(w.shape)}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2 * k_per_row or x_scale.numel() != m or w_scale.numel() != n:
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"scales {tuple(x_scale.shape)}, {tuple(w_scale.shape)}")
    if not (x.device == w.device == x_scale.device == w_scale.device):
        raise ValueError(f"{name}: operands on different devices")
    return m, n, k


def scale_epilogue(acc: torch.Tensor, x_scale: torch.Tensor,
                   w_scale: torch.Tensor) -> torch.Tensor:
    """``(float(acc) · x_scale[m]) · w_scale[n]`` in float32, the reference's order."""
    return (acc.to(torch.float32) * x_scale.reshape(-1, 1).to(torch.float32)
            * w_scale.reshape(1, -1).to(torch.float32))


def matmul_int8_plain(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                      w_scale: torch.Tensor, *, out_int32: bool = False) -> torch.Tensor:
    """Plain version: exact int32 sums, then the float32 scale epilogue."""
    check_scaled("matmul_int8", x, w, x_scale, w_scale)
    KERNEL.note_plain(x)
    acc = dot_i32(x, w)
    return acc if out_int32 else scale_epilogue(acc, x_scale, w_scale)


def matmul_int8(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *, out_int32: bool = False) -> torch.Tensor:
    """``x [M,K] int8 @ w [K,N] int8`` → f32 ``[M,N]`` with the per-token
    ``x_scale`` (M values) and per-channel ``w_scale`` (N values) fused, or
    the raw int32 sums with ``out_int32``."""
    m, n, k = check_scaled("matmul_int8", x, w, x_scale, w_scale)
    if x.device.type == "cpu":
        return matmul_int8_plain(x, w, x_scale, w_scale, out_int32=out_int32)
    _build.require_cuda("matmul_int8", x, w, x_scale, w_scale)
    x, w = x.contiguous(), w.contiguous()
    xs = x_scale.reshape(-1).to(torch.float32).contiguous()
    ws = w_scale.reshape(-1).to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.int32 if out_int32 else torch.float32,
                      device=x.device)
    KERNEL.launch(_build.ptr(x), _build.ptr(w), _build.ptr(xs), _build.ptr(ws),
                  _build.ptr(out), 1, m, n, k, int(out_int32), _build.stream())
    return out


def _check_grouped(x, w, x_scale, w_scale):
    """``x [G, M, K]``, ``w [G, K, N]``, ``x_scale`` of G·M and ``w_scale`` of
    G·N values; returns ``(g, m, n, k)``."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] or \
            x_scale.shape[0] != x.shape[0] or w_scale.shape[0] != x.shape[0]:
        raise ValueError(f"matmul_int8: bad grouped shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, scales {tuple(x_scale.shape)}, "
                         f"{tuple(w_scale.shape)}")
    return (x.shape[0], *check_scaled("matmul_int8", x[0], w[0], x_scale[0], w_scale[0]))


def matmul_int8_grouped_plain(x, w, x_scale, w_scale, *, out_int32: bool = False
                              ) -> torch.Tensor:
    """Plain version of the grouped call: :func:`matmul_int8_plain` once per
    group."""
    _check_grouped(x, w, x_scale, w_scale)
    return torch.stack([matmul_int8_plain(*args, out_int32=out_int32)
                        for args in zip(x, w, x_scale, w_scale)])


def matmul_int8_grouped(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                        w_scale: torch.Tensor, *, out_int32: bool = False) -> torch.Tensor:
    """``G`` stacked products ``x [G,M,K] int8 @ w [G,K,N] int8`` → f32
    ``[G,M,N]``, each with its per-token and per-channel scales (``x_scale``
    ``[G, M, ...]``, ``w_scale`` ``[G, ..., N]``), in one launch, the groups on
    the grid's third axis (the experts of a MoE layer); or the raw int32
    sums with ``out_int32``."""
    g, m, n, k = _check_grouped(x, w, x_scale, w_scale)
    if x.device.type == "cpu":
        return matmul_int8_grouped_plain(x, w, x_scale, w_scale, out_int32=out_int32)
    _build.require_cuda("matmul_int8", x, w, x_scale, w_scale)
    x, w = x.contiguous(), w.contiguous()
    xs = x_scale.reshape(g, m).to(torch.float32).contiguous()
    ws = w_scale.reshape(g, n).to(torch.float32).contiguous()
    out = torch.empty((g, m, n), dtype=torch.int32 if out_int32 else torch.float32,
                      device=x.device)
    KERNEL.launch(_build.ptr(x), _build.ptr(w), _build.ptr(xs), _build.ptr(ws),
                  _build.ptr(out), g, m, n, k, int(out_int32), _build.stream())
    return out
