"""W8A16 weight-only matmul with the dequantize fused into the kernel.

Replaces ``repro/kernels/dequant_gemv.py:_dequant_matmul_kernel``
(``dequant_matmul``, the ``pallas_call`` at ``:62``) with
``csrc/dequant_matmul.cu``: the int8 weight is loaded as int8 and widened
to float32 in registers, the activations (float32 or bfloat16, the model's
working type) are widened there too, the contraction accumulates in
float32 and the per-channel scale is applied in the epilogue.  No
dequantized weight and no float32 copy of the activations is ever
materialised in device memory.  ``w8a16`` routes every attention
projection here.

On the card: bound by the int8 weight's bytes (K·N) at decode — the decode
route (M <= 16) splits K over a cluster of blocks whose partial sums meet
through distributed shared memory — and by the float32 multiply-adds at
prefill — the prefill route (M > 16) tiles 64 × 64 outputs and stages
operand tiles by ``cp.async``.  Every sum is taken in a fixed order, so
the result is deterministic.  Either route is one launch.

:func:`dequant_matmul_plain` is the reference order in plain PyTorch
(widen, dequantize, then a float32 matmul —
``repro.kernels.ref.dequant_matmul_ref``); it differs from the kernel's
(matmul, then scale) by float rounding only.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KERNEL = _build.CudaKernel(
    "dequant_matmul", "dequant_matmul.cu", "dequant_matmul",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    replaces="src/repro/kernels/dequant_gemv.py:62",
)


#: activation types the kernel widens itself
X_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, w_i8, w_scale):
    if x.dtype not in X_DTYPES or w_i8.dtype != torch.int8:
        raise TypeError(f"dequant_matmul: want float32 or bfloat16 x and int8 w, "
                        f"got {x.dtype}, {w_i8.dtype}")
    m, k = x.shape
    k2, n = w_i8.shape
    if k != k2 or w_scale.numel() != n:
        raise ValueError(f"dequant_matmul: bad shapes {tuple(x.shape)}, "
                         f"{tuple(w_i8.shape)}, scale {tuple(w_scale.shape)}")
    if not (x.device == w_i8.device == w_scale.device):
        raise ValueError("dequant_matmul: operands on different devices")
    return m, n, k


def dequant_matmul_plain(x: torch.Tensor, w_i8: torch.Tensor,
                         w_scale: torch.Tensor) -> torch.Tensor:
    """Plain version: ``float(x [M,K]) @ (w [K,N] int8 · scale [N]) → f32``."""
    _check(x, w_i8, w_scale)
    KERNEL.note_plain(x)
    w = w_i8.to(torch.float32) * w_scale.reshape(1, -1).to(torch.float32)
    return x.to(torch.float32) @ w


def dequant_matmul(x: torch.Tensor, w_i8: torch.Tensor,
                   w_scale: torch.Tensor) -> torch.Tensor:
    """``[M,K] f32/bf16 @ int8 [K,N] (per-channel scale [N]) → f32 [M,N]``."""
    m, n, k = _check(x, w_i8, w_scale)
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, w_i8, w_scale)
    _build.require_cuda("dequant_matmul", x, w_i8, w_scale)
    x = x.contiguous()
    w = w_i8.contiguous()
    s = w_scale  # read as N contiguous floats: [N] or [1, N]
    if s.dtype != torch.float32 or not s.is_contiguous():
        s = s.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    KERNEL.launch(_build.ptr(x), _build.ptr(w), _build.ptr(s), _build.ptr(out),
                  m, n, k, int(x.dtype == torch.bfloat16), _build.stream())
    return out
