"""W4A8 matmul with int4 weights packed two per byte, unpacked in the kernel.

Replaces ``repro/kernels/gemv_int4.py:_matmul_int4_kernel`` with
``_unpack_tile`` (``matmul_int4_packed``, the ``pallas_call`` at ``:76``)
with ``csrc/matmul_int4_packed.cu``.  At decode (M <= 16) it takes
``matmul_int8``'s route (``csrc/int8_decode.cuh``): K split over a
thread-block cluster, 16-byte loads of packed rows in flight, the nibbles
sign-extended in registers, a byte-permute transpose into ``__dp4a``, and
the partials summed in a fixed order.  At prefill each block unpacks its
packed weight tile into int8 rows in shared memory and contracts on the
tensor cores (64 × 64 tiles).  Both end in the W8A8 epilogue; the unpacked
weight never exists in device memory.  ``w4a8`` routes every projection
here.

On the card: bound by the packed weight's bytes (K·N/2, half of W8A8's) at
decode and by the 2·M·N·K int8 operations at prefill.

:func:`matmul_int4_packed_plain` is the same function in plain PyTorch:
:func:`repro_torch.core.quant.unpack_int4`, the exact integer sum, and the
same float32 epilogue, so kernel and plain version agree to the bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build
from repro_torch.kernels.gemv_int8 import check_scaled, scale_epilogue
from repro_torch.kernels.ref import dot_i32

KERNEL = _build.CudaKernel(
    "matmul_int4_packed", "matmul_int4_packed.cu", "matmul_int4_packed",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="src/repro/kernels/gemv_int4.py:76",
)


def matmul_int4_packed_plain(x: torch.Tensor, w_packed: torch.Tensor,
                             x_scale: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Plain version: unpack, exact int32 sums, float32 scale epilogue."""
    check_scaled("matmul_int4_packed", x, w_packed, x_scale, w_scale, k_per_row=2)
    KERNEL.note_plain(x)
    acc = dot_i32(x, quant.unpack_int4(w_packed, axis=0))
    return scale_epilogue(acc, x_scale, w_scale)


def matmul_int4_packed(x: torch.Tensor, w_packed: torch.Tensor, x_scale: torch.Tensor,
                       w_scale: torch.Tensor) -> torch.Tensor:
    """``x [M,K] int8 @ packed w [K/2,N]`` → f32 ``[M,N]`` with the per-token
    and per-channel scales fused (K even; row r of ``w_packed`` holds K = 2r
    in its low nibble and K = 2r+1 in its high nibble)."""
    m, n, k = check_scaled("matmul_int4_packed", x, w_packed, x_scale, w_scale,
                           k_per_row=2)
    if x.device.type == "cpu":
        return matmul_int4_packed_plain(x, w_packed, x_scale, w_scale)
    _build.require_cuda("matmul_int4_packed", x, w_packed, x_scale, w_scale)
    x, wp = x.contiguous(), w_packed.contiguous()
    xs = x_scale.reshape(-1).to(torch.float32).contiguous()
    ws = w_scale.reshape(-1).to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    KERNEL.launch(_build.ptr(x), _build.ptr(wp), _build.ptr(xs), _build.ptr(ws),
                  _build.ptr(out), m, n, k, _build.stream())
    return out
