"""Public wrappers for the hand-written kernels — counterpart of
:mod:`repro.kernels.ops`.

Each wrapper takes the tensors its callers hold, pads what the kernel's
contract needs (K up to a whole 32-element plane word) and dispatches by
the tensor's device: a CPU tensor runs the kernel's plain PyTorch version,
a CUDA tensor launches the CUDA kernel or raises.  There is no fallback
from a failed build or launch to the plain version.

The CUDA kernels mask their own ragged M/N/K edges, so unlike the Pallas
wrappers nothing is padded to block multiples and no block sizes are
chosen here: each kernel picks its tile shape in its source.

Grouped entry points (``*_grouped``) take ``G`` stacked operands — the
experts of a MoE layer — and launch their kernel once, the groups on the
grid's third axis.

Counting: every kernel binding keeps ``launches``, incremented once per
launch that the driver accepted (:func:`launch_counts`).  The JAX package's
``kernel.dispatch`` counter fires at trace time and so counts call sites
per compiled program; the port has no tracing and counts executions.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bitplane
from repro_torch.core.quant import QuantTensor
from repro_torch.kernels import (
    _build,
    bsdp_gemm,
    bsdp_kernel,
    dequant_gemv,
    dim_kernel,
    gemv_int4,
    gemv_int8,
    plane_attn,
)

#: BSDP kernel name (as a residency format's KernelPolicy names it) → wrapper
_BSDP_KERNELS = {
    "gemv": bsdp_kernel.bsdp_matmul,
    "gemm": bsdp_gemm.bsdp_gemm,
    "gemm_fused": bsdp_gemm.bsdp_gemm_fused,
}
#: the same kernels' grouped launches (stacked expert weights)
_BSDP_GROUPED = {
    "gemv": bsdp_kernel.bsdp_matmul_grouped,
    "gemm": bsdp_gemm.bsdp_gemm_grouped,
    "gemm_fused": bsdp_gemm.bsdp_gemm_fused_grouped,
}


def launch_counts() -> dict[str, int]:
    """Kernel name → launches since the last :func:`reset_counts`."""
    return {name: k.launches for name, k in _build.KERNELS.items()}


def plain_cuda_counts() -> dict[str, int]:
    """Kernel name → calls of its plain version on CUDA tensors."""
    return {name: k.plain_cuda_calls for name, k in _build.KERNELS.items()}


def reset_counts() -> None:
    _build.reset_counts()


def quant_matmul(x: QuantTensor, w: QuantTensor, *,
                 out_int32: bool = False) -> torch.Tensor:
    """W8A8: ``x [M,K]`` per-token × ``w [K,N]`` per-channel → f32 ``[M,N]``
    (or the raw int32 sums with ``out_int32``)."""
    return gemv_int8.matmul_int8(x.data, w.data, x.scale, w.scale, out_int32=out_int32)


def quant_matmul_grouped(x: QuantTensor, w: QuantTensor) -> torch.Tensor:
    """W8A8 over ``G`` stacked experts in one launch: ``x [G,M,K]`` per-token
    × ``w [G,K,N]`` per-channel → f32 ``[G,M,N]``."""
    return gemv_int8.matmul_int8_grouped(x.data, w.data, x.scale, w.scale)


def matmul_int8_raw(x_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """Scale-free exact int32 W8A8 matmul (the ``out_int32`` kernel path)."""
    m, n = x_i8.shape[0], w_i8.shape[1]
    ones_m = torch.ones((m, 1), dtype=torch.float32, device=x_i8.device)
    ones_n = torch.ones((1, n), dtype=torch.float32, device=x_i8.device)
    return quant_matmul(QuantTensor(x_i8, ones_m, bits=8, axis=-1),
                        QuantTensor(w_i8, ones_n, bits=8, axis=0), out_int32=True)


def quant_matmul_int4(x: QuantTensor, w_packed: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """W4A8: ``x [M,K] int8 × packed w [K/2,N]`` → f32 ``[M,N]`` (K even)."""
    return gemv_int4.matmul_int4_packed(x.data, w_packed, x.scale, w_scale)


def dim_matmul(x_i8: torch.Tensor, w_i16: torch.Tensor) -> torch.Tensor:
    """Exact ``[M,K] int8 @ [K,N] int16 → int32`` via decomposed int8 passes."""
    return dim_kernel.matmul_w16a8(x_i8, w_i16)


def bsdp_kernel_for(m: int) -> str:
    """The registry-free batch default: the popcount GEMV at M == 1, the
    unrolled plane-pair GEMM at M > 1 (formats pick through their
    KernelPolicy instead)."""
    return "gemv" if m == 1 else "gemm"


def bsdp_matmul_planes(x_planes: torch.Tensor, w_planes: torch.Tensor, *,
                       kernel: Optional[str] = None, signed: bool = True,
                       fmt_name: Optional[str] = None) -> torch.Tensor:
    """Plane-form BSDP: ``[M,4,Kw] × [N,4,Kw] → int32 [M,N]`` (exact).

    ``kernel`` names the BSDP kernel (``"gemv"``, ``"gemm"`` or
    ``"gemm_fused"``), as a residency format's KernelPolicy picks it;
    ``None`` dispatches by batch (:func:`bsdp_kernel_for`).  ``fmt_name``
    names the format, so a misconfigured policy is traceable.
    """
    kernel = kernel or bsdp_kernel_for(x_planes.shape[0])
    if kernel not in _BSDP_KERNELS:
        via = (f" (requested via residency format {fmt_name!r}'s KernelPolicy)"
               if fmt_name else "")
        raise ValueError(f"unknown BSDP kernel {kernel!r}{via}; registered "
                         f"kernels: {sorted(_BSDP_KERNELS)}")
    return _BSDP_KERNELS[kernel](x_planes, w_planes, signed=signed)


def bsdp_matmul(x_i4: torch.Tensor, w_planes: torch.Tensor, *,
                kernel: Optional[str] = None, signed: bool = True,
                fmt_name: Optional[str] = None) -> torch.Tensor:
    """Raw int4 activations ``[M,K]`` × encoded weights ``[N,4,K/32]`` →
    int32 ``[M,N]``: the per-request activation encode, then the kernel."""
    x_planes = bitplane.encode_acts(bitplane.pad_to_word(x_i4))
    return bsdp_matmul_planes(x_planes, w_planes, signed=signed, kernel=kernel,
                              fmt_name=fmt_name)


def bsdp_matmul_grouped(x_i4: torch.Tensor, w_planes: torch.Tensor, *,
                        kernel: Optional[str] = None, signed: bool = True,
                        fmt_name: Optional[str] = None) -> torch.Tensor:
    """Raw int4 activations ``[G,M,K]`` × stacked encoded weights
    ``[G,N,4,K/32]`` → int32 ``[G,M,N]``: the activation encode, then one
    grouped launch of the BSDP kernel ``kernel`` (as for
    :func:`bsdp_matmul_planes`, by M when None)."""
    g, m, k = x_i4.shape
    x_planes = bitplane.encode_acts(bitplane.pad_to_word(x_i4.reshape(g * m, k)))
    kernel = kernel or bsdp_kernel_for(m)
    if kernel not in _BSDP_GROUPED:
        via = (f" (requested via residency format {fmt_name!r}'s KernelPolicy)"
               if fmt_name else "")
        raise ValueError(f"unknown BSDP kernel {kernel!r}{via}; registered "
                         f"kernels: {sorted(_BSDP_GROUPED)}")
    return _BSDP_GROUPED[kernel](x_planes.reshape(g, m, *x_planes.shape[1:]), w_planes,
                                 signed=signed)


def bsdp_gemv(x_i4: torch.Tensor, w_planes: torch.Tensor, *,
              signed: bool = True) -> torch.Tensor:
    """The reference's name for :func:`bsdp_matmul` (its entry point from
    before the GEMM kernels), kept as an alias."""
    return bsdp_matmul(x_i4, w_planes, signed=signed)


def weight_only_matmul(x: torch.Tensor, w_i8: torch.Tensor,
                       w_scale: torch.Tensor) -> torch.Tensor:
    """W8A16: ``x [M,K] f32 or bf16 × w [K,N] int8`` (per-channel scale) →
    f32; the kernel widens ``x`` itself."""
    return dequant_gemv.dequant_matmul(x, w_i8, w_scale)


def plane_decode_attention(q_planes, q_scale, k_planes, k_scale, v_planes,
                           v_scale, bias, *, sm_scale: float,
                           feat: int) -> torch.Tensor:
    """Fused bit-plane decode attention → ``[B, Hkv, G, feat]`` float32; the
    word-padded feature axis is sliced back to ``feat`` here."""
    out = plane_attn.plane_decode_attention(
        q_planes, q_scale, k_planes, k_scale, v_planes, v_scale, bias,
        sm_scale=sm_scale)
    return out[..., :feat]
