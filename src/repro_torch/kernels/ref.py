"""Plain oracles for the kernels — counterpart of :mod:`repro.kernels.ref`.

No tiling, no plane algebra beyond the definition: these define
correctness.  Integer contractions run as float64 matmuls, which are exact
for int4/int8 operands at every K this package sees (|sum| < 2^53) and work
on both the CPU and CUDA (PyTorch has no integer matmul on CUDA).
"""

from __future__ import annotations

import torch

from repro_torch.core import bitplane
from repro_torch.core.bsdp import bsdp_popcount


def _dot_i32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(torch.int32)


def bsdp_planes_ref(x_planes, w_planes, *, signed: bool = True) -> torch.Tensor:
    """Algorithm 2 in its clarity form: ``[M,4,Kw] × [N,4,Kw] → [M,N]``."""
    return bsdp_popcount(x_planes[:, None], w_planes[None], signed=signed)


def bsdp_gemm_ref(x_planes, w_planes, *, signed: bool = True) -> torch.Tensor:
    """Decode both plane tensors and contract in integers."""
    x = bitplane.decode(x_planes, signed=signed)
    w = bitplane.decode(w_planes, signed=signed)
    return _dot_i32(x, w.T)


def dequant_matmul_ref(x, w_i8, w_scale) -> torch.Tensor:
    """W8A16: dequantize, then matmul in float32 (reference order)."""
    w = w_i8.to(torch.float32) * w_scale.reshape(1, -1)
    return x.to(torch.float32) @ w


def decode_weights_ref(w_planes, *, signed: bool = True) -> torch.Tensor:
    """``[N, 4, Kw]`` planes → ``[K, N]`` int8 — layout round-trip oracle."""
    return bitplane.decode(w_planes, signed=signed).T
