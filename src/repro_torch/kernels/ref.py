"""Plain oracles for the kernels — counterpart of :mod:`repro.kernels.ref`.

No tiling, no plane algebra beyond the definition: these define
correctness.  Integer contractions are exact
(:func:`repro_torch.core.dim.dot_i64`, a float64 matmul) and then wrapped
to int32 modulo 2^32, as the reference's int32 dot wraps: a DIM sum can
leave the int32 range, where a plain float → int32 cast would saturate.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitplane, quant
from repro_torch.core.bsdp import bsdp_popcount
from repro_torch.core.dim import dot_i64, wrap_i32


def dot_i32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's int32 dot: exact, wrapped modulo 2^32."""
    return wrap_i32(dot_i64(x, w))


def matmul_int8_ref(x_i8, w_i8) -> torch.Tensor:
    """W8A8: ``[M,K] int8 @ [K,N] int8 → [M,N] int32`` (exact)."""
    return dot_i32(x_i8, w_i8)


def matmul_int8_scaled_ref(x_i8, w_i8, x_scale, w_scale) -> torch.Tensor:
    """W8A8 with per-token ``[M,1]`` and per-channel ``[1,N]`` scales → f32."""
    return (matmul_int8_ref(x_i8, w_i8).to(torch.float32) * x_scale.reshape(-1, 1)
            * w_scale.reshape(1, -1))


def matmul_int4_packed_ref(x_i8, w_packed) -> torch.Tensor:
    """W4A8 with weights packed two per byte along K: ``[M,K] @ packed[K/2,N]``."""
    return dot_i32(x_i8, quant.unpack_int4(w_packed, axis=0))


def dim_w16a8_ref(x_i8, w_i16) -> torch.Tensor:
    """DIM oracle: the wide integer matmul, wrapped to int32."""
    return dot_i32(x_i8, w_i16)


def bsdp_ref(x_i4, w_i4, *, signed: bool = True) -> torch.Tensor:
    """BSDP oracle, the definition: ``x_i4 [M,K] × w_i4 [K,N]`` (int4 values
    in an int8 payload, signs carried by the values) → int32 ``[M,N]``."""
    del signed
    return dot_i32(x_i4, w_i4)


def bsdp_planes_ref(x_planes, w_planes, *, signed: bool = True) -> torch.Tensor:
    """Algorithm 2 in its clarity form: ``[M,4,Kw] × [N,4,Kw] → [M,N]``."""
    return bsdp_popcount(x_planes[:, None], w_planes[None], signed=signed)


def bsdp_gemm_ref(x_planes, w_planes, *, signed: bool = True) -> torch.Tensor:
    """Decode both plane tensors and contract in integers."""
    x = bitplane.decode(x_planes, signed=signed)
    w = bitplane.decode(w_planes, signed=signed)
    return dot_i32(x, w.T)


def dequant_matmul_ref(x, w_i8, w_scale) -> torch.Tensor:
    """W8A16: dequantize, then matmul in float32 (reference order)."""
    w = w_i8.to(torch.float32) * w_scale.reshape(1, -1)
    return x.to(torch.float32) @ w


def decode_weights_ref(w_planes, *, signed: bool = True) -> torch.Tensor:
    """``[N, 4, Kw]`` planes → ``[K, N]`` int8 — layout round-trip oracle."""
    return bitplane.decode(w_planes, signed=signed).T
