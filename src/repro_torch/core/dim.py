"""Decomposed Integer Multiplication (DIM) — the paper's §III-C, for matmuls.

Counterpart of :mod:`repro.core.dim`.  The card's tensor cores contract
int8 x int8 → int32 natively but have no int16 or int32 mode, so a
wide-precision matmul is built from byte-plane int8 passes::

    W (int16)  =  256·W_hi (int8, signed)  +  W_lo (uint8)
    x @ W      =  256·(x @ W_hi)           +  (x @ W_lo)

and for int32 weights four planes with shifts 0/8/16/24 (top plane signed,
lower planes unsigned).  Each pass is exact in int32 while |x| <= 127 and
the plane magnitude <= 255, i.e. for K up to :data:`MAX_K_PER_PASS`.  The
combined result is the int32 two's-complement wrap of the true product,
exactly as the reference's int32 arithmetic gives it.

Plain PyTorch: the passes run as exact integer contractions
(:func:`dot_i64`) and combine in int64 before the wrap (:func:`wrap_i32`),
since shifts that overflow int32 are not defined for torch tensors.  The
hand-written kernel for W16A8 is :mod:`repro_torch.kernels.dim_kernel`.
"""

from __future__ import annotations

import torch

#: max contraction length per int8·uint8 accumulation pass (int32-safe)
MAX_K_PER_PASS = (2**31 - 1) // (127 * 255)


def dot_i64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer ``x [..., K] @ w [K, N]`` → int64.

    Runs as a float64 matmul (PyTorch has no integer matmul on CUDA): for
    int8 x int16 operands each product is below 2^22 and every partial sum
    an integer below 2^53 at any K this package sees, so the sum is exact
    in any order."""
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(torch.int64)


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """Exact int64 values → int32 two's complement, modulo 2^32 (a plain
    cast would saturate or be undefined outside the int32 range)."""
    return (torch.remainder(v + 2**31, 2**32) - 2**31).to(torch.int32)


def decompose_int16(w: torch.Tensor):
    """Split int16 → (hi int8 signed, lo uint8): ``w == 256*hi + lo`` exactly."""
    w32 = w.to(torch.int32)
    hi = (w32 >> 8).to(torch.int8)  # arithmetic shift keeps the sign
    lo = (w32 & 0xFF).to(torch.uint8)
    return hi, lo


def compose_int16(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return (hi.to(torch.int32) * 256 + lo.to(torch.int32)).to(torch.int16)


def decompose_int32(w: torch.Tensor):
    """Split int32 → 4 byte planes (b3 signed int8, b2..b0 uint8)."""
    w = w.to(torch.int32)
    b3 = (w >> 24).to(torch.int8)
    b2 = ((w >> 16) & 0xFF).to(torch.uint8)
    b1 = ((w >> 8) & 0xFF).to(torch.uint8)
    b0 = (w & 0xFF).to(torch.uint8)
    return b3, b2, b1, b0


def _check_k(k: int) -> None:
    if k > MAX_K_PER_PASS:
        raise ValueError(
            f"contraction K={k} exceeds the int32-safe bound {MAX_K_PER_PASS}; "
            "split the contraction")


def matmul_w16a8(x_i8: torch.Tensor, w_i16: torch.Tensor) -> torch.Tensor:
    """Exact ``x_i8 [..., K] @ w_i16 [K, N]`` → int32 via two byte-plane passes."""
    _check_k(x_i8.shape[-1])
    hi, lo = decompose_int16(w_i16)
    return wrap_i32((dot_i64(x_i8, hi) << 8) + dot_i64(x_i8, lo))


def matmul_w32a8(x_i8: torch.Tensor, w_i32: torch.Tensor) -> torch.Tensor:
    """Exact ``x_i8 [..., K] @ w_i32 [K, N]`` → int32, wrapped modulo 2^32
    like the paper's 32-bit register (the true product can exceed int32)."""
    _check_k(x_i8.shape[-1])
    b3, b2, b1, b0 = decompose_int32(w_i32)
    acc = dot_i64(x_i8, b0)
    acc = acc + (dot_i64(x_i8, b1) << 8)
    acc = acc + (dot_i64(x_i8, b2) << 16)
    acc = acc + (dot_i64(x_i8, b3) << 24)
    return wrap_i32(acc)
