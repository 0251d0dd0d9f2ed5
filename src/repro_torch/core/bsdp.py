"""Bit-serial dot product (BSDP) math — the paper's Algorithm 2, exactly.

Counterpart of :mod:`repro.core.bsdp`.  For bit-plane encodings ``a`` and
``b`` (``[..., 4, Kw]`` int32 words, see :mod:`repro_torch.core.bitplane`)
the dot product of the underlying int4 vectors is

    A·B = Σ_{j,k} s_jk · 2^{j+k} · popcount(a_plane_j AND b_plane_k)

with ``s_jk = -1`` iff exactly one of j, k equals 3 (two's complement),
``+1`` otherwise.  For unsigned uint4 all signs are +1.

Two plain forms, both integer-exact:

* :func:`bsdp_popcount` — AND + popcount, the faithful UPMEM form.  PyTorch
  has no popcount op, so the count is the SWAR bit trick, done on the
  words widened to int64 (masked to their 32 unsigned bits) so that no
  shift smears a sign bit and no product overflows.
* :func:`bsdp_matmul_planes` — planes unpacked to 0/1 rows interleaved by
  plane, ONE contraction for all 16 plane pairs, then the ``[4, 4]``
  weighted reduce.  The contraction runs as a float32 matmul of 0/1
  values: every partial sum is an integer below 2^24 for K < 2^24, so the
  float result is exact (and PyTorch has no integer matmul on CUDA).

:func:`bsdp_gemv` is the end-to-end GEMV from raw int4 activations in
either form; :func:`bsdp_gemv_popcount` its popcount form on planes.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitplane

#: sign[j, k] for signed int4 two's complement.
SIGN_SIGNED = [[1 if ((j == 3) == (k == 3)) else -1 for k in range(4)] for j in range(4)]
SIGN_UNSIGNED = [[1] * 4 for _ in range(4)]


def plane_signs(signed: bool):
    return SIGN_SIGNED if signed else SIGN_UNSIGNED


def plane_weights(signed: bool, device=None) -> torch.Tensor:
    """``[4, 4]`` int32 ``s_jk · 2^{j+k}``."""
    signs = plane_signs(signed)
    return torch.tensor(
        [[signs[j][k] * (1 << (j + k)) for k in range(4)] for j in range(4)],
        dtype=torch.int32, device=device,
    )


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Population count of 32-bit words held as int32 → int64 counts."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def bsdp_popcount(a_planes: torch.Tensor, b_planes: torch.Tensor, *,
                  signed: bool = True) -> torch.Tensor:
    """Dot products from broadcast-compatible ``[..., 4, Kw]`` planes via
    AND + popcount (Algorithm 2) → ``[...]`` int32."""
    signs = plane_signs(signed)
    acc = None
    for j in range(4):
        for k in range(4):
            popc = popcount32(a_planes[..., j, :] & b_planes[..., k, :])
            term = popc.sum(dim=-1) << (j + k)
            term = term if signs[j][k] > 0 else -term
            acc = term if acc is None else acc + term
    return acc.to(torch.int32)


def bsdp_gemv_popcount(w_planes: torch.Tensor, x_planes: torch.Tensor, *,
                       signed: bool = True) -> torch.Tensor:
    """GEMV: ``w_planes [N, 4, Kw]`` × ``x_planes [..., 4, Kw]`` → ``[..., N]``."""
    return bsdp_popcount(w_planes, x_planes[..., None, :, :], signed=signed)


def bits_to_int8(planes: torch.Tensor) -> torch.Tensor:
    """``[..., Kw]`` words → 0/1 int8 bits ``[..., Kw·32]`` (bit ``b`` of
    word ``w`` at ``w·32 + b``); ``& 1`` after the arithmetic shift."""
    shifts = torch.arange(bitplane.WORD, dtype=torch.int32, device=planes.device)
    bits = ((planes[..., None] >> shifts) & 1).to(torch.int8)
    return bits.reshape(*planes.shape[:-1], planes.shape[-1] * bitplane.WORD)


def bsdp_matmul_planes(x_planes: torch.Tensor, w_planes: torch.Tensor, *,
                       signed: bool = True) -> torch.Tensor:
    """``x [..., M, 4, Kw] × w [..., N, 4, Kw] → [..., M, N]`` int32, exactly
    ``decode(x) @ decode(w).T``: one contraction of the plane-interleaved
    0/1 rows gives the ``[M, 4, N, 4]`` pair table, then the
    ``s_jk·2^{j+k}`` weighted reduce."""
    *lead, m, _, kw = x_planes.shape
    n = w_planes.shape[-3]
    xb = bits_to_int8(x_planes).reshape(*lead, m * 4, kw * 32)
    wb = bits_to_int8(w_planes).reshape(*w_planes.shape[:-3], n * 4, kw * 32)
    table = torch.matmul(xb.to(torch.float32), wb.to(torch.float32).transpose(-1, -2))
    table = table.to(torch.int32).reshape(*lead, m, 4, n, 4)
    weight = plane_weights(signed, x_planes.device)
    return (table * weight[:, None, :]).sum(dim=(-3, -1), dtype=torch.int32)


def bsdp_gemv(w_planes: torch.Tensor, x: torch.Tensor, *, signed: bool = True,
              form: str = "popcount") -> torch.Tensor:
    """End-to-end BSDP GEMV: encoded weights ``w_planes [N, 4, Kw]`` × raw
    int4 activations ``x [M, K]`` (int8 payload, K = 32·Kw) → ``[M, N]``
    int32, by ``form="popcount"`` (Algorithm 2) or ``"matmul"`` (the one
    plane-interleaved contraction)."""
    x_planes = bitplane.encode_acts(x)
    if form == "popcount":
        return bsdp_gemv_popcount(w_planes, x_planes, signed=signed)
    if form == "matmul":
        return bsdp_matmul_planes(x_planes, w_planes, signed=signed)
    raise ValueError(f"unknown form {form!r}")
