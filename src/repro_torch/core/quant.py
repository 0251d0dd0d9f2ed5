"""Symmetric integer quantization — counterpart of :mod:`repro.core.quant`.

``q = round(x / s)`` clamped to the signed range, ``s = max|x| / qmax``
(floored at 1e-8).  ``torch.round`` rounds half to even like ``jnp.round``,
and the division is a true ``/`` (not a multiply by the reciprocal), so the
integer payloads are bit-identical to the reference's on identical inputs.

``pack_int4`` / ``unpack_int4`` hold int4 values two per byte — the ``w4a8``
residency's payload.
"""

from __future__ import annotations

import dataclasses

import torch

INT_RANGE = {
    8: (-128, 127),
    4: (-8, 7),
}

_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class QuantTensor:
    """A quantized tensor: int8 payload (int4 values occupy [-8, 7]) plus
    float32 scale(s) broadcastable along ``axis``."""

    data: torch.Tensor
    scale: torch.Tensor
    bits: int = 8
    axis: int = -1


def compute_scale(x: torch.Tensor, *, bits: int, axis=-1) -> torch.Tensor:
    """Symmetric scale: max-abs over ``axis`` divided by the int max."""
    qmax = INT_RANGE[bits][1]
    amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    return torch.clamp_min(amax, _EPS) / qmax


def quantize(x: torch.Tensor, *, bits: int = 8, axis=-1, scale=None) -> QuantTensor:
    """Symmetric round-half-to-even quantization along ``axis``."""
    if bits not in INT_RANGE:
        raise ValueError(f"unsupported bits={bits}")
    if scale is None:
        scale = compute_scale(x, bits=bits, axis=axis)
    qmin, qmax = INT_RANGE[bits]
    q = torch.clamp(torch.round(x / scale), qmin, qmax).to(torch.int8)
    return QuantTensor(data=q, scale=scale.to(torch.float32), bits=bits, axis=axis)


def quantize_weights(w: torch.Tensor, *, bits: int = 8) -> QuantTensor:
    """Per-output-channel quantization of a ``[K, N]`` weight matrix."""
    return quantize(w, bits=bits, axis=0)


def quantize_acts(x: torch.Tensor, *, bits: int = 8) -> QuantTensor:
    """Per-token dynamic quantization of ``[..., K]`` activations."""
    return quantize(x, bits=bits, axis=-1)


def pack_int4(q: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack int4 values (int8 payload in [-8, 7]) two per byte along ``axis``:
    the even element goes to the low nibble, the odd one to the high nibble,
    each as a two's-complement nibble.  The axis halves in length."""
    if q.shape[axis] % 2:
        raise ValueError(f"axis {axis} length {q.shape[axis]} must be even")
    u = q.to(torch.int32) & 0xF
    lo, hi = u[_every_other(u.ndim, axis, 0)], u[_every_other(u.ndim, axis, 1)]
    packed = lo | (hi << 4)  # 0..255
    return (packed - ((packed & 0x80) << 1)).to(torch.int8)  # the byte as int8


def unpack_int4(p: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_int4` → int8 values in [-8, 7]; ``axis`` doubles."""
    u = p.to(torch.int32) & 0xFF
    lo, hi = u & 0xF, u >> 4
    lo = lo - ((lo & 0x8) << 1)  # sign-extend the nibbles
    hi = hi - ((hi & 0x8) << 1)
    axis = axis % p.ndim
    stacked = torch.stack([lo, hi], dim=axis + 1)
    shape = list(p.shape)
    shape[axis] *= 2
    return stacked.reshape(shape).to(torch.int8)


def _every_other(ndim: int, axis: int, start: int) -> tuple:
    idx = [slice(None)] * ndim
    idx[axis] = slice(start, None, 2)
    return tuple(idx)
