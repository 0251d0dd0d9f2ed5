"""Symmetric integer quantization — counterpart of :mod:`repro.core.quant`.

``q = round(x / s)`` clamped to the signed range, ``s = max|x| / qmax``
(floored at 1e-8).  ``torch.round`` rounds half to even like ``jnp.round``,
and the division is a true ``/`` (not a multiply by the reciprocal), so the
integer payloads are bit-identical to the reference's on identical inputs.

``pack_int4`` / ``unpack_int4`` arrive with the ``w4a8`` kernel.
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
