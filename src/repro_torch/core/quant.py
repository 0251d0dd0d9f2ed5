"""Symmetric integer quantization — counterpart of :mod:`repro.core.quant`.

``q = round(x / s)`` clamped to the signed range, ``s = max|x| / qmax``
(floored at 1e-8).  ``torch.round`` rounds half to even like ``jnp.round``,
and both divisions are true divisions on every device (not a multiply by
the reciprocal, see :func:`true_div`), so the integer payloads and scales
are bit-identical to the reference's on identical inputs.

``pack_int4`` / ``unpack_int4`` hold int4 values two per byte — the ``w4a8``
residency's payload.  ``quantize_chunked`` / ``dequantize_chunked`` are the
per-256-chunk form the int8 optimizer moments use (bit-identical to the
reference's), ``quantize_stochastic`` the unbiased form for gradient paths
(its noise comes from a ``torch.Generator``, so its codes cannot be the
reference's), and ``fake_quant`` the straight-through quantizer.
"""

from __future__ import annotations

import dataclasses

import torch

INT_RANGE = {
    8: (-128, 127),
    4: (-8, 7),
}

_EPS = 1e-8

#: (device, dtype, divisor) → the divisor as a 0-dim tensor on that device
_DIVISORS: dict = {}


def true_div(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x / d`` as the CPU computes it, on every device.  For float32 and
    float64, PyTorch's CUDA kernels divide by a Python number as a multiply
    by its reciprocal, which can land one ulp from the quotient the CPU and
    the reference give; a divisor held as a 0-dim tensor on the same device
    takes true division in the same single kernel.  (For bf16 and float16
    both devices multiply by the reciprocal.)"""
    if x.device.type == "cpu" or x.dtype not in (torch.float32, torch.float64):
        return x / d
    key = (x.device, x.dtype, d)
    if key not in _DIVISORS:
        _DIVISORS[key] = torch.tensor(d, dtype=x.dtype, device=x.device)
    return x / _DIVISORS[key]


@dataclasses.dataclass(frozen=True)
class QuantTensor:
    """A quantized tensor: int8 payload (int4 values occupy [-8, 7]) plus
    float32 scale(s) broadcastable along ``axis``."""

    data: torch.Tensor
    scale: torch.Tensor
    bits: int = 8
    axis: int = -1


def compute_scale(x: torch.Tensor, *, bits: int, axis=-1, reduce=None) -> torch.Tensor:
    """Symmetric scale: max-abs over ``axis`` divided by the int max.
    ``reduce`` maps the max-abs first: a MAX all-reduce when ``axis`` is
    split over ranks, so every rank takes the whole row's."""
    amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    if reduce is not None:
        amax = reduce(amax)
    return scale_from_amax(amax, bits=bits)


def scale_from_amax(amax: torch.Tensor, *, bits: int) -> torch.Tensor:
    """The symmetric scale of values whose max-abs is ``amax``."""
    return true_div(torch.clamp_min(amax, _EPS), INT_RANGE[bits][1])


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


# ---------------------------------------------------------------------------
# Stochastic rounding, chunked quantization (the int8 optimizer moments) and
# the straight-through fake quantizer.
# ---------------------------------------------------------------------------


def quantize_stochastic(x: torch.Tensor, generator: torch.Generator, *, bits: int = 8,
                        axis=-1) -> QuantTensor:
    """Stochastic-rounding quantization: ``round(x / s + u)``, ``u`` uniform
    on [-0.5, 0.5) from ``generator`` (on ``x``'s device), so the codes are
    unbiased in expectation.  The reference draws ``u`` from a JAX key; the
    scale is the same, the codes are not."""
    scale = compute_scale(x, bits=bits, axis=axis)
    qmin, qmax = INT_RANGE[bits]
    noise = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                       device=x.device) - 0.5
    q = torch.clamp(torch.round(x / scale + noise), qmin, qmax).to(torch.int8)
    return QuantTensor(data=q, scale=scale.to(torch.float32), bits=bits, axis=axis)


def quantize_chunked(x: torch.Tensor, *, chunk: int = 256, bits: int = 8):
    """Flatten → zero-pad → chunks of ``chunk`` → per-chunk symmetric
    quantization.  Returns ``(q [n_chunks, chunk] int8, scales [n_chunks, 1]
    f32, n)`` with ``n`` the element count (for the exact inverse)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    chunks = torch.nn.functional.pad(flat, (0, (-n) % chunk)).reshape(-1, chunk)
    qt = quantize(chunks, bits=bits, axis=-1)
    return qt.data, qt.scale, n


def dequantize_chunked(q: torch.Tensor, scale: torch.Tensor, n: int, shape) -> torch.Tensor:
    """Inverse of :func:`quantize_chunked` → float32 of ``shape``."""
    return (q.to(torch.float32) * scale).reshape(-1)[:n].reshape(shape)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits, axis):
        ctx.dtype = x.dtype
        qt = quantize(x, bits=bits, axis=axis)
        return qt.data.to(torch.float32) * qt.scale

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None  # straight-through estimator


def fake_quant(x: torch.Tensor, bits: int = 8, axis: int = -1) -> torch.Tensor:
    """Quantize then dequantize (float32) in the forward pass; the gradient
    passes straight through, as the reference's ``custom_vjp``."""
    return _FakeQuant.apply(x, bits, axis)
