"""Bit-plane (BSDP) layout encode/decode — the paper's §IV data layout.

Counterpart of :mod:`repro.core.bitplane`.  Every block of 32 int4 elements
is stored as four 32-bit words: word ``j`` holds the ``2^j`` bit-plane of
the 32 elements (bit ``b`` of the word is element ``b``).

The reference holds the words as ``uint32``.  PyTorch cannot shift
``torch.uint32`` on the CPU, so the port holds the same 32 bits as
``int32``: ``planes.numpy().view(np.uint32)`` gives the reference's words
bit for bit.  Because ``>>`` on ``int32`` is an arithmetic shift (it smears
bit 31, which is the sign plane bit of element 31), every shift is followed
by ``& 1`` before the bit is used.

Two's-complement convention for signed int4: ``v = -8·b3 + 4·b2 + 2·b1 + b0``.
"""

from __future__ import annotations

import functools

import torch

PLANE_BITS = 4  # int4 / uint4
WORD = 32  # elements per packed 32-bit word


@functools.lru_cache(maxsize=None)
def _encode_consts(device: torch.device):
    """(plane shifts [4, 1], bit weights [32]) for :func:`encode`.  Bit 31's
    weight is -2^31: summing 0/1 bits with these int32 weights gives the
    two's-complement view of the unsigned word, with no intermediate sum
    leaving the int32 range."""
    weights = [1 << b for b in range(WORD - 1)] + [-(1 << (WORD - 1))]
    return (torch.arange(PLANE_BITS, dtype=torch.int32, device=device).view(PLANE_BITS, 1),
            torch.tensor(weights, dtype=torch.int32, device=device))


def encode(x: torch.Tensor) -> torch.Tensor:
    """Encode int4 values ``[..., K]`` (K a multiple of 32) into bit-planes
    ``[..., 4, K//32]`` int32 (the reference's uint32 words, bit-viewed)."""
    k = x.shape[-1]
    if k % WORD:
        raise ValueError(f"K={k} must be a multiple of {WORD}; pad first")
    plane_shift, bit_weight = _encode_consts(x.device)
    u = (x.to(torch.int32) & 0xF).reshape(*x.shape[:-1], k // WORD, 1, WORD)
    bits = (u >> plane_shift) & 1  # [..., Kw, 4, 32]
    words = (bits * bit_weight).sum(dim=-1, dtype=torch.int32)  # [..., Kw, 4]
    return words.transpose(-1, -2).contiguous()


def decode(planes: torch.Tensor, *, signed: bool = True) -> torch.Tensor:
    """Inverse of :func:`encode` → int8 values ([-8,7] signed / [0,15])."""
    *lead, nplanes, kw = planes.shape
    if nplanes != PLANE_BITS:
        raise ValueError(f"expected {PLANE_BITS} planes, got {nplanes}")
    shifts = torch.arange(WORD, dtype=torch.int32, device=planes.device)
    bits = (planes[..., None] >> shifts) & 1  # [..., 4, Kw, 32]
    weight = torch.tensor([1, 2, 4, -8 if signed else 8], dtype=torch.int32,
                          device=planes.device)
    vals = (bits * weight[:, None, None]).sum(dim=-3, dtype=torch.int32)
    return vals.to(torch.int8).reshape(*lead, kw * WORD)


def encode_weights(q: torch.Tensor) -> torch.Tensor:
    """One-time encode of a quantized ``[K, N]`` weight → ``[N, 4, K//32]``
    (output-channel-major, the "block of rows per DPU" layout)."""
    return encode(q.T)


def encode_acts(x: torch.Tensor) -> torch.Tensor:
    """Per-request activation encode ``[..., K] → [..., 4, K//32]``."""
    return encode(x)


def pad_to_word(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of 32 (zero planes are exact for
    signed and unsigned dot products)."""
    axis = axis % x.ndim
    pad = (-x.shape[axis]) % WORD
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return torch.nn.functional.pad(x, widths)
