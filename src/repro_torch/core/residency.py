"""Residency-format registry: declarative weight-residency formats + policies.

Counterpart of :mod:`repro.core.residency`.  Every weight-residency format
is a :class:`ResidencyFormat` registered by name; ``layers.dense`` and the
serving engine ask the registry instead of switching on mode strings.

A format owns one resident layout:

``encode(w)``             one-time ``[K, N]`` float → :class:`QuantLinearState`
``apply(state, x)``       the kernel path (the port's kernel wrappers, with
                          batch-aware dispatch via :class:`KernelPolicy`)
``apply_plain(state, x)`` the plain PyTorch path (the reference's
                          ``apply_jnp``): the kernel path's arithmetic with
                          each kernel replaced by its plain version, cast
                          to ``x.dtype``
``to_float(state)``      dequantized ``[K, N]`` float32 (the absorbed MLA
                          decode's ``w_uk`` / ``w_uv``)
``resident_bytes(state)`` device bytes of payload + scales

A *stacked* state carries a leading expert axis on its payload and scales
(``data [E, ...]``, ``scale [E, 1, N]``): the expert weights of a MoE
layer, converted one expert at a time (:func:`from_float` of an ``[E, K,
N]`` weight).  :func:`apply_stacked` runs ``x [E, M, K]`` through it; the
``w8a8`` and bit-plane formats launch their kernel once for all experts
(the grouped launch, the experts on the grid), ``w8a16`` and ``w4a8`` call
theirs once an expert.

The port registers the reference's seven formats: ``bf16``; ``w8a16``
(``dequant_matmul``); ``w8a8`` (``matmul_int8``); ``w4a8``
(``matmul_int4_packed``); and the bit-plane trio, which share one payload
and differ only in their KernelPolicy — ``w4a4_bsdp`` (``bsdp_gemv`` at
every M), ``bsdp`` (``bsdp_gemv`` at M == 1, the unrolled ``bsdp_gemm`` at
M > 1) and ``bsdp_fused`` (``bsdp_gemv`` / ``bsdp_gemm_fused``).

Per-layer policies: :class:`ResidencySpec` maps dot-joined parameter paths
to formats by glob rules, first match wins::

    ResidencySpec.parse("ffn=bsdp_fused,mixer=w8a16")
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Mapping, Optional, Union

import torch

from repro_torch.core import bitplane, bsdp, quant


@dataclasses.dataclass
class QuantLinearState:
    """Payload for one resident linear layer (format-tagged)."""

    data: torch.Tensor  # format-dependent payload ([E, ...] when stacked)
    scale: torch.Tensor  # [1, N] per-output-channel float32 ([E, 1, N] when stacked)
    mode: str = "w8a8"
    k: int = 0  # logical K
    n: int = 0  # logical N

    def to(self, device) -> "QuantLinearState":
        return dataclasses.replace(self, data=self.data.to(device),
                                   scale=self.scale.to(device))

    def expert(self, e: int) -> "QuantLinearState":
        """Expert ``e`` of a stacked state (views, no copy)."""
        return dataclasses.replace(self, data=self.data[e], scale=self.scale[e])


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Batch-aware kernel dispatch as data: ``gemv`` names the kernel at
    M == 1, ``gemm`` the kernel at M > 1; ``None`` = a single kernel."""

    gemv: Optional[str] = None
    gemm: Optional[str] = None

    def kernel_for(self, m: int) -> Optional[str]:
        return self.gemv if m == 1 else self.gemm


#: weight elements converted at a time by :meth:`ResidencyFormat.encode_by_columns`
COLUMN_BLOCK = 1 << 22


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ResidencyFormat:
    """Base class / protocol for one weight-residency format."""

    name: str = ""
    #: convert_params leaves parameters of this format as float tensors
    keeps_float_params: bool = False
    #: absorbed MLA decode can dequantize this format to a float matrix
    supports_absorbed_decode: bool = True
    #: the payload's axis of output columns (N)
    data_n_axis: int = 1

    def encode(self, w: torch.Tensor) -> QuantLinearState:
        raise NotImplementedError

    def encode_by_columns(self, w: torch.Tensor,
                          dtype: Optional[torch.dtype] = None) -> QuantLinearState:
        """``encode(w.to(dtype))`` bit for bit, about :data:`COLUMN_BLOCK`
        weights' columns at a time.  Every format quantizes and lays out
        each output column on its own, so converting by columns changes no
        bit; it bounds the temporaries (the cast, the bit-plane encode's
        bits) by the block instead of the weight."""
        k, n = w.shape
        step = max(1, COLUMN_BLOCK // k)
        if step >= n:
            return self.encode(w if dtype is None else w.to(dtype))
        data = scale = None
        for c in range(0, n, step):
            block = w[:, c:c + step]
            part = self.encode(block if dtype is None else block.to(dtype))
            if data is None:
                shape = list(part.data.shape)
                shape[self.data_n_axis] = n
                data = torch.empty(shape, dtype=part.data.dtype, device=w.device)
                scale = torch.empty((1, n), dtype=part.scale.dtype, device=w.device)
            data.narrow(self.data_n_axis, c, part.n).copy_(part.data)
            scale[:, c:c + part.n] = part.scale
        return QuantLinearState(data=data, scale=scale, mode=self.name, k=k, n=n)

    def apply(self, state: QuantLinearState, x: torch.Tensor) -> torch.Tensor:
        """Kernel path: ``x [M, K] → f32 [M, N]``."""
        raise NotImplementedError

    def apply_plain(self, state: QuantLinearState, x: torch.Tensor) -> torch.Tensor:
        """Plain path ``[..., K] → [..., N]`` in ``x.dtype``."""
        raise NotImplementedError

    def apply_stacked(self, state: QuantLinearState, x: torch.Tensor) -> torch.Tensor:
        """Kernel path of a stacked state: ``x [E, M, K] → f32 [E, M, N]``.
        Here :meth:`apply` once an expert; a format with a grouped launch
        overrides it."""
        return torch.stack([self.apply(state.expert(e), x[e]) for e in range(x.shape[0])])

    def apply_stacked_plain(self, state: QuantLinearState, x: torch.Tensor) -> torch.Tensor:
        """Plain path of a stacked state: :meth:`apply_plain` once an expert,
        ``[E, M, K] → [E, M, N]`` in ``x.dtype``."""
        return torch.stack([self.apply_plain(state.expert(e), x[e])
                            for e in range(x.shape[0])])

    def to_float(self, state: QuantLinearState) -> torch.Tensor:
        """Dequantized ``[K, N]`` float32 weight."""
        raise NotImplementedError

    def resident_bytes(self, state: QuantLinearState) -> int:
        return _nbytes(state.data) + _nbytes(state.scale)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<ResidencyFormat {self.name!r}>"


_REGISTRY: dict[str, ResidencyFormat] = {}


def register_format(fmt: ResidencyFormat) -> ResidencyFormat:
    if not fmt.name:
        raise ValueError("format must set a non-empty .name")
    _REGISTRY[fmt.name] = fmt
    return fmt


def get_format(name: str) -> ResidencyFormat:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown residency format {name!r}; registered: {formats()}"
        ) from None


def formats() -> tuple[str, ...]:
    return tuple(_REGISTRY)


class BF16Format(ResidencyFormat):
    """The unquantized residency: conversion leaves the float weights as
    they are, and ``dense`` multiplies them directly."""

    name = "bf16"
    keeps_float_params = True

    def encode(self, w):
        k, n = w.shape
        return QuantLinearState(data=w.to(torch.bfloat16),
                                scale=torch.ones((1, n), dtype=torch.float32, device=w.device),
                                mode=self.name, k=k, n=n)

    def to_float(self, state):
        return state.data.to(torch.float32)


class Int8Format(ResidencyFormat):
    """int8 weights + per-channel scale; shared by ``w8a16`` and ``w8a8``.

    ``act_bits=None`` keeps activations float (the fused-dequant kernel
    ``dequant_matmul``, w8a16); ``act_bits=8`` quantizes activations per
    token and runs the int8 x int8 kernel ``matmul_int8`` — the NI path of
    §III-B (w8a8).
    """

    def __init__(self, name: str, act_bits: Optional[int]):
        self.name = name
        self.act_bits = act_bits

    def encode(self, w):
        k, n = w.shape
        qt = quant.quantize_weights(w, bits=8)
        return QuantLinearState(data=qt.data, scale=qt.scale.reshape(1, n),
                                mode=self.name, k=k, n=n)

    def apply(self, state, x):
        from repro_torch.kernels import ops

        if self.act_bits is None:  # the kernel widens bf16 activations itself
            return ops.weight_only_matmul(x, state.data, state.scale)
        xq = quant.quantize_acts(x.to(torch.float32), bits=self.act_bits)
        return ops.quant_matmul(xq, quant.QuantTensor(state.data, state.scale, bits=8, axis=0))

    def apply_plain(self, state, x):
        from repro_torch.kernels import dequant_gemv, gemv_int8

        x2 = x.reshape(-1, x.shape[-1])
        if self.act_bits is None:
            out = dequant_gemv.dequant_matmul_plain(x2, state.data, state.scale)
        else:
            xq = quant.quantize_acts(x2.to(torch.float32), bits=self.act_bits)
            out = gemv_int8.matmul_int8_plain(xq.data, state.data, xq.scale, state.scale)
        return out.reshape(*x.shape[:-1], state.n).to(x.dtype)

    def apply_stacked(self, state, x):
        """``w8a8``: one grouped ``matmul_int8`` launch for every expert;
        ``w8a16``: ``dequant_matmul`` once an expert."""
        from repro_torch.kernels import ops

        if self.act_bits is None:
            return super().apply_stacked(state, x)
        xq = quant.quantize_acts(x.to(torch.float32), bits=self.act_bits)
        return ops.quant_matmul_grouped(xq, quant.QuantTensor(state.data, state.scale,
                                                              bits=8, axis=0))

    def to_float(self, state):
        return state.data.to(torch.float32) * state.scale


class PackedInt4Format(ResidencyFormat):
    """``w4a8``: int4 weights packed two per byte along K (half the bytes of
    int8), int8 activations, unpacked in the kernel ``matmul_int4_packed``.
    Odd K is padded by one zero row before packing."""

    name = "w4a8"

    def encode(self, w):
        k, n = w.shape
        qt = quant.quantize_weights(w, bits=4)
        q = torch.nn.functional.pad(qt.data, (0, 0, 0, k % 2))
        return QuantLinearState(data=quant.pack_int4(q, axis=0),
                                scale=qt.scale.reshape(1, n), mode=self.name, k=k, n=n)

    def apply(self, state, x):
        from repro_torch.kernels import ops

        xq = quant.quantize_acts(x.to(torch.float32), bits=8)
        return ops.quant_matmul_int4(xq, state.data, state.scale)

    def apply_plain(self, state, x):
        from repro_torch.kernels import gemv_int4

        xq = quant.quantize_acts(x.reshape(-1, x.shape[-1]).to(torch.float32), bits=8)
        out = gemv_int4.matmul_int4_packed_plain(xq.data, state.data, xq.scale, state.scale)
        return out.reshape(*x.shape[:-1], state.n).to(x.dtype)

    def to_float(self, state):
        w = quant.unpack_int4(state.data, axis=0)[:state.k]
        return w.to(torch.float32) * state.scale


class BitPlaneFormat(ResidencyFormat):
    """Bit-plane int4 weights + int4 activations — the paper's §IV layout.

    Payload is ``[N, 4, ceil(K/32)]`` int32 plane words (the reference's
    uint32 words, bit-viewed).  The kernel policy is the only difference
    between the three registered instances: ``w4a4_bsdp`` keeps the
    popcount GEMV at every batch size, ``bsdp`` takes the unrolled
    16-contraction GEMM at M > 1, and ``bsdp_fused`` the fused
    single-contraction GEMM.
    """

    data_n_axis = 0

    def __init__(self, name: str, kernel_policy: KernelPolicy):
        self.name = name
        self.kernel_policy = kernel_policy

    def encode(self, w):
        k, n = w.shape
        qt = quant.quantize_weights(w, bits=4)
        planes = bitplane.encode_weights(bitplane.pad_to_word(qt.data, axis=0))
        return QuantLinearState(data=planes, scale=qt.scale.reshape(1, n),
                                mode=self.name, k=k, n=n)

    def apply(self, state, x):
        from repro_torch.kernels import ops

        xq = quant.quantize_acts(x.to(torch.float32), bits=4)
        acc = ops.bsdp_matmul(xq.data, state.data, signed=True,
                              kernel=self.kernel_policy.kernel_for(x.shape[0]),
                              fmt_name=self.name)
        return acc.to(torch.float32) * xq.scale.reshape(-1, 1) * state.scale

    def apply_plain(self, state, x):
        xq = quant.quantize_acts(x.to(torch.float32), bits=4)
        lead = xq.data.shape[:-1]
        x2 = xq.data.reshape(-1, xq.data.shape[-1])
        xp = bitplane.encode_acts(bitplane.pad_to_word(x2))
        acc = bsdp.bsdp_matmul_planes(xp, state.data, signed=True)
        out = acc.to(torch.float32) * xq.scale.reshape(-1, 1) * state.scale
        return out.reshape(*lead, state.n).to(x.dtype)

    def apply_stacked(self, state, x):
        """One grouped launch of the policy's kernel (by the rows an expert
        takes) for every expert."""
        from repro_torch.kernels import ops

        e, m, _ = x.shape
        xq = quant.quantize_acts(x.to(torch.float32), bits=4)
        acc = ops.bsdp_matmul_grouped(xq.data, state.data, signed=True,
                                      kernel=self.kernel_policy.kernel_for(m),
                                      fmt_name=self.name)
        return acc.to(torch.float32) * xq.scale.reshape(e, m, 1) * state.scale

    def to_float(self, state):
        w = bitplane.decode(state.data, signed=True).T[:state.k]  # [K, N]
        return w.to(torch.float32) * state.scale


register_format(BF16Format())
register_format(Int8Format("w8a16", act_bits=None))
register_format(Int8Format("w8a8", act_bits=8))
register_format(PackedInt4Format())
register_format(BitPlaneFormat("w4a4_bsdp", KernelPolicy(gemv="gemv", gemm="gemv")))
register_format(BitPlaneFormat("bsdp", KernelPolicy(gemv="gemv", gemm="gemm")))
register_format(BitPlaneFormat("bsdp_fused", KernelPolicy(gemv="gemv", gemm="gemm_fused")))


def from_float(w: torch.Tensor, mode: str = "w8a8",
               dtype: Optional[torch.dtype] = None) -> QuantLinearState:
    """One-time convert of a float ``[K, N]`` weight (cast to ``dtype`` first,
    if given) to residency ``mode``, a block of columns at a time
    (:meth:`ResidencyFormat.encode_by_columns`).  A stacked ``[E, K, N]``
    weight (a MoE layer's experts) converts one expert at a time into one
    stacked state, ``data [E, ...]`` and ``scale [E, 1, N]``."""
    fmt = get_format(mode)
    if w.ndim == 2:
        return fmt.encode_by_columns(w, dtype)
    data = scale = None
    for e in range(w.shape[0]):
        part = fmt.encode_by_columns(w[e], dtype)
        if data is None:
            data = torch.empty((w.shape[0], *part.data.shape), dtype=part.data.dtype,
                               device=w.device)
            scale = torch.empty((w.shape[0], *part.scale.shape), dtype=part.scale.dtype,
                                device=w.device)
        data[e], scale[e] = part.data, part.scale
    return QuantLinearState(data=data, scale=scale, mode=mode, k=part.k, n=part.n)


def apply(state: QuantLinearState, x: torch.Tensor) -> torch.Tensor:
    """``x [..., K] → [..., N]`` float32 through the format's kernel path."""
    fmt = get_format(state.mode)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = fmt.apply(state, x2)
    return out.reshape(*lead, state.n)


def apply_stacked(state: QuantLinearState, x: torch.Tensor) -> torch.Tensor:
    """``x [E, M, K] → [E, M, N]`` float32 through a stacked state's kernel path."""
    return get_format(state.mode).apply_stacked(state, x)


def resident_bytes(state: QuantLinearState) -> int:
    return get_format(state.mode).resident_bytes(state)


def _pattern_matches(path: str, pat: str) -> bool:
    """``pat`` matches the full dot-joined path or a contiguous run of its
    segments (``"ffn"`` selects ``layers.3.ffn.w_in``)."""
    return (
        fnmatch.fnmatchcase(path, pat)
        or fnmatch.fnmatchcase(path, f"*.{pat}")
        or fnmatch.fnmatchcase(path, f"{pat}.*")
        or fnmatch.fnmatchcase(path, f"*.{pat}.*")
    )


SpecLike = Union["ResidencySpec", str, Mapping[str, str], None]


@dataclasses.dataclass(frozen=True)
class ResidencySpec:
    """Ordered (glob pattern → format) rules, first match wins, else
    ``default``."""

    default: str = "bf16"
    rules: tuple[tuple[str, str], ...] = ()

    def __post_init__(self):
        get_format(self.default)
        for _, name in self.rules:
            get_format(name)

    @classmethod
    def parse(cls, spec: SpecLike) -> "ResidencySpec":
        """A ResidencySpec, a bare format name, a ``"pat=fmt,...,default=fmt"``
        string, or a mapping."""
        if spec is None:
            return cls()
        if isinstance(spec, ResidencySpec):
            return spec
        if isinstance(spec, Mapping):
            default = spec.get("default", "bf16")
            return cls(default=default,
                       rules=tuple((p, f) for p, f in spec.items() if p != "default"))
        if isinstance(spec, str):
            if "=" not in spec:
                return cls(default=spec)
            default, rules = "bf16", []
            for entry in filter(None, (e.strip() for e in spec.split(","))):
                pat, _, name = entry.partition("=")
                if not name:
                    raise ValueError(f"bad residency rule {entry!r}")
                if pat == "default":
                    default = name
                else:
                    rules.append((pat, name))
            return cls(default=default, rules=tuple(rules))
        raise TypeError(f"cannot parse residency spec from {type(spec)}")

    def mode_for(self, path: str) -> str:
        for pat, name in self.rules:
            if _pattern_matches(path, pat):
                return name
        return self.default

    def modes(self) -> tuple[str, ...]:
        seen = dict.fromkeys(name for _, name in self.rules)
        seen[self.default] = None
        return tuple(seen)

    @property
    def is_trivial(self) -> bool:
        """Every selectable format keeps float params: conversion is the
        identity."""
        return all(get_format(m).keeps_float_params for m in self.modes())

    def describe(self) -> str:
        if all(name == self.default for _, name in self.rules):
            return self.default
        return ",".join([f"{p}={n}" for p, n in self.rules] + [f"default={self.default}"])
