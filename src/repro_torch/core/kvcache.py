"""Cache-residency registry for the decode K/V caches.

Counterpart of :mod:`repro.core.kvcache`.  A format owns one *channel*
(K, V, or the MLA latent ``c_kv``): a ``[B, L, *lead, F]`` per-slot tensor
(``lead`` is ``(Hkv,)`` for K and V, ``()`` for the latent) stored in its
resident layout with per-slot scales.  Stores are suffix → tensor dicts
(``""`` the payload, ``"_scale"`` the scales); the flat per-layer cache dict
names them ``k``/``k_scale``/``v``/``v_scale`` (``c_kv``/``c_scale``) beside
``pos_ids``.

``init``    allocate ``[B, L, *lead, F]`` storage
``append``  ring-write new slots.  Unlike the reference's functional
            ``.at[].set(mode="drop")`` scatter, the port writes **in
            place**, and padded positions are masked out of the write
            (PyTorch has no dropping scatter)
``qk/av``   the score and value reads, scales folded after the contraction
``decode_attention``  the fused qk → softmax → av read (``int4_bp_fused``)
``abstract_state``    ``init``'s storage on the ``meta`` device: the dry
            run's cache, shapes and dtypes with no storage, which
            ``resident_bytes`` / ``slot_bytes`` / :func:`cache_resident_bytes`
            count as they count real stores
``data_axes(lead_axes)``  logical sharding axes of each store entry after its
            ``(batch, kv_seq)`` dims; ``flat_cache_axes`` the full axes under
            the flat cache's key names (what :func:`repro_torch.sharding.
            partitioning.cache_axes_table` reads)

Formats: ``bf16``; ``int8`` — an int8 payload ``[B, L, Hkv, F]`` with a
float32 scale a slot ``[B, L, Hkv]``, both folded after the contraction
(plain PyTorch, as the reference's is plain jnp); ``int4_bp`` — the §IV
bit-plane layout, payload ``[B, L, Hkv, 4, ceil(F/32)]`` int32 plane words,
whose plain plane math (integer scores on the planes, V decoded to int4
values) is the plain version of plane attention; ``int4_bp_fused`` — the
same storage read by the hand-written ``plane_decode_attention`` kernel,
which counts its own dispatch (``kernel.dispatch``, see
:mod:`repro_torch.kernels.ops`) on the kernel route and on the plain one.
The ``paged_*`` formats (:mod:`repro_torch.core.paging`) lift each of the
four onto a page pool; importing this module registers them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import bitplane, bsdp, quant

#: scale floor — matches the reference's per-slot cache scales
_EPS = 1e-6
_META = torch.device("meta")

#: channel prefix → (payload key, scale key) in the flat cache dict
CHANNEL_KEYS = {
    "k": ("k", "k_scale"),
    "v": ("v", "v_scale"),
    "c_kv": ("c_kv", "c_scale"),
}


def _to_l_minor(a: torch.Tensor, payload_dims: int) -> torch.Tensor:
    """Move the slot axis L from position 1 to just before the payload dims:
    ``[B, L, *lead, *payload] → [B, *lead, L, *payload]``."""
    return a.movedim(1, a.ndim - 1 - payload_dims)


def _slot_scale(x: torch.Tensor, qmax: int) -> torch.Tensor:
    """Per-slot symmetric scale over the feature axis (floor 1e-6)."""
    amax = torch.amax(torch.abs(x.to(torch.float32)), dim=-1)
    return quant.true_div(torch.clamp_min(amax, _EPS), qmax)


def _quant_slots(x: torch.Tensor, qmax: int, qmin: int):
    """Per-vector symmetric quantization → (int8 values in [qmin, qmax],
    float32 scale).  The division is tensor by tensor: a true division on
    every device."""
    scale = _slot_scale(x, qmax)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale[..., None]), qmin, qmax)
    return q.to(torch.int8), scale


def _quant_int4(x: torch.Tensor):
    """Per-vector int4 quantization → (int8 values in [-8, 7], scale)."""
    return _quant_slots(x, 7, -8)


class CacheFormat:
    name: str = ""
    suffixes: tuple[str, ...] = ("",)
    supports_fused_decode: bool = False

    def init(self, batch, cache_len, lead, feat, dtype=torch.bfloat16,
             device=None) -> dict:
        """Allocate on ``device`` (default ``"cuda"``; raises without a GPU
        unless the caller asks for ``"cpu"``)."""
        raise NotImplementedError

    def _encode(self, x: torch.Tensor) -> dict:
        """``x [..., F]`` → suffix → encoded slot tensors."""
        raise NotImplementedError

    def append(self, store: dict, x: torch.Tensor, b_idx: torch.Tensor,
               s_idx: torch.Tensor, ring: torch.Tensor, keep=None) -> None:
        """In place: write the tokens ``x[b_idx, s_idx]`` of ``x [B, S, *lead,
        F]`` at ring slots ``ring`` of batch rows ``b_idx``.  The caller
        leaves padded tokens and duplicate slots out of the index lists:
        each ``(b_idx, ring)`` pair appears at most once, since a repeated
        index has no defined winner on the card.  With ``keep`` (a boolean
        mask over the tokens: a sequence-parallel rank's block) every token
        is encoded, as on one device, and only the kept ones are written."""
        for sfx, enc in self._encode(x[b_idx, s_idx]).items():
            if keep is None:
                store[sfx][b_idx, ring] = enc.to(store[sfx].dtype)
            else:
                store[sfx][b_idx[keep], ring[keep]] = enc[keep].to(store[sfx].dtype)

    def qk(self, q: torch.Tensor, store: dict) -> torch.Tensor:
        """``q [B, *lead, G, F]`` · the stored channel → scores ``[B, *lead,
        G, L]`` float32."""
        raise NotImplementedError

    def av(self, w: torch.Tensor, store: dict, feat: int) -> torch.Tensor:
        """``w [B, *lead, G, L]`` × the stored channel → ``[B, *lead, G,
        feat]`` float32."""
        raise NotImplementedError

    def decode_attention(self, q, k_store, v_store, bias, *, sm_scale, feat,
                         impl=None, stats: bool = False):
        raise NotImplementedError(f"cache format {self.name!r} has no fused decode path")

    def data_axes(self, lead_axes: tuple) -> dict:
        """Suffix → logical axes of the dims after ``(batch, kv_seq)``."""
        raise NotImplementedError

    def flat_cache_axes(self, prefix: str, lead_axes: tuple) -> dict:
        """Flat-cache key → the full logical axes of one channel: the
        contiguous formats put ``(batch, kv_seq)`` first; the paged pool
        overrides."""
        data_key, scale_key = CHANNEL_KEYS[prefix]
        keys = {"": data_key, "_scale": scale_key}
        return {keys[sfx]: ("batch", "kv_seq") + tuple(ax)
                for sfx, ax in self.data_axes(lead_axes).items()}

    def slot_capacity(self, cache_len: int) -> int:
        """Ring length allocated for a requested ``cache_len``: itself for
        the contiguous formats; the paged formats round it up to whole
        pages, so the gathered storage and ``pos_ids`` stay congruent."""
        return cache_len

    def abstract_state(self, batch, cache_len, lead, feat, dtype=torch.bfloat16) -> dict:
        """:meth:`init`'s store on the meta device (the same code, so the
        two cannot drift)."""
        return self.init(batch, cache_len, lead, feat, dtype=dtype, device=_META)

    def resident_bytes(self, store: dict) -> int:
        """Device bytes of one channel's store, real or abstract."""
        return cache_resident_bytes(store)

    def slot_bytes(self, lead: tuple, feat: int, dtype=torch.bfloat16) -> int:
        """Resident bytes of one cache slot, from :meth:`abstract_state`."""
        return self.resident_bytes(self.abstract_state(1, 1, lead, feat, dtype))

    def channel(self, cache: dict, prefix: str) -> dict:
        data_key, scale_key = CHANNEL_KEYS[prefix]
        keys = {"": data_key, "_scale": scale_key}
        return {sfx: cache[keys[sfx]] for sfx in self.suffixes}

    def channel_entries(self, prefix: str, store: dict) -> dict:
        data_key, scale_key = CHANNEL_KEYS[prefix]
        keys = {"": data_key, "_scale": scale_key}
        return {keys[sfx]: t for sfx, t in store.items()}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<CacheFormat {self.name!r}>"


FORMATS: dict[str, CacheFormat] = {}


def register_cache_format(fmt: CacheFormat) -> CacheFormat:
    if not fmt.name:
        raise ValueError("cache format must set a non-empty .name")
    FORMATS[fmt.name] = fmt
    return fmt


def get_cache_format(name: str) -> CacheFormat:
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown cache format {name!r}; registered: {formats()}") from None


def formats() -> tuple[str, ...]:
    return tuple(FORMATS)


def format_for(cfg) -> CacheFormat:
    return get_cache_format(getattr(cfg, "cache_format", None) or "bf16")


def cache_resident_bytes(caches) -> int:
    """Device bytes of a cache tree (payloads, scales and pos_ids), of real
    tensors or meta ones alike."""
    if isinstance(caches, torch.Tensor):
        return caches.numel() * caches.element_size()
    items = caches.values() if isinstance(caches, dict) else caches
    return sum(cache_resident_bytes(c) for c in items)


class BF16CacheFormat(CacheFormat):
    """Plain float ring cache — the unquantized reference residency."""

    name = "bf16"

    def init(self, batch, cache_len, lead, feat, dtype=torch.bfloat16, device=None):
        return {"": torch.zeros((batch, cache_len, *lead, feat), dtype=dtype,
                                device=resolve_device(device))}

    def _encode(self, x):
        return {"": x}

    def data_axes(self, lead_axes):
        return {"": tuple(lead_axes) + (None,)}

    def qk(self, q, store):
        t = _to_l_minor(store[""], 1).to(torch.float32)  # [B, *lead, L, F]
        return torch.einsum("...gf,...lf->...gl", q.to(torch.float32), t)

    def av(self, w, store, feat):
        t = _to_l_minor(store[""], 1).to(torch.float32)
        return torch.einsum("...gl,...lf->...gf", w, t)


class Int8CacheFormat(CacheFormat):
    """int8 payload and a float32 scale a slot.  The scale is constant over
    the feature axis, so it folds after the contraction: ``scores =
    (q·k_int8)·k_scale`` and ``out = (w·v_scale)·v_int8``; no float copy of
    the cache is made."""

    name = "int8"
    suffixes = ("", "_scale")

    def init(self, batch, cache_len, lead, feat, dtype=torch.bfloat16, device=None):
        device = resolve_device(device)
        return {
            "": torch.zeros((batch, cache_len, *lead, feat), dtype=torch.int8,
                            device=device),
            "_scale": torch.zeros((batch, cache_len, *lead), dtype=torch.float32,
                                  device=device),
        }

    def _encode(self, x):
        q, scale = _quant_slots(x, 127, -127)
        return {"": q, "_scale": scale}

    def data_axes(self, lead_axes):
        return {"": tuple(lead_axes) + (None,), "_scale": tuple(lead_axes)}

    def qk(self, q, store):
        t = _to_l_minor(store[""], 1).to(torch.float32)  # [B, *lead, L, F]
        s = _to_l_minor(store["_scale"], 0)  # [B, *lead, L]
        scores = torch.einsum("...gf,...lf->...gl", q.to(torch.float32), t)
        return scores * s[..., None, :]

    def av(self, w, store, feat):
        t = _to_l_minor(store[""], 1).to(torch.float32)
        s = _to_l_minor(store["_scale"], 0)
        return torch.einsum("...gl,...lf->...gf", w * s[..., None, :], t)


class BitPlaneCacheFormat(CacheFormat):
    """int4 bit-plane K/V — the §IV layout applied to the decode cache.

    Scores are computed on the planes: queries are int4-quantized per
    vector, the integer plane-pair contraction runs on the stored planes,
    and both scales fold after.  The value read decodes V to int4 values and
    folds ``v_scale`` into the weights.
    """

    name = "int4_bp"
    suffixes = ("", "_scale")

    def init(self, batch, cache_len, lead, feat, dtype=torch.bfloat16, device=None):
        fw = -(-feat // bitplane.WORD)
        device = resolve_device(device)
        return {
            "": torch.zeros((batch, cache_len, *lead, 4, fw), dtype=torch.int32,
                            device=device),
            "_scale": torch.zeros((batch, cache_len, *lead), dtype=torch.float32,
                                  device=device),
        }

    def _encode(self, x):
        q, scale = _quant_int4(x)
        return {"": bitplane.encode(bitplane.pad_to_word(q)), "_scale": scale}

    def data_axes(self, lead_axes):
        # the 4 planes and the packed feature words are never sharded
        return {"": tuple(lead_axes) + (None, None), "_scale": tuple(lead_axes)}

    @staticmethod
    def _query_planes(q):
        qq, qq_scale = _quant_int4(q)
        return bitplane.encode(bitplane.pad_to_word(qq)), qq_scale

    def qk(self, q, store):
        q_planes, qq_scale = self._query_planes(q)  # [B, *lead, G, 4, Fw]
        k_planes = _to_l_minor(store[""], 2)  # [B, *lead, L, 4, Fw]
        k_scale = _to_l_minor(store["_scale"], 0)  # [B, *lead, L]
        s_int = bsdp.bsdp_matmul_planes(q_planes, k_planes, signed=True)
        return s_int.to(torch.float32) * qq_scale[..., :, None] * k_scale[..., None, :]

    def av(self, w, store, feat):
        vals = bitplane.decode(_to_l_minor(store[""], 2), signed=True)
        v = vals[..., :feat].to(torch.float32)  # [B, *lead, L, F]
        s = _to_l_minor(store["_scale"], 0)
        return torch.einsum("...gl,...lf->...gf", w * s[..., None, :], v)


class FusedBitPlaneCacheFormat(BitPlaneCacheFormat):
    """``int4_bp`` storage read by the fused ``plane_decode_attention``
    kernel: one pass per (batch × kv-head) row, on the stored planes.
    ``impl="plain"`` takes the kernel's plain version instead.  GQA decode
    takes the fused read; MLA decode keeps the inherited ``qk``/``av`` plane
    math, as the reference does, because its score adds a float rope term
    between the two."""

    name = "int4_bp_fused"
    supports_fused_decode = True

    def decode_attention(self, q, k_store, v_store, bias, *, sm_scale, feat,
                         impl: Optional[str] = None, stats: bool = False):
        """With ``stats`` also each row's softmax max and sum ``[..., G, 2]``
        (a sequence-parallel block's statistics)."""
        from repro_torch.kernels import ops, plane_attn

        q_planes, qq_scale = self._query_planes(q)
        args = (q_planes, qq_scale, k_store[""], k_store["_scale"],
                v_store[""], v_store["_scale"], bias)
        if impl == "plain":
            out = plane_attn.plane_decode_attention_plain(*args, sm_scale=sm_scale,
                                                          stats=stats)
            return (out[0][..., :feat], out[1]) if stats else out[..., :feat]
        return ops.plane_decode_attention(*args, sm_scale=sm_scale, feat=feat, stats=stats)


register_cache_format(BF16CacheFormat())
register_cache_format(Int8CacheFormat())
register_cache_format(BitPlaneCacheFormat())
register_cache_format(FusedBitPlaneCacheFormat())

# The paged formats register themselves on import (paged_bf16 ...
# paged_int4_bp_fused), so asking the registry is a complete answer for
# every consumer.  At the bottom: paging imports this module back, and
# finds it whole.
from repro_torch.core import paging as _paging  # noqa: E402,F401
