"""The layer stack: the dense attention + MLP layer, looped over depth.

Counterpart of :mod:`repro.models.stack` for the dense GQA family.  The
reference stacks every leaf ``[n_superblocks, ...]`` and runs the depth
with ``lax.scan``; the port keeps one parameter dict and one cache dict per
layer and runs a Python loop.  Modes: ``prefill`` (full sequence, builds
the caches) and ``decode`` (tokens against the caches).
"""

from __future__ import annotations

from repro_torch.models import attention, layers


def layer_apply(params: dict, x, cfg, *, mode: str, cache=None, pos=None,
                cache_len: int = 0, impl=None):
    """One layer.  Returns (x, cache)."""
    h = layers.norm_apply(params["ln1"], x, cfg)
    if mode == "prefill":
        a, cache = attention.gqa_prefill(params["mixer"], h, cfg, cache_len=cache_len,
                                         positions=pos, impl=impl)
    elif mode == "decode":
        a, cache = attention.gqa_decode(params["mixer"], h, cache, cfg, pos=pos,
                                        impl=impl)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + a.to(x.dtype)
    h2 = layers.norm_apply(params["ln2"], x, cfg)
    x = x + layers.mlp_apply(params["ffn"], h2, cfg, impl=impl).to(x.dtype)
    return x, cache


def stack_apply(layer_params: list, x, cfg, *, mode: str, caches=None, pos=None,
                cache_len: int = 0, impl=None):
    """Run every layer in order.  Returns (x, per-layer caches)."""
    new_caches = []
    for i, p in enumerate(layer_params):
        x, c = layer_apply(p, x, cfg, mode=mode,
                           cache=None if caches is None else caches[i],
                           pos=pos, cache_len=cache_len, impl=impl)
        new_caches.append(c)
    return x, new_caches
