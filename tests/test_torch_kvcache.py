"""The port's ring cache against the JAX reference past the ring's end.

Twins of ``tests/test_kvcache.py``'s wraparound tests, for every cache
format the port registers (``int8`` too).  A write whose
tokens map two of a row's positions to one slot (a prompt longer than the
ring) keeps the newest token, as the reference's scatter does on the CPU:
payload words, scales and ``pos_ids`` bit-identical to the reference's
``_ring_write`` on the same inputs.  Then whole models past the wrap: a
prompt longer than ``max_len`` and a teacher-forced decode from inside the
ring to past its end, logits within the serve tests' tolerance and the
same positions left in every layer's ring.  The port runs on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import kvcache as ref_kvcache
from repro.models import attention as ref_attention
from repro.models import model as ref_model
from repro.sharding import partitioning as P
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import kvcache
from repro_torch.models import attention
from repro_torch.models import model as model_lib

VOCAB = 128
FORMATS = ["bf16", "int8", "int4_bp", "int4_bp_fused"]
#: the serve tests' logit tolerance (tests/test_torch_serve.py: float32
#: rounding between the two frameworks, relative to the largest logit)
LOGIT_RTOL = 1e-4


def _cfgs(cache_format):
    ref_cfg = ref_smoke_config("qwen3-1.7b").scaled(
        n_layers=2, vocab_size=VOCAB, dtype=jnp.float32)
    cfg = get_smoke_config("qwen3-1.7b").scaled(
        n_layers=2, vocab_size=VOCAB, dtype=torch.float32)
    return (dataclasses.replace(ref_cfg, cache_format=cache_format),
            dataclasses.replace(cfg, cache_format=cache_format))


def _write_both(cache_format, positions, seed=0, ln=8):
    """One ``_ring_write`` of ``positions [B, S]`` into an empty ring of
    ``ln`` slots in both packages, on the same float32 k and v."""
    ref_cfg, cfg = _cfgs(cache_format)
    b, s = positions.shape
    rng = np.random.default_rng(seed)
    k, v = (rng.normal(size=(b, s, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
            for _ in range(2))
    ref_cache = ref_attention.init_kv_cache(ref_cfg, b, ln, dtype=jnp.float32)
    ref_cache = ref_attention._ring_write(
        ref_cache, jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions, jnp.int32),
        ref_kvcache.format_for(ref_cfg))
    cache = attention.init_kv_cache(cfg, b, ln, dtype=torch.float32, device="cpu")
    attention._ring_write(cache, torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(positions.astype(np.int32)),
                          kvcache.format_for(cfg))
    return ref_cache, cache


def _assert_caches_identical(ref_cache, cache):
    assert set(ref_cache) == set(cache)
    for key, want in ref_cache.items():
        want = np.asarray(want)
        got = cache[key].numpy()
        assert got.shape == want.shape, key
        # compare bits: plane words as int32 views, scales and payloads exactly
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=key)


class TestRingWriteMatchesReference:
    @pytest.mark.parametrize("cache_format", FORMATS)
    def test_prompt_longer_than_the_ring_keeps_the_newest_tokens(self, cache_format):
        """Row 0: 20 positions into 8 slots (each slot hit two or three
        times); row 1: 3 left pads, then 17 positions."""
        positions = np.stack([np.arange(20), np.arange(-3, 17)])
        ref_cache, cache = _write_both(cache_format, positions)
        _assert_caches_identical(ref_cache, cache)
        np.testing.assert_array_equal(cache["pos_ids"].numpy(),
                                      [[16, 17, 18, 19, 12, 13, 14, 15],
                                       [16, 9, 10, 11, 12, 13, 14, 15]])

    @pytest.mark.parametrize("cache_format", FORMATS)
    def test_writes_within_the_ring_are_unchanged(self, cache_format):
        """No two tokens share a slot: every live token is written, pads
        are not (the twin of ``test_ring_write_drops_negative_positions``)."""
        positions = np.array([[-2, -1, 0, 1], [5, 6, 7, 8]])
        ref_cache, cache = _write_both(cache_format, positions, seed=1)
        _assert_caches_identical(ref_cache, cache)
        np.testing.assert_array_equal(cache["pos_ids"].numpy(),
                                      [[0, 1, -1, -1, -1, -1, -1, -1],
                                       [8, -1, -1, -1, -1, 5, 6, 7]])


def _params(ref_cfg, cfg):
    ref_params = P.materialize(ref_model.specs(ref_cfg, 1), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    return ref_params, convert.params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("cache_format", FORMATS)
@pytest.mark.parametrize("prompt_len", [12, 20])
def test_decode_past_the_wrap_matches_reference(cache_format, prompt_len):
    """Teacher-forced decode of 8 tokens after a prompt of 12 (the ring of
    16 wraps at the fifth step) or of 20 (longer than the ring: the prefill
    write keeps positions 4..19).  Logits within LOGIT_RTOL of the
    reference at every step, and the same positions in every layer's ring."""
    ref_cfg, cfg = _cfgs(cache_format)
    ref_params, params = _params(ref_cfg, cfg)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, VOCAB, (1, prompt_len)).astype(np.int32)
    forced = rng.integers(0, VOCAB, size=8).astype(np.int32)
    cache_len = 16

    ref_lg, ref_caches = ref_model.prefill(ref_params, {"tokens": jnp.asarray(prompt)},
                                           ref_cfg, tp=1, max_len=cache_len)
    lg, caches = model_lib.prefill(params, {"tokens": torch.from_numpy(prompt)}, cfg,
                                   max_len=cache_len)
    steps = [(np.asarray(ref_lg[0, -1, :VOCAB]), lg[0, -1, :VOCAB].numpy())]
    for i, tok in enumerate(forced):
        pos = prompt_len + i
        ref_lg, ref_caches = ref_model.decode_step(
            ref_params, jnp.full((1, 1), tok, jnp.int32), ref_caches, jnp.int32(pos),
            ref_cfg, tp=1)
        lg, caches = model_lib.decode_step(params, torch.full((1, 1), int(tok)), caches,
                                           pos, cfg)
        steps.append((np.asarray(ref_lg[0, 0, :VOCAB]), lg[0, 0, :VOCAB].numpy()))
    for want, got in steps:
        err = np.abs(want - got).max() / (np.abs(want).max() + 1e-6)
        assert err < LOGIT_RTOL, err
    ref_pos = np.asarray(ref_caches["stack"]["slot0"]["pos_ids"])  # [layers, B, L]
    for i, cache in enumerate(caches):
        np.testing.assert_array_equal(cache["pos_ids"].numpy(), ref_pos[i])
        assert sorted(cache["pos_ids"][0].tolist()) == list(range(prompt_len + 8 - 16,
                                                                  prompt_len + 8))


class TestInt8CacheMatchesReference:
    def test_formats_are_the_references_contiguous_ones(self):
        assert kvcache.formats()[:4] == ("bf16", "int8", "int4_bp", "int4_bp_fused")
        assert kvcache.formats() == ref_kvcache.formats()  # and their paged_* liftings
        fmt = kvcache.get_cache_format("int8")
        store = fmt.init(2, 8, (3,), 40, device="cpu")
        assert store[""].dtype == torch.int8 and tuple(store[""].shape) == (2, 8, 3, 40)
        assert store["_scale"].dtype == torch.float32
        assert tuple(store["_scale"].shape) == (2, 8, 3)

    def test_qk_and_av_after_appends_with_pads(self):
        """A write with left pads and one past the ring's end, then the
        score and value reads on the same query and weights: payload and
        scales bit-identical (checked by _write_both's caller below), qk
        and av within 1e-6 of the reference's largest output."""
        positions = np.stack([np.arange(-3, 9), np.arange(12)])  # row 1 wraps the ring of 8
        ref_cache, cache = _write_both("int8", positions, seed=3)
        _assert_caches_identical(ref_cache, cache)
        ref_fmt = ref_kvcache.get_cache_format("int8")
        fmt = kvcache.get_cache_format("int8")
        rng = np.random.default_rng(4)
        b, ln, hkv, f = cache["k"].shape
        q = rng.normal(size=(b, hkv, 5, f)).astype(np.float32)
        w = rng.random((b, hkv, 5, ln)).astype(np.float32)
        pairs = (
            (fmt.qk(torch.from_numpy(q), fmt.channel(cache, "k")),
             ref_fmt.qk(jnp.asarray(q), ref_fmt.channel(ref_cache, "k"))),
            (fmt.av(torch.from_numpy(w), fmt.channel(cache, "v"), f),
             ref_fmt.av(jnp.asarray(w), ref_fmt.channel(ref_cache, "v"), f)),
        )
        for got, want in pairs:
            want = np.asarray(want)
            assert got.shape == want.shape
            assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()

    def test_int8_values_and_scales_bound_the_input(self):
        """Each stored slot is round(x / scale) in [-127, 127] with scale =
        max|x| / 127: the largest element of a slot stores as ±127."""
        positions = np.arange(6)[None]
        _, cache = _write_both("int8", positions, seed=5)
        q = cache["k"][0, :6].to(torch.int32)
        assert int(q.abs().amax()) == 127
        assert bool((q.abs().amax(dim=-1) == 127).all())
