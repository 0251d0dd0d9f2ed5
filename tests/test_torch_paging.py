"""Paged KV residency in the port against the JAX reference.

Twins of ``tests/test_paging.py``: the page pool and the radix prefix index
driven by the same seeded call sequences in both packages (equal return
values and ``stats()`` after every call, the same refusals); the four
``paged_*`` formats (the ring rounded up to whole pages; under identity and
permuted block tables the port's gather holds the bits of its contiguous
ring and of the reference's gather; ``qk``, ``av`` and the fused read
within the kernel tests' tolerances of the reference's); and the engines on
the reference's traces, in float32: paged against contiguous with slot
reuse and a ring wrap for qwen3-1.7b, minicpm3-4b (MLA: the latent paged,
``k_rope`` a slot) and mixtral-8x7b (its window kept), ``paged_int4_bp``
against ``paged_int4_bp_fused``, four slots sharing a prompt prefix on an
8-page pool, the copy-on-write of a shared page on the wrap, a pool too
small for one request, and no page stats off the paged formats.  The
port's paged serve holds its contiguous serve's tokens and every logit
row bit for bit; against the reference, the tokens, the logits within
``LOGIT_RTOL`` of the largest and the page stats key for key.  The port
runs on the CPU, where every kernel wrapper takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as ref_kvcache
from repro.core import paging as ref_paging
from repro.models import attention as ref_attention
from repro.serve import engine as ref_engine
from repro_torch.core import kvcache, paging
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.serve import engine

from test_torch_mla import cfgs, max_rel_err, port_params, ref_params
from test_torch_serve import LOGIT_RTOL

VOCAB = 128
BASES = ["bf16", "int8", "int4_bp", "int4_bp_fused"]
#: path A's weight residency, served over its fused cache's paged lifting
PATH_A = "ffn=bsdp_fused,mixer=w8a16"


# ---------------------------------------------------------------------------
# PagePool and RadixPrefixIndex: the same call sequences in both packages
# ---------------------------------------------------------------------------


def _outcome(fn, *args):
    """(return value as plain Python, or the exception's type name)."""
    try:
        out = fn(*args)
    except (paging.PoolExhausted, ref_paging.PoolExhausted) as e:
        return "PoolExhausted", str(e)
    except ValueError as e:
        return "ValueError", str(e)
    return np.asarray(out).tolist() if out is not None else None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_matches_reference_call_for_call(seed):
    """200 seeded calls of alloc / retain / release / note_*, wrong ones
    (exhaustion, retaining or releasing a free page) among them: the same
    return values, refusals and ``stats()`` after each call."""
    rng = np.random.default_rng(seed)
    pools = paging.PagePool(12, 8), ref_paging.PagePool(12, 8)
    held: list = []
    for _ in range(200):
        op = rng.choice(["alloc", "retain", "release", "bad", "cow", "evict", "hit"])
        if op == "alloc":
            args = ("alloc", int(rng.integers(1, 6)))
        elif op in ("retain", "release") and held:
            args = (op, [held[int(i)] for i in rng.integers(0, len(held), size=2)])
        elif op == "bad":
            free = [p for p in range(12) if pools[0].refs[p] == 0]
            if not free:
                continue
            args = (str(rng.choice(["retain", "release"])), [free[0]])
        elif op == "cow":
            args = ("note_cow", int(rng.integers(1, 3)))
        elif op == "evict":
            args = ("note_eviction", int(rng.integers(1, 3)))
        elif op == "hit":
            args = ("note_prefix_hit", int(rng.integers(8, 64)))
        else:
            continue
        got, want = (_outcome(getattr(pool, args[0]), *args[1:]) for pool in pools)
        assert got == want, args
        if args[0] == "alloc" and isinstance(got, list):
            held += got
        elif args[0] == "retain" and got is None:
            held += args[1]
        elif args[0] == "release" and isinstance(got, list):
            for p in args[1]:
                held.remove(p)
        assert pools[0].stats() == pools[1].stats()
        np.testing.assert_array_equal(pools[0].refs, pools[1].refs)
    assert pools[0].total_allocated > 0 and pools[0].total_freed > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_radix_prefix_index_matches_reference_call_for_call(seed):
    """Seeded ``insert`` / ``match`` / ``evict_lru`` (with and without a
    filter) over prompts sharing prefixes: the same pages back, the same
    evictions, the same size after every call."""
    rng = np.random.default_rng(seed)
    idx = paging.RadixPrefixIndex(4), ref_paging.RadixPrefixIndex(4)
    stems = [rng.integers(0, 6, size=12) for _ in range(3)]
    next_page = 0
    for _ in range(120):
        stem = stems[int(rng.integers(0, 3))]
        toks = np.concatenate([stem[:int(rng.integers(0, 13))],
                               rng.integers(0, 6, size=int(rng.integers(0, 9)))])
        op = rng.choice(["insert", "match", "evict", "evict_odd"])
        if op == "insert":
            pages = list(range(next_page, next_page + len(toks) // 4))
            next_page += len(pages)
            args = ("insert", toks, pages)
        elif op == "match":
            args = ("match", toks)
        elif op == "evict":
            args = ("evict_lru",)
        else:
            args = ("evict_lru", lambda p: p % 2 == 1)
        got, want = (_outcome(getattr(i, args[0]), *args[1:]) for i in idx)
        assert got == want, args[0]
        assert idx[0].size == idx[1].size
    assert next_page > 0


# ---------------------------------------------------------------------------
# The paged formats
# ---------------------------------------------------------------------------


def test_registry_lifts_every_base_like_the_reference():
    for base in BASES:
        fmt, ref_fmt = (m.get_cache_format(f"paged_{base}") for m in (kvcache, ref_kvcache))
        assert isinstance(fmt, paging.PagedCacheFormat) and fmt.inner.name == base
        assert fmt.suffixes == ref_fmt.suffixes == fmt.inner.suffixes + ("_pages",)
        assert fmt.supports_fused_decode == ref_fmt.supports_fused_decode
    assert paging.POOL_KEYS == ref_paging.POOL_KEYS
    assert paging.TABLE_KEYS == ref_paging.TABLE_KEYS
    assert paging.PAGED_BASES == ref_paging.PAGED_BASES


@pytest.mark.parametrize("base", BASES)
def test_slot_capacity_rounds_to_whole_pages(base):
    fmt, ref_fmt = (m.get_cache_format(f"paged_{base}") for m in (kvcache, ref_kvcache))
    for n in (1, 7, 8, 9, 16, 20, 512, 513):
        assert fmt.slot_capacity(n) == ref_fmt.slot_capacity(n) == -(-n // 8) * 8
        assert fmt.pages_per_slot(n) == ref_fmt.pages_per_slot(n)
    assert kvcache.get_cache_format(base).slot_capacity(13) == 13


#: writes into a ring of 20 requested slots (24 after rounding, 3 pages):
#: left pads, a wrap, and one row idle in the third write
WRITES = (np.stack([np.arange(-2, 8), np.arange(10)]),
          np.stack([np.arange(8, 18), np.arange(10, 20)]),
          np.stack([np.full(6, -1), np.arange(20, 26)]))


def _write_both(base, table=None, seed=0):
    """The same ``_ring_write`` stream into the port's contiguous ring of 24
    slots and its paged store asked for 20 (rounded up to 24: block tables
    ``table`` if given, else the identity), and into the reference's
    stores."""
    out = []
    rng = np.random.default_rng(seed)
    for cache_format, ln in ((base, 24), (f"paged_{base}", 20)):
        ref_cfg, cfg = cfgs("qwen3-1.7b", vocab_size=VOCAB, cache_format=cache_format)
        cache = attention.init_kv_cache(cfg, 2, ln, dtype=torch.float32, device="cpu")
        ref_cache = ref_attention.init_kv_cache(ref_cfg, 2, ln, dtype=jnp.float32)
        if table is not None and cache_format.startswith("paged"):
            for key in paging.TABLE_KEYS & set(cache):
                cache[key].copy_(torch.from_numpy(table))
                ref_cache[key] = jnp.asarray(table)
        for positions in WRITES:
            k, v = (rng.normal(size=(2, positions.shape[1], cfg.n_kv_heads, cfg.d_head))
                    .astype(np.float32) for _ in range(2))
            attention._ring_write(cache, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(positions.astype(np.int32)),
                                  kvcache.format_for(cfg))
            ref_cache = ref_attention._ring_write(
                ref_cache, jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions, jnp.int32),
                ref_kvcache.format_for(ref_cfg))
        out.append((cache, ref_cache))
        rng = np.random.default_rng(seed)  # the same k, v for the paged store
    return out


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("permuted", [False, True], ids=["identity", "permuted"])
@pytest.mark.parametrize("base", BASES)
def test_gather_holds_the_ring_bit_for_bit(base, permuted):
    """The paged store's gather equals the contiguous ring's payloads and
    scales bit for bit, and the reference's gather of its own paged store
    under the same block table; ``pos_ids`` equal too."""
    table = (np.random.default_rng(3).permutation(6).astype(np.int32).reshape(2, 3)
             if permuted else None)
    (ring, _), (paged, ref_paged) = _write_both(base, table)
    fmt = kvcache.get_cache_format(f"paged_{base}")
    ref_fmt = ref_kvcache.get_cache_format(f"paged_{base}")
    assert paged["pos_ids"].shape == ring["pos_ids"].shape == (2, 24)
    np.testing.assert_array_equal(paged["pos_ids"].numpy(), ring["pos_ids"].numpy())
    np.testing.assert_array_equal(paged["pos_ids"].numpy(), np.asarray(ref_paged["pos_ids"]))
    for prefix in ("k", "v"):
        got = fmt._gather(fmt.channel(paged, prefix))
        want = ref_fmt._gather(ref_fmt.channel(ref_paged, prefix))
        contiguous = fmt.inner.channel(ring, prefix)
        for sfx in fmt.inner.suffixes:
            assert tuple(got[sfx].shape) == tuple(want[sfx].shape)
            np.testing.assert_array_equal(_bits(got[sfx].numpy()), _bits(want[sfx]))
            np.testing.assert_array_equal(_bits(got[sfx].numpy()),
                                          _bits(contiguous[sfx].numpy()))


@pytest.mark.parametrize("base", BASES)
def test_reads_match_reference(base):
    """``qk`` and ``av`` of every paged format, and the fused read of
    ``paged_int4_bp_fused``, on a permuted table against the reference's:
    within 1e-6 of the largest output (``tests/test_torch_kvcache.py``'s
    limit) and 1e-4 for the fused read (the kernel tests')."""
    table = np.array([[4, 0, 2], [1, 5, 3]], np.int32)
    _, (paged, ref_paged) = _write_both(base, table, seed=1)
    fmt = kvcache.get_cache_format(f"paged_{base}")
    ref_fmt = ref_kvcache.get_cache_format(f"paged_{base}")
    rng = np.random.default_rng(5)
    hkv, f = paged["k"].shape[2], 16
    q = rng.normal(size=(2, hkv, 3, f)).astype(np.float32)
    w = rng.random((2, hkv, 3, 24)).astype(np.float32)
    pairs = [(fmt.qk(torch.from_numpy(q), fmt.channel(paged, "k")),
              ref_fmt.qk(jnp.asarray(q), ref_fmt.channel(ref_paged, "k")), 1e-6),
             (fmt.av(torch.from_numpy(w), fmt.channel(paged, "v"), f),
              ref_fmt.av(jnp.asarray(w), ref_fmt.channel(ref_paged, "v"), f), 1e-6)]
    if fmt.supports_fused_decode:
        pos = paged["pos_ids"].numpy()
        bias = np.where(pos >= 0, 0.0, -1e30).astype(np.float32)
        bias = np.ascontiguousarray(np.broadcast_to(bias[:, None, None], (2, hkv, 3, 24)))
        kw = dict(sm_scale=0.25, feat=f)
        pairs.append((
            fmt.decode_attention(torch.from_numpy(q), fmt.channel(paged, "k"),
                                 fmt.channel(paged, "v"), torch.from_numpy(bias), **kw),
            ref_fmt.decode_attention(jnp.asarray(q), ref_fmt.channel(ref_paged, "k"),
                                     ref_fmt.channel(ref_paged, "v"), jnp.asarray(bias), **kw),
            1e-4))
    for got, want, tol in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


# ---------------------------------------------------------------------------
# Engines on tests/test_paging.py's traces
# ---------------------------------------------------------------------------


def _run(eng, prompts, max_news):
    reqs = [eng.submit(p, mn) for p, mn in zip(prompts, max_news)]
    live = 0
    while eng.step():
        live = max(live, sum(r is not None for r in eng.active))
    return reqs, live


def _serves(arch, mode, caches, prompts, max_news, *, scheduler="fcfs", slots=2,
            max_len=16, pool=None, reference=True):
    """The port's serve under each cache format of ``caches`` and the
    reference's under the last: {name: (engine, requests, most live slots)}."""
    out = {}
    for cache in caches:
        kw = dict(page_pool_pages=pool) if cache.startswith("paged") else {}
        eng = engine.ServeEngine(port_params(arch), cfgs(arch, vocab_size=VOCAB)[1],
                                 slots=slots, max_len=max_len, mode=mode, cache_format=cache,
                                 scheduler=scheduler, min_dim=16, trace_logits=True,
                                 device="cpu", **kw)
        out[cache] = (eng, *_run(eng, prompts, max_news))
    if reference:
        kw = dict(page_pool_pages=pool) if caches[-1].startswith("paged") else {}
        ref = ref_engine.ServeEngine(ref_params(arch), cfgs(arch, vocab_size=VOCAB)[0],
                                     slots=slots, max_len=max_len, mode=mode,
                                     cache_format=caches[-1], scheduler=scheduler, min_dim=16,
                                     trace_logits=True, **kw)
        out["reference"] = (ref, *_run(ref, prompts, max_news))
    return out


def _assert_bitwise_equal_serves(a, b):
    (ea, ra, _), (eb, rb, _) = a, b
    assert [r.out for r in ra] == [r.out for r in rb]
    assert [(k, s) for k, s, _ in ea.logit_trace] == [(k, s) for k, s, _ in eb.logit_trace]
    for (_, _, x), (_, _, y) in zip(ea.logit_trace, eb.logit_trace):
        assert np.array_equal(x, y)


def _assert_matches_reference(port, ref):
    (eng, reqs, live), (ref_eng, ref_reqs, ref_live) = port, ref
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert max_rel_err(ref_eng, eng) < LOGIT_RTOL
    assert live == ref_live
    assert eng.stats().pages == ref_eng.stats().pages


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=(n,)).astype(np.int32) for n in lens]


#: (arch, weights, the paged format): float weights on the three configs of
#: tests/test_paging.py, and path A's stack on its fused cache
ENGINE_CASES = [("qwen3-1.7b", "bf16", "paged_int4_bp"),
                ("minicpm3-4b", "bf16", "paged_int4_bp"),
                ("mixtral-8x7b", "bf16", "paged_int4_bp"),
                ("qwen3-1.7b", PATH_A, "paged_int4_bp_fused")]


@pytest.mark.parametrize("arch, mode, paged", ENGINE_CASES,
                         ids=["qwen3", "minicpm3", "mixtral", "qwen3-pathA"])
def test_paged_serve_matches_contiguous_and_reference(arch, mode, paged):
    """Five requests over two slots (slot reuse), one decoding past the
    ring of 16 (7 + 12 positions: the wrap recycles its first page): the
    port's paged serve equals its contiguous serve bit for bit, tokens and
    logits, and the reference's paged serve within LOGIT_RTOL with equal
    page stats."""
    assert (cfgs(arch)[1].sliding_window is not None) == (arch == "mixtral-8x7b")
    prompts, max_news = _prompts((5, 3, 7, 6, 4)), (6, 2, 4, 12, 3)
    got = _serves(arch, mode, [paged.removeprefix("paged_"), paged], prompts, max_news)
    _assert_bitwise_equal_serves(got[paged.removeprefix("paged_")], got[paged])
    assert all(len(r.out) == mn for r, mn in zip(got[paged][1], max_news))
    _assert_matches_reference(got[paged], got["reference"])
    st = got[paged][0].stats().pages
    assert st["num_pages"] == 2 * 2 and st["total_allocated"] == 5 * 2
    if arch == "minicpm3-4b":
        layer = got[paged][0].caches[0]
        assert tuple(layer["c_kv_pages"].shape) == (2, 2)
        assert tuple(layer["k_rope"].shape[:2]) == (2, 16)
    assert all(v == 0 for v in ops.launch_counts().values())


def test_paged_fused_read_matches_the_plane_math():
    """``paged_int4_bp`` (plane math) against ``paged_int4_bp_fused`` (the
    fused read's plain version): the same tokens, logits within LOGIT_RTOL
    (the softmax is summed in another order)."""
    prompts = _prompts((6, 6), seed=1)
    got = _serves("qwen3-1.7b", "bf16", ["paged_int4_bp", "paged_int4_bp_fused"], prompts,
                  (5, 5), reference=False)
    (a, ra, _), (b, rb, _) = got["paged_int4_bp"], got["paged_int4_bp_fused"]
    assert [r.out for r in ra] == [r.out for r in rb]
    assert max_rel_err(a, b) < LOGIT_RTOL


def _shared_prompts(n, prefix_len, suffix_len):
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, VOCAB, size=(prefix_len,)).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, VOCAB, size=(suffix_len,)).astype(np.int32)])
            for _ in range(n)]


def test_prefix_sharing_holds_four_slots_on_an_eight_page_pool():
    """Six requests sharing a 24-token prefix under ``prefix_cache``, four
    slots of 4 pages on a pool of 8: four slots live at once, every
    request's tokens those of the contiguous serve (whose steps differ:
    there every request prefills its whole prompt), and the reference's
    tokens, logits and page stats."""
    prompts = _shared_prompts(6, 24, 2)
    got = _serves("qwen3-1.7b", "bf16", ["int4_bp", "paged_int4_bp"], prompts, (3,) * 6,
                  scheduler="prefix_cache", slots=4, max_len=32, pool=8)
    (eng, reqs, live), (_, ring_reqs, _) = got["paged_int4_bp"], got["int4_bp"]
    assert [r.out for r in reqs] == [r.out for r in ring_reqs]
    assert live == 4
    st = eng.stats().pages
    assert st["peak_in_use"] <= 8 and st["prefix_hits"] >= 3
    assert st["prefix_tokens_saved"] >= 3 * 24 and st["cow_copies"] == 0
    _assert_matches_reference(got["paged_int4_bp"], got["reference"])


def test_copy_on_write_on_the_wrap_into_a_shared_page():
    """Three requests with an 8-token shared prefix on two slots: the third
    attaches to the indexed page and wraps the ring of 16 onto it, so the
    write copies the page first; tokens those of the contiguous serve and
    the reference's, page stats the reference's."""
    prompts = _shared_prompts(3, 8, 2)
    got = _serves("qwen3-1.7b", "bf16", ["int4_bp", "paged_int4_bp"], prompts, (8, 8, 8),
                  scheduler="prefix_cache", pool=8)
    (eng, reqs, _), (_, ring_reqs, _) = got["paged_int4_bp"], got["int4_bp"]
    assert [r.out for r in reqs] == [r.out for r in ring_reqs]
    st = eng.stats().pages
    assert st["cow_copies"] >= 1 and st["prefix_hits"] >= 1
    _assert_matches_reference(got["paged_int4_bp"], got["reference"])


def test_pool_too_small_for_one_request_raises():
    for mod, params, cfg in ((engine, port_params("qwen3-1.7b"), cfgs(vocab_size=VOCAB)[1]),
                             (ref_engine, ref_params("qwen3-1.7b"), cfgs(vocab_size=VOCAB)[0])):
        kw = {"device": "cpu"} if mod is engine else {}
        eng = mod.ServeEngine(params, cfg, slots=1, max_len=32,
                              cache_format="paged_bf16", scheduler="prefix_cache",
                              page_pool_pages=2, **kw)
        eng.submit(np.arange(10, dtype=np.int32), 2)
        with pytest.raises((paging.PoolExhausted, ref_paging.PoolExhausted),
                           match="cannot hold one request"):
            eng.run()


def test_page_stats_only_on_paged_formats():
    got = _serves("qwen3-1.7b", "bf16", ["int8", "paged_int8"], [np.arange(5, dtype=np.int32)],
                  (2,), reference=False)
    assert got["int8"][0].stats().pages is None and got["int8"][0]._view().pages is None
    pages = got["paged_int8"][0].stats().pages
    assert pages["pages_in_use"] >= 0 and pages["num_pages"] == 2 * 2
