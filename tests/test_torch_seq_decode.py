"""Sequence-parallel decode attention, in process: no rank is spawned.

A GQA ring of 12 slots (two rows: one written past the ring's end, one
holding 5 positions) is cut into 1, 2 and 3 contiguous blocks, one a
simulated rank (threads that all-reduce through a barrier, in rank order,
as :class:`repro_torch.models.attention.SeqParallel` would over the data
axis).  Each rank attends over its block and ``combine_blocks`` joins them.
Held for every contiguous cache format (``bf16``, ``int8``, ``int4_bp``
and ``int4_bp_fused`` through the kernel's plain version with its row
statistics): every rank's output equal, within 1e-5 of the largest output
of a float64 softmax over the whole ring (the format's own scores, its V
dequantized in float64), and the ring write of each rank's block equal to
its block of the whole ring.  At three blocks the short row leaves the last
block wholly masked; a planted combine that gives each block the weight of
its sum alone (so a masked block adds its uniform average) fails the limit.
The kernel's plain row max and sum are held against float64; on the card
(``gpu``-marked) the kernel's statistics against the plain version's.  A
spawned rank of ``tests/test_torch_data_axis.py`` imports neither JAX nor
the reference.

The same harness holds the other rings: MLA's latent ring (minicpm3-4b's
smoke mixer, every contiguous format) through ``mla_decode``, against the
absorbed decode with a float64 softmax over the whole ring (the format's
own latent scores, its latent dequantized in float64); a paged block
(``paged_*``: a pool of 6 pages under permuted block tables, cut into 1, 2
and 3 page ranges, the short row's pages all on rank 0, so that at three
ranges two ranks' blocks are wholly masked for it), each rank's writes its
pages of the whole pool's and its output the float64 softmax's; and an
``attn_cross`` layer (seamless-m4t-medium's decoder layer) whose self ring
is cut and whose context stays whole, against the one-device layer whose
self-attention is the float64 softmax.
"""

import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import bitplane, kvcache, paging
from repro_torch.kernels import plane_attn
from repro_torch.models import attention, stack
from repro_torch.models import model as model_lib

from _torch_inputs import attention_inputs, t

FORMATS = ("bf16", "int8", "int4_bp", "int4_bp_fused")
RING, HKV, GROUP, D_HEAD = 12, 2, 2, 32
#: row 0 writes positions 0..17 (wrapping the ring), row 1 positions 0..4
ROW_LENS = (18, 5)
TOL = 1e-5


class _Ranks:
    """In-process stand-ins for ``n`` ranks' all-reduces: each thread puts its
    tensor in its place and every one reduces them in rank order."""

    def __init__(self, n: int):
        self.n, self.barrier, self.parts = n, threading.Barrier(n, timeout=60), [None] * n

    def reduce(self, rank: int, x: torch.Tensor, op) -> torch.Tensor:
        self.parts[rank] = x.clone()
        self.barrier.wait()
        out = self.parts[0].clone()
        for part in self.parts[1:]:
            out = op(out, part)
        self.barrier.wait()
        return out


class _Seq:
    """The :class:`SeqParallel` interface of rank ``index`` of ``ranks``."""

    def __init__(self, ranks: _Ranks, index: int):
        self.ranks, self.index, self.ways = ranks, index, ranks.n

    def all_reduce_max(self, x):
        return self.ranks.reduce(self.index, x, torch.maximum)

    def all_reduce_sum(self, x):
        return self.ranks.reduce(self.index, x, torch.add)


def _on_ranks(n: int, fn) -> list:
    """``fn(rank)`` on ``n`` threads → the results in rank order."""
    out, errors = [None] * n, []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    if errors:
        raise errors[0]
    return out


def _cfg(fmt: str):
    return get_smoke_config("qwen3-1.7b").scaled(
        dtype=torch.float32, n_heads=HKV * GROUP, n_kv_heads=HKV, d_head=D_HEAD,
        cache_format=fmt)


def _inputs(seed: int = 0):
    """K and V of every written position ``[2, 18, Hkv, dh]``, their
    positions (row 1 padded with -1) and a decode query ``[2, 1, H, dh]``
    at each row's next position."""
    rng = np.random.default_rng(seed)
    s = max(ROW_LENS)
    k, v = (torch.from_numpy(rng.normal(size=(2, s, HKV, D_HEAD)).astype(np.float32))
            for _ in range(2))
    pos = torch.tensor([list(range(n)) + [-1] * (s - n) for n in ROW_LENS], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(2, 1, HKV * GROUP, D_HEAD)).astype(np.float32))
    cur = torch.tensor([[n] for n in ROW_LENS], dtype=torch.int32)
    return k, v, pos, q, cur


def _ring(cfg, ln: int, k, v, pos, seq=None) -> dict:
    cache = attention.init_kv_cache(cfg, 2, ln, dtype=torch.float32, device="cpu")
    attention._ring_write(cache, k, v, pos, kvcache.format_for(cfg), seq=seq)
    return cache


def _block(cache: dict, r: int, n: int) -> dict:
    ln = cache["pos_ids"].shape[1] // n
    return {name: x[:, r * ln:(r + 1) * ln].clone() for name, x in cache.items()}


def _dequant_v(fmt, store, feat: int = D_HEAD) -> torch.Tensor:
    """The stored channel ``[B, L, *lead, F]`` in float64 (a paged store
    gathered back to the ring first)."""
    if isinstance(fmt, paging.PagedCacheFormat):
        fmt, store = fmt.inner, fmt._gather(store)
    if fmt.name == "bf16":
        return store[""].double()
    if fmt.name == "int8":
        return store[""].double() * store["_scale"].double()[..., None]
    vals = bitplane.decode(store[""], signed=True)[..., :feat].double()
    return vals * store["_scale"].double()[..., None]


def _float64_attention(cfg, cache, q, cur) -> torch.Tensor:
    """The whole ring's decode attention with the format's own scores and a
    float64 softmax and value read → ``[B, 1, H, dh]``."""
    fmt = kvcache.format_for(cfg)
    b, _, h, dh = q.shape
    hkv = cache["k"].shape[2]
    qg = q.reshape(b, 1, hkv, h // hkv, dh).permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, dh)
    scores = fmt.qk(qg, fmt.channel(cache, "k")).double() / math.sqrt(dh)
    pos_ids = cache["pos_ids"]
    valid = (pos_ids >= 0) & (pos_ids <= cur)  # [B, L]
    scores = torch.where(valid[:, None, None, :], scores, attention.NEG_INF)
    w = torch.softmax(scores, dim=-1)
    vv = _dequant_v(fmt, fmt.channel(cache, "v"), dh).permute(0, 2, 1, 3)  # [B, Hkv, L, F]
    out = torch.einsum("bhgl,bhlf->bhgf", w, vv)
    return out.reshape(b, 1, h, dh)


def _sharded(cfg, n: int, q, cur, blocks) -> list:
    fmt = kvcache.format_for(cfg)
    ranks = _Ranks(n)
    return _on_ranks(n, lambda r: attention._decode_attention(
        q, blocks[r], cur=cur, fmt=fmt, impl="plain", seq=_Seq(ranks, r)))


def _err(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("fmt", FORMATS)
def test_combine_matches_a_float64_softmax(fmt, n):
    cfg = _cfg(fmt)
    k, v, pos, q, cur = _inputs()
    whole = _ring(cfg, RING, k, v, pos)
    ranks = _Ranks(n)
    written = _on_ranks(n, lambda r: _ring(cfg, RING // n, k, v, pos, seq=_Seq(ranks, r)))
    for r in range(n):  # the owning rank alone writes each slot, at its global place
        want = _block(whole, r, n)
        assert set(written[r]) == set(want)
        for name in want:
            assert torch.equal(written[r][name], want[name]), (r, name)
    outs = _sharded(cfg, n, q, cur, written)
    for other in outs[1:]:
        assert torch.equal(outs[0], other)
    want = _float64_attention(cfg, whole, q, cur)
    assert _err(outs[0], want) < TOL
    one = attention._decode_attention(q, whole, cur=cur, fmt=kvcache.format_for(cfg),
                                      impl="plain")
    assert _err(one, want) < TOL
    if n == 3:  # row 1's positions 0..4 lie in blocks 0 and 1: block 2 is wholly masked
        assert bool((written[2]["pos_ids"][1] < 0).all())


def _averaging_combine(out, m, total, seq):
    """Planted: each block weighted by its sum alone, as if every block's
    max were the global one, so that a wholly masked block adds its uniform
    average."""
    packed = seq.all_reduce_sum(torch.cat([out * total[..., None], total[..., None]], dim=-1))
    return packed[..., :-1] / packed[..., -1:]


@pytest.mark.parametrize("fmt", FORMATS)
def test_a_combine_that_averages_a_masked_block_fails(fmt, monkeypatch):
    cfg = _cfg(fmt)
    k, v, pos, q, cur = _inputs()
    whole = _ring(cfg, RING, k, v, pos)
    blocks = [_block(whole, r, 3) for r in range(3)]
    want = _float64_attention(cfg, whole, q, cur)
    assert _err(_sharded(cfg, 3, q, cur, blocks)[0], want) < TOL
    monkeypatch.setattr(attention, "combine_blocks", _averaging_combine)
    got = _sharded(cfg, 3, q, cur, blocks)[0]
    assert _err(got[1], want[1]) > 100 * TOL  # the row whose last block is masked


def _copy(cache: dict) -> dict:
    return {name: x.clone() for name, x in cache.items()}


def _mla_setup(fmt: str):
    """minicpm3-4b's smoke MLA mixer (float32, every norm drawn off its
    init), the latent of :data:`ROW_LENS`' positions written to a whole
    ring of :data:`RING` slots, an empty ring, and a decode token a row."""
    cfg = get_smoke_config("minicpm3-4b").scaled(dtype=torch.float32, cache_format=fmt)
    params = model_lib.materialize(cfg, seed=3, device="cpu")["layers"][0]["mixer"]
    gen = torch.Generator().manual_seed(4)
    params = {k: w + 0.3 * torch.randn(w.shape, generator=gen) if k.endswith("norm") else w
              for k, w in params.items()}
    rng = np.random.default_rng(5)
    s = max(ROW_LENS)
    x = torch.from_numpy(rng.normal(size=(2, s, cfg.d_model)).astype(np.float32))
    pos = torch.tensor([list(range(n)) + [-1] * (s - n) for n in ROW_LENS], dtype=torch.int32)
    c_kv, k_rope = attention._mla_latent(params, x, cfg, pos)
    empty = attention.init_mla_cache(cfg, 2, RING, dtype=torch.float32, device="cpu")
    whole = _copy(empty)
    attention._mla_write(whole, c_kv, k_rope, pos, kvcache.format_for(cfg))
    x_new = torch.from_numpy(rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32))
    cur = torch.tensor([[n] for n in ROW_LENS], dtype=torch.int32)
    return cfg, params, (c_kv, k_rope, pos), empty, whole, x_new, cur


def _float64_mla(cfg, params, cache, x, cur) -> torch.Tensor:
    """The absorbed MLA decode of ``x`` over the whole latent ring (the new
    token written) with the format's own latent scores, and a float64 rope
    term, softmax, latent read, ``w_uv`` and ``wo``."""
    fmt = kvcache.format_for(cfg)
    b, s, _ = x.shape
    dn, dr, dv, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    q_nope, q_rope = attention._mla_q(params, x, cfg, cur)
    h = q_nope.shape[2]
    w_uk = params["w_uk"].reshape(r, h, dn).to(torch.float32)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope.to(torch.float32), w_uk)
    ln = cache["pos_ids"].shape[1]
    s_nope = fmt.qk(q_abs.reshape(b, s * h, r), fmt.channel(cache, "c_kv")).reshape(b, s, h, ln)
    rope = torch.einsum("bqhd,bld->bqhl", q_rope.double(), cache["k_rope"].double())
    scores = (s_nope.double() + rope) / math.sqrt(dn + dr)
    pos_ids = cache["pos_ids"]
    valid = (pos_ids[:, None, :] >= 0) & (pos_ids[:, None, :] <= cur[..., None])
    w = torch.softmax(torch.where(valid[:, :, None, :], scores, attention.NEG_INF), dim=-1)
    ctx = torch.einsum("bqhl,blr->bqhr", w, _dequant_v(fmt, fmt.channel(cache, "c_kv"), r))
    out = torch.einsum("bqhr,rhv->bqhv", ctx, params["w_uv"].reshape(r, h, dv).double())
    return out.reshape(b, s, h * dv) @ params["wo"].double()


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("fmt", FORMATS)
def test_mla_latent_blocks_match_a_float64_softmax(fmt, n):
    """MLA's latent ring cut into ``n`` blocks: each rank's latent, rope key
    and positions written are its block of the whole ring's, and
    ``mla_decode`` over the blocks (its latent context joined by the
    combine before ``w_uv``) gives every rank the same output, within 1e-5
    of the float64 absorbed decode over the whole ring."""
    cfg, params, (c_kv, k_rope, pos), empty, whole, x_new, cur = _mla_setup(fmt)
    ranks = _Ranks(n)

    def rank(r):
        block = _block(empty, r, n)
        attention._mla_write(block, c_kv, k_rope, pos, kvcache.format_for(cfg),
                             seq=_Seq(ranks, r))
        for name, want in _block(whole, r, n).items():
            assert torch.equal(block[name], want), (r, name)
        return attention.mla_decode(params, x_new, block, cfg, pos=cur, impl="plain",
                                    seq=_Seq(ranks, r))[0]

    outs = _on_ranks(n, rank)
    for other in outs[1:]:
        assert torch.equal(outs[0], other)
    one, after = attention.mla_decode(params, x_new, _copy(whole), cfg, pos=cur, impl="plain")
    want = _float64_mla(cfg, params, after, x_new, cur)
    assert _err(outs[0], want) < TOL
    assert _err(one, want) < TOL


PAGED_FORMATS = tuple(f"paged_{f}" for f in FORMATS)
#: the paged ring: 3 pages of 8 a row, a pool of 6 pages, permuted tables;
#: row 1's five positions lie on page 0 (rank 0's at every cut)
PAGED_RING, PAGED_TABLES = 24, ((4, 1, 3), (0, 5, 2))
PAGED_LENS = (30, 5)


def _paged_inputs(fmt: str):
    cfg = _cfg(fmt)
    rng = np.random.default_rng(6)
    s = max(PAGED_LENS)
    k, v = (torch.from_numpy(rng.normal(size=(2, s, HKV, D_HEAD)).astype(np.float32))
            for _ in range(2))
    pos = torch.tensor([list(range(n)) + [-1] * (s - n) for n in PAGED_LENS], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(2, 1, HKV * GROUP, D_HEAD)).astype(np.float32))
    cur = torch.tensor([[n] for n in PAGED_LENS], dtype=torch.int32)
    empty = attention.init_kv_cache(cfg, 2, PAGED_RING, dtype=torch.float32, device="cpu")
    for name in ("k_pages", "v_pages"):
        empty[name] = torch.tensor(PAGED_TABLES, dtype=torch.int32)
    whole = _copy(empty)
    attention._ring_write(whole, k, v, pos, kvcache.format_for(cfg))
    return cfg, (k, v, pos), empty, whole, q, cur


def _page_block(cache: dict, r: int, n: int) -> dict:
    """Rank ``r`` of ``n``'s cut of a paged cache: its block of the pool's
    pages, the tables and positions whole (``partitioning.shard_caches``'
    cut under kv_seq rules)."""
    out = {}
    for name, x in cache.items():
        if name in paging.POOL_KEYS:
            per = x.shape[0] // n
            x = x[r * per:(r + 1) * per]
        out[name] = x.clone()
    return out


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("fmt", PAGED_FORMATS)
def test_paged_blocks_match_a_float64_softmax(fmt, n):
    """A paged GQA cache over ``n`` ranges of the pool's pages: each rank
    writes the tokens whose page it holds (its pool block equal to the whole
    pool's, the positions whole), attends over the ring slots whose pages it
    holds, and the combine gives every rank the whole ring's output within
    1e-5 of a float64 softmax; at three ranges row 1 is wholly masked on
    ranks 1 and 2."""
    cfg, (k, v, pos), empty, whole, q, cur = _paged_inputs(fmt)
    fmt_ = kvcache.format_for(cfg)
    ranks = _Ranks(n)

    def rank(r):
        seq = _Seq(ranks, r)
        block = _page_block(empty, r, n)
        attention._ring_write(block, k, v, pos, fmt_, seq=seq)
        for name, want in _page_block(whole, r, n).items():
            assert torch.equal(block[name], want), (r, name)
        owned = attention._rank_pages(block, seq)[1]
        live = owned & (block["pos_ids"] >= 0)
        return (attention._decode_attention(q, block, cur=cur, fmt=fmt_, impl="plain", seq=seq),
                bool(live[1].any()))

    outs = _on_ranks(n, rank)
    for other, _ in outs[1:]:
        assert torch.equal(outs[0][0], other)
    want = _float64_attention(cfg, whole, q, cur)
    assert _err(outs[0][0], want) < TOL
    assert [live for _, live in outs] == [True] + [False] * (n - 1)


def _cross_setup():
    """seamless-m4t-medium's smoke decoder layer (float32, norms, biases and
    gates drawn off their init): a prefill of two prompts (18 and 5
    tokens, the second left-padded) over a context of its encoder's
    length, leaving a self ring of :data:`RING` slots (wrapped) and the
    context's K/V."""
    cfg = get_smoke_config("seamless-m4t-medium").scaled(dtype=torch.float32)
    p = model_lib.materialize(cfg, seed=7, device="cpu")["layers"][0]
    gen = torch.Generator().manual_seed(8)

    def off(tree):
        if isinstance(tree, dict):
            return {k: off(v) for k, v in tree.items()}
        return tree + 0.3 * torch.randn(tree.shape, generator=gen) if tree.ndim < 2 else tree

    p = off(p)
    rng = np.random.default_rng(9)
    s = max(ROW_LENS)
    x = torch.from_numpy(rng.normal(size=(2, s, cfg.d_model)).astype(np.float32))
    pos = torch.tensor([[-1] * (s - n) + list(range(n)) for n in ROW_LENS], dtype=torch.int32)
    ctx = torch.from_numpy(rng.normal(size=(2, cfg.encoder_tokens, cfg.d_model))
                           .astype(np.float32))
    _, cache, _ = stack.layer_apply(p, x, cfg, mode="prefill", mixer="attn_cross", pos=pos,
                                    cache_len=RING, ctx=ctx)
    x_new = torch.from_numpy(rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32))
    cur = torch.tensor([[n] for n in ROW_LENS], dtype=torch.int32)
    return cfg, p, cache, x_new, cur


def test_attn_cross_layer_cuts_its_ring_and_keeps_its_context(monkeypatch):
    """An ``attn_cross`` layer's decode over 2 and 3 ranks: its self ring cut
    into blocks and combined, its context K/V whole on every rank (the
    cross branch computed as on one device); every rank's output equal,
    within 1e-5 of the one-device layer whose self-attention is a float64
    softmax over the whole ring."""
    cfg, p, cache, x_new, cur = _cross_setup()

    def layer(c, seq=None):
        return stack.layer_apply(p, x_new, cfg, mode="decode", mixer="attn_cross", cache=c,
                                 pos=cur, impl="plain", seq=seq)[0]

    with monkeypatch.context() as m:  # the self-attention in float64 over the whole ring
        m.setattr(attention, "_decode_attention",
                  lambda q, c, *, cur, fmt, **kw: _float64_attention(cfg, c, q, cur).to(q.dtype))
        want = layer({"self": _copy(cache["self"]), "cross": cache["cross"]}).double()
    one = layer({"self": _copy(cache["self"]), "cross": cache["cross"]})
    assert _err(one, want) < TOL
    for n in (2, 3):
        ranks = _Ranks(n)
        outs = _on_ranks(n, lambda r: layer(
            {"self": _block(cache["self"], r, n), "cross": cache["cross"]}, _Seq(ranks, r)))
        for other in outs[1:]:
            assert torch.equal(outs[0], other)
        assert _err(outs[0], want) < TOL


def _float64_stats(a) -> np.ndarray:
    """Each row's max and sum of e^(score - max) over L in float64, the
    scores as the kernel forms them: integer plane scores, scales, bias."""
    kp = t(a["kp"]).permute(0, 2, 1, 3, 4)
    s_int = plane_attn.bsdp_matmul_planes(a["q_planes"], kp, signed=True).double()
    scores = (s_int * a["q_scale"].double()[..., None]
              * torch.from_numpy(a["ks"]).double().permute(0, 2, 1)[..., None, :] * a["sm"]
              + torch.from_numpy(a["bias"]).double())
    m = scores.amax(-1)
    return torch.stack([m, torch.exp(scores - m[..., None]).sum(-1)], -1).numpy()


def test_plain_kernel_statistics_match_float64():
    """``plane_decode_attention_plain(..., stats=True)``: the output is the
    one without statistics, bit for bit, and each row's max and sum are the
    float64 ones (the max to float32 rounding, the sum within 1e-5)."""
    a = attention_inputs()
    args = [a["q_planes"], a["q_scale"], t(a["kp"]), torch.from_numpy(a["ks"]),
            t(a["vp"]), torch.from_numpy(a["vs"]), torch.from_numpy(a["bias"])]
    out, st = plane_attn.plane_decode_attention_plain(*args, sm_scale=a["sm"], stats=True)
    assert torch.equal(out, plane_attn.plane_decode_attention_plain(*args, sm_scale=a["sm"]))
    assert st.shape == out.shape[:-1] + (2,) and st.dtype == torch.float32
    want = _float64_stats(a)
    np.testing.assert_allclose(st[..., 0].numpy(), want[..., 0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st[..., 1].numpy(), want[..., 1], rtol=1e-5)
    # the wrapper takes the plain version on CPU tensors, statistics included
    got = plane_attn.plane_decode_attention(*args, sm_scale=a["sm"], stats=True)
    assert torch.equal(got[0], out) and torch.equal(got[1], st)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_statistics_match_the_plain_version(cuda):
    """On the card: the launch with statistics gives the output of the
    launch without them, and its row max and sum within 1e-4 of the plain
    version's."""
    a = attention_inputs()
    args = [a["q_planes"], a["q_scale"], t(a["kp"]), torch.from_numpy(a["ks"]),
            t(a["vp"]), torch.from_numpy(a["vs"]), torch.from_numpy(a["bias"])]
    want_out, want_st = plane_attn.plane_decode_attention_plain(*args, sm_scale=a["sm"],
                                                                stats=True)
    on = [x.to(cuda) for x in args]
    out, st = plane_attn.plane_decode_attention(*on, sm_scale=a["sm"], stats=True)
    assert torch.equal(out, plane_attn.plane_decode_attention(*on, sm_scale=a["sm"]))
    torch.testing.assert_close(out.cpu(), want_out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st.cpu(), want_st, rtol=1e-4, atol=1e-4)


def test_data_axis_rank_imports_neither_jax_nor_repro():
    """``tests/_torch_data_rank.py`` and the modules its parts run stay clear
    of JAX and the reference."""
    here = Path(__file__).resolve().parent
    probe = ("import sys; sys.path.insert(0, %r); import _torch_data_rank\n"
             "from repro_torch import configs, convert\n"
             "from repro_torch.distributed import mesh\n"
             "from repro_torch.launch import dryrun, mesh as launch_mesh\n"
             "from repro_torch.serve import engine\n"
             "from repro_torch.sharding import partitioning\n"
             "print(','.join(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))))" % str(here))
    env = dict(os.environ, PYTHONPATH=str(here.parent / "src"))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    assert out.stdout.strip() == ""
