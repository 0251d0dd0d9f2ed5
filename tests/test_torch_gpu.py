"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device (decided in
the ``cuda`` fixture, never at import).  On a machine with a card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.  This
file imports no JAX, so it runs where only PyTorch is installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import bitplane, kvcache, quant, residency
from repro_torch.kernels import (bsdp_gemm, bsdp_kernel, dequant_gemv, dim_kernel, gemv_int4,
                                 gemv_int8, ops, plane_attn, ref)
from repro_torch.models import attention
from repro_torch.models import model as model_lib
from repro_torch.serve import engine

from _torch_inputs import attention_inputs, t, words


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
class TestKernelsOnTheCard:
    def test_bsdp_kernels_bit_exact(self, cuda):
        rng = np.random.default_rng(40)
        for m in (1, 4, 37):
            x, w = t(words(rng, (m, 4, 9))).to(cuda), t(words(rng, (70, 4, 9))).to(cuda)
            for kernel in ("gemv", "gemm_fused", "gemm"):
                got = ops.bsdp_matmul_planes(x, w, kernel=kernel)
                assert torch.equal(got, ref.bsdp_gemm_ref(x, w))

    def test_dequant_and_attention_close(self, cuda):
        rng = np.random.default_rng(41)
        x = torch.from_numpy(rng.normal(size=(5, 300)).astype(np.float32)).to(cuda)
        w = torch.from_numpy(rng.integers(-127, 128, (300, 66)).astype(np.int8)).to(cuda)
        s = torch.rand((1, 66), device=cuda) * 0.02
        torch.testing.assert_close(ops.weight_only_matmul(x, w, s),
                                   ref.dequant_matmul_ref(x, w, s), rtol=1e-5, atol=1e-5)
        a = attention_inputs()
        args = [a["q_planes"], a["q_scale"], t(a["kp"]), torch.from_numpy(a["ks"]),
                t(a["vp"]), torch.from_numpy(a["vs"]), torch.from_numpy(a["bias"])]
        want = ops.plane_decode_attention(*args, sm_scale=a["sm"], feat=a["feat"])
        got = ops.plane_decode_attention(*[x.to(cuda) for x in args], sm_scale=a["sm"],
                                         feat=a["feat"])
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)

    def test_int8_and_int4_kernels_match_their_plain_versions_bit_exact(self, cuda):
        rng = np.random.default_rng(42)
        for m, k, n in ((1, 200, 33), (4, 256, 1024), (37, 130, 70)):
            x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(cuda)
            w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda)
            w4 = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8))
            w4[:4, 0] = torch.tensor([-8, 7, 7, -8], dtype=torch.int8)
            wp = quant.pack_int4(w4).to(cuda)
            xs = torch.rand((m, 1), device=cuda) * 0.05 + 1e-3
            ws = torch.rand((1, n), device=cuda) * 0.05 + 1e-3
            for out_int32 in (False, True):
                assert torch.equal(
                    gemv_int8.matmul_int8(x, w, xs, ws, out_int32=out_int32),
                    gemv_int8.matmul_int8_plain(x, w, xs, ws, out_int32=out_int32))
            assert torch.equal(gemv_int4.matmul_int4_packed(x, wp, xs, ws),
                               gemv_int4.matmul_int4_packed_plain(x, wp, xs, ws))
            assert torch.equal(ops.matmul_int8_raw(x, w), ref.matmul_int8_ref(x, w))

    def test_dim_kernel_bit_exact_with_edges_and_wrap(self, cuda):
        rng = np.random.default_rng(43)
        for m, k, n in ((1, 128, 40), (4, 2048, 256), (37, 200, 33)):
            x = rng.integers(-128, 128, (m, k)).astype(np.int8)
            x[0] = 127  # with the 32767 column the true sums leave int32
            w = rng.integers(-32768, 32768, (k, n)).astype(np.int16)
            w[:, 0] = 32767
            w[1, 1], w[2, 2] = -32768, -1
            xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
            got = ops.dim_matmul(xt, wt)
            assert torch.equal(got, dim_kernel.matmul_w16a8_plain(xt, wt))
            assert torch.equal(got, ref.dim_w16a8_ref(xt, wt))

    def test_unrolled_gemm_bit_identical_to_fused(self, cuda):
        rng = np.random.default_rng(44)
        x, w = t(words(rng, (20, 4, 64))).to(cuda), t(words(rng, (96, 4, 64))).to(cuda)
        for signed in (True, False):
            got = bsdp_gemm.bsdp_gemm(x, w, signed=signed)
            assert torch.equal(got, bsdp_gemm.bsdp_gemm_fused(x, w, signed=signed))
            assert torch.equal(got, bsdp_gemm.bsdp_gemm_plain(x, w, signed=signed))


#: DEQUANT_RTOL and ATTN_TOL of chip_smoke.py: float32 sums in another order
DEQUANT_RTOL = 2e-5
ATTN_TOL = 1e-4


def _split_rule(l):
    """The attention kernel's L split: up to 8 blocks of ~64 slots."""
    splits = min(8, -(-l // 64))
    return splits, -(-l // splits)


def _attention_case(rng, cuda, b, h, g, l, feat=128):
    """Row 0 idle (every slot masked); row 1 live with its second L split
    wholly masked (when L has one); row 2 half filled.  The bias is the
    engine's expanded view: stride 0 over heads and queries."""
    fw = -(-feat // 32)
    kp, vp = t(words(rng, (b, l, h, 4, fw))), t(words(rng, (b, l, h, 4, fw)))
    ks = torch.from_numpy((rng.random((b, l, h)) * 0.5 + 0.01).astype(np.float32))
    vs = torch.from_numpy((rng.random((b, l, h)) * 0.5 + 0.01).astype(np.float32))
    valid = np.ones((b, l), dtype=bool)
    valid[0] = False
    splits, chunk = _split_rule(l)
    if splits > 1:
        valid[1, chunk:2 * chunk] = False
    valid[2, (l + 1) // 2:] = False
    bias = torch.from_numpy(np.where(valid, 0.0, -1e30).astype(np.float32)).to(cuda)
    bias = bias[:, None, None, :].expand(b, h, g, l)
    q = torch.from_numpy(rng.normal(size=(b, h, g, feat)).astype(np.float32))
    q_planes, q_scale = kvcache.FusedBitPlaneCacheFormat._query_planes(q)
    args = [x.to(cuda) for x in (q_planes, q_scale, kp, ks, vp, vs)] + [bias]
    return args, 1.0 / np.sqrt(feat)


@pytest.mark.gpu
class TestRedesignedKernelsOnTheCard:
    @pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
    def test_dequant_both_routes_and_ragged_edges(self, cuda, x_dtype):
        """Decode route (M <= 16) and prefill route (M > 16); N off the
        64-column tile and the 16-byte load, K off the 256-row split."""
        rng = np.random.default_rng(45)
        for k, n in ((300, 66), (2050, 1000), (2048, 2048)):
            w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(cuda)
            s = torch.rand((1, n), device=cuda) * 0.02 + 1e-3
            for m in (1, 4, 16, 17, 37, 256):
                x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
                x = x.to(cuda, x_dtype)
                got = dequant_gemv.dequant_matmul(x, w, s)
                want = dequant_gemv.dequant_matmul_plain(x, w, s)
                err = (got - want).abs().max().item()
                assert err <= DEQUANT_RTOL * want.abs().max().item(), (m, k, n, err)
                assert torch.equal(got, dequant_gemv.dequant_matmul(x, w, s)), (m, k, n)

    def test_dequant_rejects_other_activation_types(self, cuda):
        w = torch.zeros((64, 32), dtype=torch.int8, device=cuda)
        with pytest.raises(TypeError):
            dequant_gemv.dequant_matmul(torch.zeros((2, 64), dtype=torch.float16,
                                                    device=cuda), w, torch.ones(32, device=cuda))

    @pytest.mark.parametrize("g", [1, 2, 8])
    def test_attention_splits_masks_and_strided_bias(self, cuda, g):
        rng = np.random.default_rng(46 + g)
        for l in (1, 63, 64, 65, 512, 700):
            args, sm = _attention_case(rng, cuda, 3, 2, g, l)
            assert args[-1].stride(1) == 0 and (g == 1 or args[-1].stride(2) == 0)
            got = plane_attn.plane_decode_attention(*args, sm_scale=sm)
            want = plane_attn.plane_decode_attention_plain(*args, sm_scale=sm)
            assert torch.isfinite(got).all(), l
            torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
            # the idle row: uniform weights, the mean of v_scale · v_int4
            vals = bitplane.decode(args[4][0].permute(1, 0, 2, 3)).to(torch.float32)
            idle = (vals * args[5][0].T[:, :, None]).mean(dim=1)  # [H, F]
            torch.testing.assert_close(got[0], idle[:, None, :].expand_as(got[0]),
                                       rtol=ATTN_TOL, atol=ATTN_TOL)
            assert torch.equal(got, plane_attn.plane_decode_attention(*args, sm_scale=sm))

    @pytest.mark.parametrize("signed", [True, False])
    @pytest.mark.parametrize("m", [2, 4, 5, 16, 17, 256])
    def test_bsdp_gemm_row_tiles_and_ragged_edges(self, cuda, m, signed):
        """One 4-token tile (M <= 4) and 16-token blocks on the grid's second
        axis, the last one partial (M = 5, 17); N off the 8-column warp tile,
        Kw off the 4-word load and the 16-word unit."""
        rng = np.random.default_rng(47 + m)
        for n in (8, 66, 1000, 2048):
            for kw in (1, 3, 64, 65, 192):
                x = t(words(rng, (m, 4, kw))).to(cuda)
                w = t(words(rng, (n, 4, kw))).to(cuda)
                got = bsdp_gemm.bsdp_gemm(x, w, signed=signed)
                assert torch.equal(got, bsdp_gemm.bsdp_gemm_plain(x, w, signed=signed)), (n, kw)
                assert torch.equal(got, bsdp_gemm.bsdp_gemm_fused(x, w, signed=signed)), (n, kw)
                assert torch.equal(got, bsdp_gemm.bsdp_gemm(x, w, signed=signed)), (n, kw)

    @pytest.mark.parametrize("m", [1, 4, 16, 17, 256])
    def test_matmul_int8_both_routes_extremes_and_unaligned_x(self, cuda, m):
        """Decode route (M <= 16: cluster split-K, __dp4a) and prefill route;
        N off the 16-byte load, K off the 4-row quad; random operands, all
        -128, and an activation starting 1 byte past a 16-byte boundary."""
        rng = np.random.default_rng(48 + m)
        for n in (33, 1000, 2048):
            for k in (200, 2050, 6144):
                w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda)
                x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(cuda)
                buf = torch.empty(m * k + 16, dtype=torch.int8, device=cuda)
                x_off = buf[1:1 + m * k].view(m, k)
                x_off.copy_(x)
                assert x_off.data_ptr() % 16 == 1
                xs = torch.rand((m, 1), device=cuda) * 0.05 + 1e-3
                ws = torch.rand((1, n), device=cuda) * 0.05 + 1e-3
                cases = ((x, w), (torch.full_like(x, -128), torch.full_like(w, -128)),
                         (x_off, w))
                for xi, wi in cases:
                    for out_int32 in (False, True):
                        got = gemv_int8.matmul_int8(xi, wi, xs, ws, out_int32=out_int32)
                        want = gemv_int8.matmul_int8_plain(xi, wi, xs, ws, out_int32=out_int32)
                        assert torch.equal(got, want), (n, k, out_int32)
                        assert torch.equal(got, gemv_int8.matmul_int8(xi, wi, xs, ws,
                                                                      out_int32=out_int32))
                    assert torch.equal(gemv_int8.matmul_int8(xi, wi, xs, ws, out_int32=True),
                                       ref.matmul_int8_ref(xi, wi)), (n, k)

    @pytest.mark.parametrize("signed", [True, False])
    @pytest.mark.parametrize("m", [1, 2, 4, 5, 16, 17, 256])
    def test_bsdp_gemm_fused_row_tiles_ragged_edges_and_unaligned_w(self, cuda, m, signed):
        """The plane-interleaved binary contraction: one 4-token tile (M <= 4)
        and 16-token blocks, the last one partial (M = 5, 17); N off the
        2-column fragment and the 8-column warp tile, Kw off the 4-word load
        and the 16-word unit; the weight also starting 4 bytes past a 16-byte
        boundary (a sliced tensor).  Bit-identical to both plain versions and
        to bsdp_gemm, and across two calls."""
        rng = np.random.default_rng(60 + m)
        for n in (3, 66, 1001, 2048):
            for kw in (1, 3, 64, 65, 192):
                x = t(words(rng, (m, 4, kw))).to(cuda)
                w = t(words(rng, (n, 4, kw))).to(cuda)
                buf = torch.empty(n * 4 * kw + 4, dtype=torch.int32, device=cuda)
                w_off = buf[1:1 + n * 4 * kw].view(n, 4, kw)
                w_off.copy_(w)
                assert w_off.data_ptr() % 16 == 4
                want = bsdp_gemm.bsdp_gemm_plain(x, w, signed=signed)
                for wi in (w, w_off):
                    got = bsdp_gemm.bsdp_gemm_fused(x, wi, signed=signed)
                    assert torch.equal(got, want), (n, kw)
                    assert torch.equal(got, bsdp_gemm.bsdp_gemm_fused_plain(x, wi, signed=signed))
                    assert torch.equal(got, bsdp_gemm.bsdp_gemm(x, wi, signed=signed)), (n, kw)
                    assert torch.equal(got, bsdp_gemm.bsdp_gemm_fused(x, wi, signed=signed))

    @pytest.mark.parametrize("m", [1, 2, 4, 5, 16, 17])
    def test_matmul_int4_packed_decode_route_extremes_and_unaligned_x(self, cuda, m):
        """The decode route (M <= 16: cluster split-K, nibbles unpacked in
        registers, __dp4a): N off the 16-byte load, K even but off the 8-row
        unit (and off the 4-row word at K % 4 == 2); nibbles -8 and 7 planted
        beside activations -128 and 127 at both ends of K, then all-extreme
        operands, and an activation starting 1 byte past a 16-byte boundary.
        Bit-exact to the plain version, and across two calls."""
        rng = np.random.default_rng(70 + m)
        for n in (33, 1000, 2048):
            for k in (6, 204, 2050, 6148):
                w4 = rng.integers(-8, 8, (k, n)).astype(np.int8)
                x = rng.integers(-128, 128, (m, k)).astype(np.int8)
                for rows in (slice(0, 6), slice(k - 6, k)):
                    w4[rows, :2] = np.array([-8, 7, 7, -8, -8, 7], np.int8)[:, None]
                    x[:, rows] = np.array([-128, 127, -128, 127, 127, -128], np.int8)
                xt = torch.from_numpy(x).to(cuda)
                buf = torch.empty(m * k + 16, dtype=torch.int8, device=cuda)
                x_off = buf[1:1 + m * k].view(m, k)
                x_off.copy_(xt)
                assert x_off.data_ptr() % 16 == 1
                xs = torch.rand((m, 1), device=cuda) * 0.05 + 1e-3
                ws = torch.rand((1, n), device=cuda) * 0.05 + 1e-3
                cases = ((xt, torch.from_numpy(w4)), (x_off, torch.from_numpy(w4)),
                         (torch.full_like(xt, -128), torch.full((k, n), -8, dtype=torch.int8)),
                         (torch.full_like(xt, 127), torch.full((k, n), -8, dtype=torch.int8)))
                for xi, wi in cases:
                    wp = quant.pack_int4(wi).to(cuda)
                    got = gemv_int4.matmul_int4_packed(xi, wp, xs, ws)
                    want = gemv_int4.matmul_int4_packed_plain(xi, wp, xs, ws)
                    assert torch.equal(got, want), (n, k)
                    assert torch.equal(got, gemv_int4.matmul_int4_packed(xi, wp, xs, ws)), (n, k)


@pytest.mark.gpu
class TestSixthSliceOnTheCard:
    @pytest.mark.parametrize("signed", [True, False])
    @pytest.mark.parametrize("m", [1, 2, 4, 5, 17, 256])
    def test_bsdp_gemv_rows_ragged_edges_and_unaligned_w(self, cuda, m, signed):
        """M from one row to a prefill's 256, one block per row of x;
        N off the 16-column block (3, 66) and N = 2048, K walked in 64-word
        passes (3 at Kw = 192, the w_out shape, 4 at 193); Kw off the 4-word
        slice (1, 3, 193); the weight also
        one word past a 16-byte boundary (word loads).  Bit-identical to the
        plain version and to the decoded integer product, and across two
        calls."""
        rng = np.random.default_rng(80 + m)
        for n in (3, 66, 2048):
            for kw in (1, 3, 64, 192, 193):
                x = t(words(rng, (m, 4, kw))).to(cuda)
                w = t(words(rng, (n, 4, kw))).to(cuda)
                buf = torch.empty(n * 4 * kw + 4, dtype=torch.int32, device=cuda)
                w_off = buf[1:1 + n * 4 * kw].view(n, 4, kw)
                w_off.copy_(w)
                assert w_off.data_ptr() % 16 == 4
                want = bsdp_kernel.bsdp_matmul_plain(x, w, signed=signed)
                assert torch.equal(want, ref.bsdp_gemm_ref(x, w, signed=signed)), (n, kw)
                for wi in (w, w_off):
                    got = bsdp_kernel.bsdp_matmul(x, wi, signed=signed)
                    assert torch.equal(got, want), (n, kw)
                    assert torch.equal(got, bsdp_kernel.bsdp_matmul(x, wi, signed=signed))

    @pytest.mark.parametrize("m", [1, 2, 4, 5, 16, 17])
    def test_matmul_w16a8_decode_route_extremes_wrap_and_unaligned_x(self, cuda, m):
        """The decode route (M <= 16: the weight read as its bytes, cluster
        split-K, mixed-sign __dp4a on the low bytes) and, at M = 17, the
        prefill tiles: full-range int16 with -32768, 32767 and -1 planted, a
        row of 127s against a column of 32767s (the true sum leaves int32),
        odd N, x starting 1 byte past a 16-byte boundary; at K = 70,000 the
        low-byte sums alone leave int32.  Bit-exact to the plain version and
        the wide oracle, and across two calls."""
        rng = np.random.default_rng(90 + m)
        for k, n in ((5, 1), (2048, 33), (2048, 2048), (2050, 1001), (70_000, 24)):
            x = rng.integers(-128, 128, (m, k)).astype(np.int8)
            x[0] = 127
            w = rng.integers(-32768, 32768, (k, n)).astype(np.int16)
            w[:, 0] = 32767
            w[0, -1], w[1 % k, -1], w[2 % k, -1] = -32768, 32767, -1
            xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
            buf = torch.empty(m * k + 16, dtype=torch.int8, device=cuda)
            x_off = buf[1:1 + m * k].view(m, k)
            x_off.copy_(xt)
            assert x_off.data_ptr() % 16 == 1
            want = ref.dim_w16a8_ref(xt, wt)
            assert torch.equal(want, dim_kernel.matmul_w16a8_plain(xt, wt)), (k, n)
            for xi in (xt, x_off):
                got = dim_kernel.matmul_w16a8(xi, wt)
                assert torch.equal(got, want), (k, n)
                assert torch.equal(got, dim_kernel.matmul_w16a8(xi, wt)), (k, n)

    @pytest.mark.parametrize("cache_format", ["bf16", "int8", "int4_bp", "int4_bp_fused"])
    def test_ring_write_longer_than_the_ring_matches_the_cpu(self, cuda, cache_format):
        """Row 0 writes 3 × L positions into L slots, row 1 a few pads and
        then 2 × L: the card keeps the newest token per slot, as the CPU
        does, and two writes are identical."""
        cfg = dataclasses.replace(
            get_smoke_config("qwen3-1.7b").scaled(n_layers=1, dtype=torch.float32),
            cache_format=cache_format)
        fmt = kvcache.format_for(cfg)
        ln, s = 8, 24
        rng = np.random.default_rng(95)
        k, v = (torch.from_numpy(rng.normal(size=(2, s, cfg.n_kv_heads, cfg.d_head))
                                 .astype(np.float32)) for _ in range(2))
        positions = torch.from_numpy(np.stack([np.arange(s), np.arange(-8, s - 8)])
                                     .astype(np.int32))
        caches = []
        for dev in ("cpu", cuda, cuda):
            cache = attention.init_kv_cache(cfg, 2, ln, dtype=torch.float32, device=dev)
            attention._ring_write(cache, k.to(dev), v.to(dev), positions.to(dev), fmt)
            caches.append({name: x.cpu() for name, x in cache.items()})
        assert caches[0]["pos_ids"].tolist() == [list(range(16, 24)), list(range(8, 16))]
        for got in caches[1:]:
            for name, want in caches[0].items():
                assert torch.equal(got[name], want), name


def _chunk_attention_case(rng, cuda, g, l, h=2, feat=128):
    """A chunk step's plane attention: S = G / 2 tokens a slot, the bias as
    the engine builds it ([B, S, L] per-token causal masks, expanded over
    the kv heads and groups and materialised [B, Hkv, G, L]).  Slot 0 idle
    (all pads: uniform rows), slot 1 a chunk at positions 5..4+S over a
    ring holding 0..4+S (the last L of them when S + 5 > L), slot 2 a decode
    row (one live token at the last column, the rest pads)."""
    s = g // 2
    fw = -(-feat // 32)
    kp, vp = t(words(rng, (3, l, h, 4, fw))), t(words(rng, (3, l, h, 4, fw)))
    ks = torch.from_numpy((rng.random((3, l, h)) * 0.5 + 0.01).astype(np.float32))
    vs = torch.from_numpy((rng.random((3, l, h)) * 0.5 + 0.01).astype(np.float32))
    pos_ids = np.full((3, l), -1)
    cur = np.full((3, s), -1)
    written = np.arange(max(0, s + 5 - l), s + 5)
    pos_ids[1, written % l] = written
    cur[1] = np.arange(5, 5 + s)
    pos_ids[2, : l // 2] = np.arange(l // 2)
    cur[2, -1] = l // 2 - 1
    valid = (pos_ids[:, None, :] >= 0) & (pos_ids[:, None, :] <= cur[..., None])
    bias = torch.from_numpy(np.where(valid, 0.0, -1e30).astype(np.float32)).to(cuda)
    bias = bias[:, None, :, None, :].expand(3, h, s, 2, l).reshape(3, h, g, l)
    q = torch.from_numpy(rng.normal(size=(3, h, g, feat)).astype(np.float32))
    q_planes, q_scale = kvcache.FusedBitPlaneCacheFormat._query_planes(q)
    args = [x.to(cuda) for x in (q_planes, q_scale, kp, ks, vp, vs)] + [bias]
    return args, 1.0 / np.sqrt(feat)


@pytest.mark.gpu
class TestSeventhSliceOnTheCard:
    @pytest.mark.parametrize("l", [32, 512])
    @pytest.mark.parametrize("g", [2, 34, 64, 512, 1024])
    def test_plane_attention_takes_any_chunk(self, cuda, g, l):
        """G from the decode shape to a 512-token chunk (the largest a
        max_len 512 engine plans), one launch; G = 34 ends in a partial
        tile of 16 query rows.  Within ATTN_TOL of the plain version, the
        idle slot's rows uniform, two calls bitwise equal, and each tile's
        first query rows bit-identical to a G = 2 launch of them alone (one
        tile)."""
        rng = np.random.default_rng(100 + g + l)
        args, sm = _chunk_attention_case(rng, cuda, g, l)
        got = plane_attn.plane_decode_attention(*args, sm_scale=sm)
        want = plane_attn.plane_decode_attention_plain(*args, sm_scale=sm)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        vals = bitplane.decode(args[4][0].permute(1, 0, 2, 3)).to(torch.float32)
        idle = (vals * args[5][0].T[:, :, None]).mean(dim=1)  # [H, F]
        torch.testing.assert_close(got[0], idle[:, None, :].expand_as(got[0]),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)
        assert torch.equal(got, plane_attn.plane_decode_attention(*args, sm_scale=sm))
        q_planes, q_scale, *cache, bias = args
        for g0 in range(0, g, 16):
            part = plane_attn.plane_decode_attention(
                q_planes[:, :, g0:g0 + 2], q_scale[:, :, g0:g0 + 2], *cache,
                bias[:, :, g0:g0 + 2], sm_scale=sm)
            assert torch.equal(got[:, :, g0:g0 + 2], part), g0

    @pytest.mark.parametrize("stack", [("ffn=bsdp_fused,mixer=w8a16", "int4_bp_fused"),
                                       ("w8a8", "int8")], ids=lambda c: f"{c[0]}+{c[1]}")
    def test_token_budget_serve_matches_the_cpu(self, cuda, stack):
        """A 2-layer float32 serve under token_budget:budget=4 (prompts of
        5, 3 and 7 tokens in chunks, greedy) on the card: the CPU port's
        schedule and tokens, logits within 1e-4 of the largest (the
        kernels sum in their own order), and the kernels launched."""
        mode, cache = stack
        cfg = get_smoke_config("qwen3-1.7b").scaled(n_layers=2, dtype=torch.float32)
        params = model_lib.materialize(cfg, seed=3, device="cpu")
        runs = []
        for dev in ("cpu", cuda):
            ops.reset_counts()
            eng = engine.ServeEngine(params, cfg, slots=2, max_len=32, mode=mode,
                                     cache_format=cache, scheduler="token_budget:budget=4",
                                     min_dim=16, trace_logits=True, device=dev)
            rng = np.random.default_rng(0)
            for n, mn in zip((5, 3, 7), (6, 2, 4)):
                eng.submit(rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32), mn)
            eng.run()
            runs.append((eng, {k: v for k, v in ops.launch_counts().items() if v}))
        (cpu, cpu_launches), (card, launches) = runs
        assert cpu_launches == {}
        assert launches.get("matmul_int8" if mode == "w8a8" else "plane_decode_attention")
        assert [(k, sl) for k, sl, _ in card.logit_trace] == \
            [(k, sl) for k, sl, _ in cpu.logit_trace]
        assert [r.out for r in card.requests] == [r.out for r in cpu.requests]
        for (_, _, a), (_, _, b) in zip(cpu.logit_trace, card.logit_trace):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()
        assert all(v == 0 for v in ops.plain_cuda_counts().values())


@pytest.mark.gpu
class TestEighthSliceOnTheCard:
    """The kernels at the decode shapes of qwen1.5-32b and starcoder2-3b, and
    the streamed materialization on the card."""

    @pytest.mark.parametrize("h, g", [(40, 1), (2, 12)])
    def test_plane_attention_at_the_configs_group_sizes(self, cuda, h, g):
        """G = 1 (qwen1.5-32b: one query row in a 16-row tile, R = 160 at
        slots=4) and G = 12 (starcoder2-3b: R = 8), L = 512, F = 128: within
        ATTN_TOL of the plain version, two calls bitwise equal."""
        a = attention_inputs(seed=200 + g, b=4, h=h, g=g, l=512, feat=128)
        args = [a["q_planes"], a["q_scale"], t(a["kp"]), torch.from_numpy(a["ks"]),
                t(a["vp"]), torch.from_numpy(a["vs"]), torch.from_numpy(a["bias"])]
        args = [x.to(cuda) for x in args]
        got = plane_attn.plane_decode_attention(*args, sm_scale=a["sm"])
        want = plane_attn.plane_decode_attention_plain(*args, sm_scale=a["sm"])
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        assert torch.equal(got, plane_attn.plane_decode_attention(*args, sm_scale=a["sm"]))

    @pytest.mark.parametrize("n", [5120, 200])
    @pytest.mark.parametrize("m", [1, 4, 17, 256])
    def test_bsdp_kernels_at_qwen_w_out_depth(self, cuda, m, n):
        """K = 27392 (qwen1.5-32b's w_out): 856 plane words, 107 binary
        256-wide K steps, an odd count; both BSDP kernels bit-exact at the
        decode rows and at prefill's (17, the first past the decode tile,
        and 256)."""
        rng = np.random.default_rng(210 + m)
        x, w = t(words(rng, (m, 4, 856))).to(cuda), t(words(rng, (n, 4, 856))).to(cuda)
        want = ref.bsdp_gemm_ref(x, w)
        assert torch.equal(bsdp_kernel.bsdp_matmul(x, w), want)
        assert torch.equal(bsdp_gemm.bsdp_gemm_fused(x, w), want)

    @pytest.mark.parametrize("k, n", [(5120, 54784), (27392, 5120)])
    @pytest.mark.parametrize("m", [17, 256])
    def test_tile_routes_at_qwen_ffn(self, cuda, m, k, n):
        """The prefill (M > 16) routes of ``matmul_int8`` and
        ``dequant_matmul`` at qwen1.5-32b's w_in and w_out: the int8 sums
        bit-exact, the float32 sums within DEQUANT_RTOL of the largest
        output (another summation order)."""
        gen = torch.Generator(device=cuda).manual_seed(230 + m)
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen, device=cuda)
        ws = torch.rand((1, n), generator=gen, device=cuda) * 0.02 + 1e-3
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, generator=gen, device=cuda)
        xs = torch.rand((m, 1), generator=gen, device=cuda) * 0.05 + 1e-3
        assert torch.equal(gemv_int8.matmul_int8(x, w, xs, ws),
                           gemv_int8.matmul_int8_plain(x, w, xs, ws))
        xf = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
        got = dequant_gemv.dequant_matmul(xf, w, ws)
        want = dequant_gemv.dequant_matmul_plain(xf, w, ws)
        assert (got - want).abs().max() <= DEQUANT_RTOL * want.abs().max()

    @pytest.mark.parametrize("k, n", [(5120, 152064), (3072, 49152)])
    def test_matmul_int8_at_the_untied_heads(self, cuda, k, n):
        """The heads under w8a8: 778.6 M int8 weights at qwen1.5-32b's, K·N
        near 2^30; scaled and int32 outputs bit-exact at M = 1 and 4."""
        gen = torch.Generator(device=cuda).manual_seed(220)
        w = torch.randint(-128, 128, (k, n), dtype=torch.int8, generator=gen, device=cuda)
        ws = torch.rand((1, n), generator=gen, device=cuda) * 0.05 + 1e-3
        for m in (1, 4):
            x = torch.randint(-128, 128, (m, k), dtype=torch.int8, generator=gen, device=cuda)
            xs = torch.rand((m, 1), generator=gen, device=cuda) * 0.05 + 1e-3
            for out_int32 in (False, True):
                assert torch.equal(
                    gemv_int8.matmul_int8(x, w, xs, ws, out_int32=out_int32),
                    gemv_int8.matmul_int8_plain(x, w, xs, ws, out_int32=out_int32)), m

    @pytest.mark.parametrize("mode", ["ffn=bsdp_fused,mixer=w8a16", "w8a8"])
    def test_streamed_materialization_on_the_card(self, cuda, mode):
        """A 2-layer, full-width cut of qwen1.5-32b: ``materialize_converted``
        equals ``convert_params(materialize(...))`` leaf for leaf, bit for
        bit, on the card."""
        from repro_torch.configs import get_config

        cfg = get_config("qwen1.5-32b").scaled(n_layers=2)
        want = engine.convert_params(model_lib.materialize(cfg, seed=5, device=cuda), cfg, mode)
        got = engine.materialize_converted(cfg, mode, seed=5, device=cuda)

        def leaves(tree):
            if isinstance(tree, dict):
                return [x for v in tree.values() for x in leaves(v)]
            if isinstance(tree, list):
                return [x for v in tree for x in leaves(v)]
            if isinstance(tree, residency.QuantLinearState):
                return [tree.mode, tree.data, tree.scale]
            return [tree]

        pairs = list(zip(leaves(got), leaves(want), strict=True))
        assert all(a == b if isinstance(a, str) else torch.equal(a, b) for a, b in pairs)
        head = got["embed"]["head"]
        assert (head.mode == "w8a8") if mode == "w8a8" else head.dtype == torch.bfloat16


@pytest.mark.gpu
class TestNinthSliceOnTheCard:
    """The grouped (expert) launches and the MLA / MoE serves on the card."""

    @pytest.mark.parametrize("m", [1, 4, 5, 37])
    @pytest.mark.parametrize("kernel", ["gemv", "gemm", "gemm_fused"])
    def test_grouped_bsdp_launches_bit_exact(self, cuda, kernel, m):
        """Each BSDP kernel's grouped launch (3 groups, ragged N and Kw, and
        Kw not a multiple of 4: the word loads) equals its plain version
        group by group, and is one launch."""
        fn = ops._BSDP_GROUPED[kernel]
        rng = np.random.default_rng(300 + m)
        for n, kw in ((70, 9), (40, 16)):
            x = t(words(rng, (3, m, 4, kw))).to(cuda)
            w = t(words(rng, (3, n, 4, kw))).to(cuda)
            ops.reset_counts()
            got = fn(x, w)
            assert sum(ops.launch_counts().values()) == 1
            want = torch.stack([ref.bsdp_gemm_ref(a, b) for a, b in zip(x, w)])
            assert torch.equal(got, want), (n, kw)

    @pytest.mark.parametrize("m", [1, 4, 16, 37])
    def test_grouped_matmul_int8_both_routes(self, cuda, m):
        """The grouped W8A8 launch on the decode route (M <= 16) and the tile
        route: each group bit-exact against ``matmul_int8_plain`` with its
        own scales; N = 40 takes the unaligned loads."""
        gen = torch.Generator(device=cuda).manual_seed(310 + m)
        for k, n in ((256, 1024), (130, 40)):
            x = torch.randint(-128, 128, (5, m, k), dtype=torch.int8, generator=gen, device=cuda)
            w = torch.randint(-128, 128, (5, k, n), dtype=torch.int8, generator=gen, device=cuda)
            xs = torch.rand((5, m, 1), generator=gen, device=cuda) * 0.05 + 1e-3
            ws = torch.rand((5, 1, n), generator=gen, device=cuda) * 0.05 + 1e-3
            ops.reset_counts()
            got = gemv_int8.matmul_int8_grouped(x, w, xs, ws)
            assert ops.launch_counts()["matmul_int8"] == 1
            assert torch.equal(got, gemv_int8.matmul_int8_grouped_plain(x, w, xs, ws)), (k, n)

    @pytest.mark.parametrize("mode", ["w8a8", "bsdp_fused", "bsdp", "w4a4_bsdp", "w8a16",
                                      "w4a8"])
    def test_stacked_apply_matches_the_cpu(self, cuda, mode):
        """A stacked state's kernel path on the card equals the CPU's (the
        grouped plain versions), bit for bit for the integer formats."""
        rng = np.random.default_rng(320)
        w = torch.from_numpy(rng.normal(size=(6, 96, 80)).astype(np.float32))
        x = torch.from_numpy(rng.normal(size=(6, 4, 96)).astype(np.float32))
        state = residency.from_float(w, mode)
        want = residency.apply_stacked(state, x)
        got = residency.apply_stacked(state.to(cuda), x.to(cuda)).cpu()
        if mode == "w8a16":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(got, want)

    @pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-lite-16b"])
    def test_mla_moe_serve_kernel_path_equals_plain_path(self, cuda, arch):
        """The smoke config on path B's stack, where every kernel is exact,
        under ``token_budget``: on the card the kernel path's logits equal
        the plain path's to the bit (the same float operations around
        exact integer kernels), two kernel-path serves agree to the bit,
        and the grouped ``matmul_int8`` launched."""
        cfg = get_smoke_config(arch).scaled(dtype=torch.float32)
        params = model_lib.materialize(cfg, seed=1, device=cuda)

        def serve(impl):
            eng = engine.ServeEngine(params, cfg, slots=2, max_len=32, mode="w8a8",
                                     min_dim=16, scheduler="token_budget:budget=3",
                                     trace_logits=True, impl=impl, device=cuda)
            rng = np.random.default_rng(0)
            for n in (5, 3, 7):
                eng.submit(rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32), 4)
            eng.run()
            return [lg for _, _, lg in eng.logit_trace]

        ops.reset_counts()
        card, again = serve(None), serve(None)
        assert ops.launch_counts()["matmul_int8"] > 0
        assert all(v == 0 for v in ops.plain_cuda_counts().values())
        plain = serve("plain")
        assert all(np.array_equal(a, b) for a, b in zip(card, again))
        assert all(np.array_equal(a, b) for a, b in zip(card, plain))


@pytest.mark.gpu
class TestTenthSliceOnTheCard:
    """The kernels at the new shapes of mixtral-8x7b and falcon-mamba-7b, and
    the two configs' smoke serves on the card."""

    @pytest.mark.parametrize("window", [None, 1000])
    def test_plane_attention_at_a_4096_ring_with_a_window(self, cuda, window):
        """mixtral-8x7b's decode shape, R = 32 (4 slots × 8 kv heads), G = 4,
        L = 4096, F = 128, the window cutting into the ring: within ATTN_TOL
        of the plain version, two calls bitwise equal."""
        a = attention_inputs(seed=400, b=4, h=8, g=4, l=4096, feat=128, window=window)
        args = [a["q_planes"], a["q_scale"], t(a["kp"]), torch.from_numpy(a["ks"]),
                t(a["vp"]), torch.from_numpy(a["vs"]), torch.from_numpy(a["bias"])]
        args = [x.to(cuda) for x in args]
        got = plane_attn.plane_decode_attention(*args, sm_scale=a["sm"])
        want = plane_attn.plane_decode_attention_plain(*args, sm_scale=a["sm"])
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        assert torch.equal(got, plane_attn.plane_decode_attention(*args, sm_scale=a["sm"]))

    @pytest.mark.parametrize("k, n", [(4096, 28672), (14336, 4096)])
    def test_grouped_launches_at_eight_experts(self, cuda, k, n):
        """mixtral-8x7b's experts (E = 8, w_in 4096 × 28672, w_out 14336 ×
        4096): grouped ``bsdp_gemv`` (M = 1), ``bsdp_gemm_fused`` (M = 4 and
        a prefill's 40) and ``matmul_int8`` (M = 1, 4, 40) bit-exact against
        their plain versions, one launch each."""
        gen = torch.Generator(device=cuda).manual_seed(410)
        kw = k // 32
        w = torch.randint(-2**31, 2**31, (8, n, 4, kw), dtype=torch.int32, generator=gen,
                          device=cuda)
        for m, fns in ((1, ("gemv", "gemm_fused")), (4, ("gemm_fused",)),
                       (40, ("gemm_fused",))):
            x = torch.randint(-2**31, 2**31, (8, m, 4, kw), dtype=torch.int32, generator=gen,
                              device=cuda)
            want = bsdp_kernel.bsdp_matmul_grouped_plain(x, w)
            for kernel in fns:
                ops.reset_counts()
                assert torch.equal(ops._BSDP_GROUPED[kernel](x, w), want), (kernel, m)
                assert sum(ops.launch_counts().values()) == 1
        del w
        w = torch.randint(-128, 128, (8, k, n), dtype=torch.int8, generator=gen, device=cuda)
        ws = torch.rand((8, 1, n), generator=gen, device=cuda) * 0.05 + 1e-3
        for m in (1, 4, 40):
            x = torch.randint(-128, 128, (8, m, k), dtype=torch.int8, generator=gen, device=cuda)
            xs = torch.rand((8, m, 1), generator=gen, device=cuda) * 0.05 + 1e-3
            assert torch.equal(gemv_int8.matmul_int8_grouped(x, w, xs, ws),
                               gemv_int8.matmul_int8_grouped_plain(x, w, xs, ws)), m

    @pytest.mark.parametrize("m", [1, 4, 17, 64])
    def test_the_n288_projection(self, cuda, m):
        """falcon-mamba-7b's ``x_proj`` (K 8192, N 288: a 32-column tail past
        the 64- and 128-wide tiles): ``matmul_int8`` bit-exact, scaled and
        int32, and ``dequant_matmul`` (f32 and bf16 x) within DEQUANT_RTOL of
        the largest output, against their plain versions."""
        gen = torch.Generator(device=cuda).manual_seed(420 + m)
        k, n = 8192, 288
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen, device=cuda)
        ws = torch.rand((1, n), generator=gen, device=cuda) * 0.02 + 1e-3
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, generator=gen, device=cuda)
        xs = torch.rand((m, 1), generator=gen, device=cuda) * 0.05 + 1e-3
        for out_int32 in (False, True):
            assert torch.equal(gemv_int8.matmul_int8(x, w, xs, ws, out_int32=out_int32),
                               gemv_int8.matmul_int8_plain(x, w, xs, ws, out_int32=out_int32))
        for dtype in (torch.float32, torch.bfloat16):
            xf = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
            got = dequant_gemv.dequant_matmul(xf, w, ws)
            want = dequant_gemv.dequant_matmul_plain(xf, w, ws)
            assert (got - want).abs().max() <= DEQUANT_RTOL * want.abs().max()

    @pytest.mark.parametrize("arch", ["mixtral-8x7b", "falcon-mamba-7b",
                                      "jamba-1.5-large-398b"])
    def test_window_and_mamba_serves_kernel_path_equals_plain_path(self, cuda, arch):
        """The smoke config on path B's stack (every kernel exact) under
        ``token_budget``, prompts longer than mixtral's 32-token window: on
        the card the kernel path's logits equal the plain path's to the bit,
        and ``matmul_int8`` launched with no plain version on the card."""
        cfg = get_smoke_config(arch).scaled(dtype=torch.float32)
        params = model_lib.materialize(cfg, seed=2, device=cuda)

        def serve(impl):
            eng = engine.ServeEngine(params, cfg, slots=2, max_len=64, mode="w8a8",
                                     min_dim=16, scheduler="token_budget:budget=8",
                                     trace_logits=True, impl=impl, device=cuda)
            rng = np.random.default_rng(0)
            for n in (40, 12, 45):
                eng.submit(rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32), 6)
            eng.run()
            return [lg for _, _, lg in eng.logit_trace]

        ops.reset_counts()
        card = serve(None)
        assert ops.launch_counts()["matmul_int8"] > 0
        assert all(v == 0 for v in ops.plain_cuda_counts().values())
        plain = serve("plain")
        assert all(np.array_equal(a, b) for a, b in zip(card, plain))


@pytest.mark.gpu
class TestEleventhSliceOnTheCard:
    """The kernels at the new shapes of llama-3.2-vision-11b and
    seamless-m4t-medium (the cross K/V and encoder prefills, the untied
    heads, plane attention at d_head 64) and one decode step's launches of
    both configs on path A's stack."""

    def test_cross_kv_and_encoder_prefill_shapes(self, cuda):
        """llama-vision's cross K/V projection over 4 slots' 1601 patches (K
        4096, N 1024, M = 6404): ``matmul_int8`` bit-exact and
        ``dequant_matmul`` (f32 and bf16 x) within DEQUANT_RTOL; seamless's
        encoder w_in over 4 × 1536 frames (K 1024, N 4096, M = 6144):
        ``bsdp_gemm_fused`` bit-exact against its plain version."""
        gen = torch.Generator(device=cuda).manual_seed(430)
        k, n, m = 4096, 1024, 4 * 1601
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen, device=cuda)
        ws = torch.rand((1, n), generator=gen, device=cuda) * 0.02 + 1e-3
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, generator=gen, device=cuda)
        xs = torch.rand((m, 1), generator=gen, device=cuda) * 0.05 + 1e-3
        assert torch.equal(gemv_int8.matmul_int8(x, w, xs, ws),
                           gemv_int8.matmul_int8_plain(x, w, xs, ws))
        for dtype in (torch.float32, torch.bfloat16):
            xf = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
            got = dequant_gemv.dequant_matmul(xf, w, ws)
            want = dequant_gemv.dequant_matmul_plain(xf, w, ws)
            assert (got - want).abs().max() <= DEQUANT_RTOL * want.abs().max(), dtype
        k, n, m = 1024, 4096, 4 * 1536
        wp = torch.randint(-2**31, 2**31, (n, 4, k // 32), dtype=torch.int32, generator=gen,
                           device=cuda)
        xp = torch.randint(-2**31, 2**31, (m, 4, k // 32), dtype=torch.int32, generator=gen,
                           device=cuda)
        assert torch.equal(bsdp_gemm.bsdp_gemm_fused(xp, wp),
                           bsdp_gemm.bsdp_gemm_fused_plain(xp, wp))

    @pytest.mark.parametrize("k, n", [(1024, 256206), (4096, 128256)])
    def test_matmul_int8_at_the_untied_heads(self, cuda, k, n):
        """seamless's head (N = 256206, no multiple of 16: the unaligned
        route) and llama-vision's at M = 1 and 4, bit-exact."""
        gen = torch.Generator(device=cuda).manual_seed(440)
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen, device=cuda)
        ws = torch.rand((1, n), generator=gen, device=cuda) * 0.02 + 1e-3
        for m in (1, 4):
            x = torch.randint(-128, 128, (m, k), dtype=torch.int8, generator=gen, device=cuda)
            xs = torch.rand((m, 1), generator=gen, device=cuda) * 0.05 + 1e-3
            assert torch.equal(gemv_int8.matmul_int8(x, w, xs, ws),
                               gemv_int8.matmul_int8_plain(x, w, xs, ws)), m

    def test_plane_attention_at_d_head_64(self, cuda):
        """seamless's decode shape: R = 64 (4 slots × 16 kv heads), G = 1, L
        = 512, F = 64 (Fw = 2): within ATTN_TOL of the plain version, two
        calls bitwise equal."""
        a = attention_inputs(seed=450, b=4, h=16, g=1, l=512, feat=64)
        args = [a["q_planes"], a["q_scale"], t(a["kp"]), torch.from_numpy(a["ks"]),
                t(a["vp"]), torch.from_numpy(a["vs"]), torch.from_numpy(a["bias"])]
        args = [x.to(cuda) for x in args]
        got = plane_attn.plane_decode_attention(*args, sm_scale=a["sm"])
        want = plane_attn.plane_decode_attention_plain(*args, sm_scale=a["sm"])
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        assert torch.equal(got, plane_attn.plane_decode_attention(*args, sm_scale=a["sm"]))

    @pytest.mark.parametrize("arch, depth, per_step", [
        ("llama-3.2-vision-11b", {"n_layers": 5},
         {"dequant_matmul": 18, "bsdp_gemm_fused": 10, "plane_decode_attention": 4}),
        ("seamless-m4t-medium", {"n_layers": 2, "n_enc_layers": 2},
         {"dequant_matmul": 8, "bsdp_gemm_fused": 4, "plane_decode_attention": 2}),
    ])
    def test_decode_step_launches_on_path_a(self, cuda, arch, depth, per_step):
        """Full width, depth cut (llama-vision's one period, cross layer 3;
        seamless 2 + 2): one decode step at slots=4 launches, per layer, 4
        W8A16 projections a self-attention and 2 a converted cross branch
        (llama-vision's; seamless's ``cross`` leaves stay bf16), 2 BSDP GEMMs
        and one plane attention a self-attention layer, with no plain
        version on the card and finite logits."""
        from repro_torch.configs import get_config

        cfg = get_config(arch).scaled(cache_format="int4_bp_fused", **depth)
        params = engine.materialize_converted(cfg, "ffn=bsdp_fused,mixer=w8a16", seed=4,
                                              device=cuda)
        for i, layer in enumerate(params["layers"]):
            if cfg.mixer_kind(i) != "attn":
                layer["mixer" if cfg.mixer_kind(i) == "cross" else "cross"]["gate"].fill_(0.5)
        gen = torch.Generator(device=cuda).manual_seed(5)
        key = "enc_embeds" if cfg.is_enc_dec else "ctx_embeds"
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 9), generator=gen, device=cuda),
                 key: torch.randn((4, cfg.encoder_tokens, cfg.d_model), generator=gen,
                                  device=cuda)}
        logits, caches = model_lib.prefill(params, batch, cfg, max_len=64)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        ops.reset_counts()
        logits, _ = model_lib.decode_step(params, tok, caches, 9, cfg)
        torch.cuda.synchronize()
        assert {k: v for k, v in ops.launch_counts().items() if v} == per_step
        assert all(v == 0 for v in ops.plain_cuda_counts().values())
        assert torch.isfinite(logits).all()

    @pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "seamless-m4t-medium"])
    def test_cross_prefill_decode_kernel_path_equals_plain_path(self, cuda, arch):
        """The smoke config on path B's stack (every kernel exact), gates
        open: on the card the kernel path's logits equal the plain path's to
        the bit through prefill and 4 decode steps."""
        cfg = get_smoke_config(arch).scaled(dtype=torch.float32)
        params = engine.convert_params(model_lib.materialize(cfg, seed=2, device=cuda), cfg,
                                       "w8a8", min_dim=16)
        for i, layer in enumerate(params["layers"]):
            if cfg.mixer_kind(i) != "attn":
                layer["mixer" if cfg.mixer_kind(i) == "cross" else "cross"]["gate"].fill_(0.5)
        gen = torch.Generator(device=cuda).manual_seed(6)
        key = "enc_embeds" if cfg.is_enc_dec else "ctx_embeds"
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 7), generator=gen, device=cuda),
                 "positions": torch.tensor([list(range(7)), list(range(-3, 4))],
                                           dtype=torch.int32, device=cuda),
                 key: torch.randn((2, cfg.encoder_tokens, cfg.d_model), generator=gen,
                                  device=cuda)}
        forced = torch.randint(0, cfg.vocab_size, (4, 2, 1), generator=gen, device=cuda)

        def run(impl):
            logits, caches = model_lib.prefill(params, batch, cfg, max_len=32, impl=impl)
            out = [logits]
            for step in range(4):
                logits, caches = model_lib.decode_step(
                    params, forced[step], caches, torch.tensor([7 + step, 4 + step], device=cuda),
                    cfg, impl=impl)
                out.append(logits)
            return out

        ops.reset_counts()
        card = run(None)
        assert ops.launch_counts()["matmul_int8"] > 0
        assert all(v == 0 for v in ops.plain_cuda_counts().values())
        assert all(torch.equal(a, b) for a, b in zip(card, run("plain")))
