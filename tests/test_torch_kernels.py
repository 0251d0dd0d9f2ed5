"""Each kernel module of the port against the JAX function it replaces.

On the CPU every wrapper runs its kernel's plain version; the JAX side runs
its Pallas kernel in interpret mode.  Integer outputs (BSDP, the int32 W8A8
and DIM sums) must be bit-exact, and so must the scaled W8A8 and W4A8
outputs: both packages apply the float32 scales to the same exact integer
sums in the same order.  The W8A16 matmul is held within 1e-5 and plane
attention within 1e-4 (the tolerance ``tests/test_kvcache.py`` holds the
fused read to).  The CUDA kernels are
held against their plain versions on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as ref_bitplane
from repro.core import quant as ref_quant
from repro.core.quant import QuantTensor
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch.core import bitplane, kvcache, quant
from repro_torch.kernels import _build, ops, ref

from _torch_inputs import attention_inputs, t, words


class TestBsdpKernels:
    @pytest.mark.parametrize("kernel", ["gemv", "gemm_fused", "gemm"])
    @pytest.mark.parametrize("m,n,kw", [(1, 40, 3), (5, 17, 2), (4, 24, 192)])
    def test_matches_pallas_kernel_bit_exact(self, kernel, m, n, kw):
        rng = np.random.default_rng(10 + m)
        x, w = words(rng, (m, 4, kw)), words(rng, (n, 4, kw))
        got = ops.bsdp_matmul_planes(t(x), t(w), kernel=kernel)
        want = ref_ops.bsdp_matmul_planes(jnp.asarray(x), jnp.asarray(w),
                                          kernel=kernel, interpret=True)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_bsdp_matmul_from_raw_int4(self):
        rng = np.random.default_rng(11)
        x = rng.integers(-8, 8, size=(3, 70)).astype(np.int8)  # K padded to 96
        wq = rng.integers(-8, 8, size=(70, 9)).astype(np.int8)
        w = bitplane.encode_weights(bitplane.pad_to_word(torch.from_numpy(wq), axis=0))
        got = ops.bsdp_matmul(torch.from_numpy(x), w, kernel="gemm_fused")
        np.testing.assert_array_equal(got.numpy(), x.astype(np.int32) @ wq.astype(np.int32))

    def test_unknown_kernel_names_the_format(self):
        x = torch.zeros((2, 4, 1), dtype=torch.int32)
        with pytest.raises(ValueError, match="bsdp_fused"):
            ops.bsdp_matmul_planes(x, x, kernel="gemm_v2", fmt_name="bsdp_fused")

    @pytest.mark.parametrize("signed", [True, False])
    def test_unrolled_gemm_is_bit_identical_to_fused(self, signed):
        rng = np.random.default_rng(13)
        x, w = t(words(rng, (6, 4, 3))), t(words(rng, (21, 4, 3)))
        got = ops.bsdp_matmul_planes(x, w, kernel="gemm", signed=signed)
        np.testing.assert_array_equal(
            got.numpy(), ops.bsdp_matmul_planes(x, w, kernel="gemm_fused",
                                                signed=signed).numpy())
        np.testing.assert_array_equal(got.numpy(), ref.bsdp_gemm_ref(x, w, signed=signed).numpy())

    @pytest.mark.parametrize("m,want", [(1, "gemv"), (3, "gemm")])
    def test_default_kernel_is_the_reference_batch_default(self, monkeypatch, m, want):
        called = []
        for name in list(ops._BSDP_KERNELS):
            monkeypatch.setitem(ops._BSDP_KERNELS, name,
                                lambda x, w, signed, name=name: called.append(name))
        x = torch.zeros((m, 4, 1), dtype=torch.int32)
        ops.bsdp_matmul_planes(x, torch.zeros((2, 4, 1), dtype=torch.int32))
        assert called == [want] == [ref_ops.bsdp_kernel_for(m)]

    @pytest.mark.parametrize("m", [1, 4])
    def test_bsdp_gemv_alias_and_bsdp_ref_match_reference(self, m):
        """``ops.bsdp_gemv`` (the reference's alias of ``bsdp_matmul``, by
        batch: the GEMV kernel at M = 1, the GEMM at M = 4) and the
        ``bsdp_ref`` oracle, bit-exact against the reference's, K off the
        32-element word."""
        rng = np.random.default_rng(15 + m)
        x = rng.integers(-8, 8, size=(m, 70)).astype(np.int8)
        wq = rng.integers(-8, 8, size=(70, 24)).astype(np.int8)
        w = bitplane.encode_weights(bitplane.pad_to_word(torch.from_numpy(wq), axis=0))
        ref_w = ref_bitplane.encode_weights(ref_bitplane.pad_to_word(jnp.asarray(wq), axis=0))
        got = ops.bsdp_gemv(torch.from_numpy(x), w)
        want = ref_ops.bsdp_gemv(jnp.asarray(x), ref_w, interpret=True)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        oracle = ref.bsdp_ref(torch.from_numpy(x), torch.from_numpy(wq))
        np.testing.assert_array_equal(
            oracle.numpy(), np.asarray(ref_oracles.bsdp_ref(jnp.asarray(x), jnp.asarray(wq))))
        np.testing.assert_array_equal(oracle.numpy(), got.numpy())

    def test_oracles_match_reference_oracles(self):
        rng = np.random.default_rng(12)
        x, w = words(rng, (3, 4, 2)), words(rng, (6, 4, 2))
        for port_fn, ref_fn in ((ref.bsdp_planes_ref, ref_oracles.bsdp_planes_ref),
                                (ref.bsdp_gemm_ref, ref_oracles.bsdp_gemm_ref)):
            np.testing.assert_array_equal(
                port_fn(t(x), t(w)).numpy(),
                np.asarray(ref_fn(jnp.asarray(x), jnp.asarray(w))))
        np.testing.assert_array_equal(
            ref.decode_weights_ref(t(w)).numpy(),
            np.asarray(ref_oracles.decode_weights_ref(jnp.asarray(w))))

    def test_integer_oracles_match_reference_oracles(self):
        rng = np.random.default_rng(14)
        x, w8 = _int8(rng, (3, 64)), _int8(rng, (64, 5))
        xs, ws = _scales(rng, 3, 5)
        w4 = _int8(rng, (64, 5), -8, 8)
        w16 = rng.integers(-32768, 32768, size=(64, 5)).astype(np.int16)
        w16[0, 0], w16[1, 1], w16[2, 2] = -32768, 32767, -1
        pairs = (
            (ref.matmul_int8_ref(t(x), t(w8)),
             ref_oracles.matmul_int8_ref(jnp.asarray(x), jnp.asarray(w8))),
            (ref.matmul_int8_scaled_ref(t(x), t(w8), t(xs), t(ws)),
             ref_oracles.matmul_int8_scaled_ref(jnp.asarray(x), jnp.asarray(w8),
                                                jnp.asarray(xs), jnp.asarray(ws))),
            (ref.matmul_int4_packed_ref(t(x), quant.pack_int4(t(w4))),
             ref_oracles.matmul_int4_packed_ref(jnp.asarray(x),
                                                ref_quant.pack_int4(jnp.asarray(w4)))),
            (ref.dim_w16a8_ref(t(x), t(w16)),
             ref_oracles.dim_w16a8_ref(jnp.asarray(x), jnp.asarray(w16))),
        )
        for got, want in pairs:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _int8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, size=shape).astype(np.int8)


def _scales(rng, m, n):
    return ((rng.random((m, 1)) * 0.05 + 1e-3).astype(np.float32),
            (rng.random((1, n)) * 0.05 + 1e-3).astype(np.float32))


class TestInt8Kernel:
    @pytest.mark.parametrize("out_int32", [False, True])
    @pytest.mark.parametrize("m,k,n", [(1, 200, 33), (6, 130, 150), (4, 6144, 40)])
    def test_quant_matmul_matches_pallas_kernel_bit_exact(self, m, k, n, out_int32):
        rng = np.random.default_rng(50 + m)
        x, w = _int8(rng, (m, k)), _int8(rng, (k, n))
        xs, ws = _scales(rng, m, n)
        got = ops.quant_matmul(quant.QuantTensor(t(x), t(xs), bits=8, axis=-1),
                               quant.QuantTensor(t(w), t(ws), bits=8, axis=0),
                               out_int32=out_int32)
        want = ref_ops.quant_matmul(
            QuantTensor(data=jnp.asarray(x), scale=jnp.asarray(xs), bits=8, axis=-1),
            QuantTensor(data=jnp.asarray(w), scale=jnp.asarray(ws), bits=8, axis=0),
            out_int32=out_int32, interpret=True)
        assert got.dtype == (torch.int32 if out_int32 else torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_matmul_int8_raw_at_the_int8_extremes(self):
        x = np.full((3, 300), -128, np.int8)
        w = np.full((300, 20), -128, np.int8)
        w[:, 1] = 127
        got = ops.matmul_int8_raw(t(x), t(w))
        want = ref_ops.matmul_int8_raw(jnp.asarray(x), jnp.asarray(w), interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[0, 0].item() == 128 * 128 * 300


class TestInt4PackedKernel:
    @pytest.mark.parametrize("m,k,n", [(1, 64, 40), (5, 258, 17)])
    def test_matches_pallas_kernel_bit_exact_with_both_nibble_extremes(self, m, k, n):
        rng = np.random.default_rng(60 + m)
        x = _int8(rng, (m, k))
        wq = _int8(rng, (k, n), -8, 8)
        wq[0, 0], wq[1, 0] = -8, 7  # low nibble -8, high nibble 7
        wq[2, 1], wq[3, 1] = 7, -8  # low nibble 7, high nibble -8
        wq[4:6, 2] = -8
        wq[6:8, 3] = 7
        xs, ws = _scales(rng, m, n)
        wp = quant.pack_int4(t(wq), axis=0)
        got = ops.quant_matmul_int4(quant.QuantTensor(t(x), t(xs), bits=8, axis=-1),
                                    wp, t(ws))
        want = ref_ops.quant_matmul_int4(
            QuantTensor(data=jnp.asarray(x), scale=jnp.asarray(xs), bits=8, axis=-1),
            ref_quant.pack_int4(jnp.asarray(wq), axis=0), jnp.asarray(ws), interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        exact = x.astype(np.int64) @ wq.astype(np.int64)
        np.testing.assert_array_equal(
            ref.matmul_int4_packed_ref(t(x), wp).numpy(), exact)


class TestDimKernel:
    @pytest.mark.parametrize("m,k,n", [(1, 128, 40), (4, 96, 130)])
    def test_matches_pallas_kernel_with_int16_edges(self, m, k, n):
        rng = np.random.default_rng(70 + m)
        x = _int8(rng, (m, k))
        w = rng.integers(-32768, 32768, size=(k, n)).astype(np.int16)
        w[0, 0], w[1, 1], w[2, 0] = 32767, -32768, -1
        got = ops.dim_matmul(t(x), t(w))
        want = ref_ops.dim_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_sum_outside_int32_wraps_like_the_reference(self):
        k = 640  # 127 · 32767 · 640 > 2^31: the true sums leave int32
        x = np.full((2, k), 127, np.int8)
        x[1] = -128
        w = np.full((k, 3), 32767, np.int16)
        w[:, 1] = -32768
        w[:, 2] = -1
        exact = x.astype(np.int64) @ w.astype(np.int64)
        assert np.abs(exact).max() > 2**31
        wrapped = ((exact + 2**31) % 2**32 - 2**31).astype(np.int32)
        got = ops.dim_matmul(t(x), t(w))
        want = ref_ops.dim_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True)
        np.testing.assert_array_equal(np.asarray(want), wrapped)
        np.testing.assert_array_equal(got.numpy(), wrapped)
        np.testing.assert_array_equal(ref.dim_w16a8_ref(t(x), t(w)).numpy(), wrapped)


class TestDequantKernel:
    @pytest.mark.parametrize("m,k,n", [(1, 64, 48), (6, 200, 33)])
    def test_matches_pallas_kernel(self, m, k, n):
        rng = np.random.default_rng(20 + m)
        x = rng.normal(size=(m, k)).astype(np.float32)
        w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
        s = (rng.random((1, n)) * 0.02 + 1e-3).astype(np.float32)
        got = ops.weight_only_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(s))
        want = ref_ops.weight_only_matmul(
            jnp.asarray(x), QuantTensor(data=jnp.asarray(w), scale=jnp.asarray(s),
                                        bits=8, axis=0), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            ref.dequant_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(s)).numpy(),
            np.asarray(ref_oracles.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                                      jnp.asarray(s))),
            rtol=1e-5, atol=1e-5)


    @pytest.mark.parametrize("m,k,n", [(1, 64, 48), (6, 200, 33)])
    def test_bf16_activations_match_pallas_kernel(self, m, k, n):
        """The model's working type goes in as it is: both packages widen
        bf16 to float32 inside the kernel, exactly, so the tolerance is the
        float32 case's."""
        rng = np.random.default_rng(22 + m)
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
        w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
        s = (rng.random((1, n)) * 0.02 + 1e-3).astype(np.float32)
        got = ops.weight_only_matmul(x, torch.from_numpy(w), torch.from_numpy(s))
        x_np = x.to(torch.float32).numpy()
        want = ref_ops.weight_only_matmul(
            jnp.asarray(x_np, dtype=jnp.bfloat16),
            QuantTensor(data=jnp.asarray(w), scale=jnp.asarray(s), bits=8, axis=0),
            interpret=True)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            got.numpy(), ops.weight_only_matmul(x.to(torch.float32), torch.from_numpy(w),
                                                torch.from_numpy(s)).numpy())

    @pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
    def test_other_activation_dtypes_are_rejected(self, dtype):
        x = torch.zeros((2, 64), dtype=dtype)
        w = torch.zeros((64, 32), dtype=torch.int8)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            ops.weight_only_matmul(x, w, torch.ones((1, 32)))


class TestPlaneAttentionKernel:
    def test_matches_pallas_kernel(self):
        a = attention_inputs()
        b, l, h = a["ks"].shape
        g = a["bias"].shape[2]
        got = ops.plane_decode_attention(
            a["q_planes"], a["q_scale"], t(a["kp"]), torch.from_numpy(a["ks"]),
            t(a["vp"]), torch.from_numpy(a["vs"]), torch.from_numpy(a["bias"]),
            sm_scale=a["sm"], feat=a["feat"])

        def rows(arr):  # [B, L, H, ...] → the reference's [B·H, L, ...]
            arr = np.moveaxis(arr, 2, 1)
            return jnp.asarray(arr.reshape(b * h, l, *arr.shape[3:]))

        fw = a["kp"].shape[-1]
        want = ref_ops.plane_decode_attention(
            jnp.asarray(a["q_planes"].numpy().view(np.uint32).reshape(b * h, g, 4, fw)),
            jnp.asarray(a["q_scale"].numpy().reshape(b * h, g)),
            rows(a["kp"]), rows(a["ks"]), rows(a["vp"]), rows(a["vs"]),
            jnp.asarray(a["bias"].reshape(b * h, g, l)),
            sm_scale=a["sm"], feat=a["feat"], interpret=True)
        want = np.asarray(want).reshape(b, h, g, a["feat"])
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    def test_fused_format_matches_unfused_plane_math(self):
        """The int4_bp format's qk → masked softmax → av (the plain version's
        reference semantics) agrees with the fused read on live rows."""
        a = attention_inputs(seed=31)
        kst = {"": t(a["kp"]), "_scale": torch.from_numpy(a["ks"])}
        vst = {"": t(a["vp"]), "_scale": torch.from_numpy(a["vs"])}
        q = torch.from_numpy(np.random.default_rng(31).normal(
            size=a["bias"].shape[:3] + (a["feat"],)).astype(np.float32))
        bias = torch.from_numpy(a["bias"])
        fused = kvcache.get_cache_format("int4_bp_fused").decode_attention(
            q, kst, vst, bias, sm_scale=a["sm"], feat=a["feat"])
        fmt = kvcache.get_cache_format("int4_bp")
        scores = fmt.qk(q, kst) * a["sm"]
        w = torch.softmax(torch.where(bias == 0, scores, -1e30), dim=-1)
        unfused = fmt.av(w, vst, a["feat"])
        np.testing.assert_allclose(fused[1:].numpy(), unfused[1:].numpy(),
                                   rtol=1e-4, atol=1e-4)


class TestDispatch:
    def test_non_cuda_device_raises_instead_of_falling_back(self):
        x = torch.zeros((1, 4, 2), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            ops.bsdp_matmul_planes(x, x, kernel="gemv")

    def test_every_kernel_source_exists_and_is_registered(self):
        assert set(_build.KERNELS) == {"bsdp_gemv", "bsdp_gemm_fused", "bsdp_gemm",
                                       "dequant_matmul", "plane_decode_attention",
                                       "matmul_int8", "matmul_int4_packed",
                                       "matmul_w16a8"}
        for k in _build.KERNELS.values():
            assert (_build.CSRC / k.source).is_file()
            assert k.replaces.startswith("src/repro/kernels/")
