"""Each kernel module of the port against the JAX function it replaces.

On the CPU every wrapper runs its kernel's plain version; the JAX side runs
its Pallas kernel in interpret mode.  BSDP sums must be bit-exact, the
W8A16 matmul within 1e-5 and plane attention within 1e-4 (the tolerance
``tests/test_kvcache.py`` holds the fused read to).  The CUDA kernels are
held against their plain versions on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantTensor
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch.core import bitplane, kvcache
from repro_torch.kernels import _build, ops, ref

from _torch_inputs import attention_inputs, t, words


class TestBsdpKernels:
    @pytest.mark.parametrize("kernel", ["gemv", "gemm_fused"])
    @pytest.mark.parametrize("m,n,kw", [(1, 40, 3), (5, 17, 2)])
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
            ops.bsdp_matmul_planes(x, x, kernel="gemm", fmt_name="bsdp_fused")

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
        assert set(_build.KERNELS) == {"bsdp_gemv", "bsdp_gemm_fused",
                                       "dequant_matmul", "plane_decode_attention"}
        for k in _build.KERNELS.values():
            assert (_build.CSRC / k.source).is_file()
            assert k.replaces.startswith("src/repro/kernels/")
