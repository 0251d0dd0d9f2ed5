"""The port's core math against the JAX reference, bit for bit.

Plane words are compared as uint32 (the port holds them as int32
bit-views); int8 payloads, float32 scales and int32 BSDP sums must be
identical.  Inputs come from numpy seeds and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import bitplane as ref_bitplane
from repro.core import bsdp as ref_bsdp
from repro.core import dim as ref_dim
from repro.core import quant as ref_quant
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.sharding import partitioning as P
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import bitplane, bsdp, dim, quant
from repro_torch.serve import engine


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _int4(rng, shape, signed=True):
    lo, hi = (-8, 8) if signed else (0, 16)
    return rng.integers(lo, hi, size=shape).astype(np.int8)


def _words(rng, shape):
    """Random plane words with every bit pattern, bit 31 included."""
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


class TestBitplane:
    @pytest.mark.parametrize("shape", [(32,), (3, 64), (2, 5, 128)])
    @pytest.mark.parametrize("signed", [True, False])
    def test_encode_words_match_reference(self, shape, signed):
        x = _int4(np.random.default_rng(0), shape, signed)
        got = _u32(bitplane.encode(torch.from_numpy(x)))
        want = np.asarray(ref_bitplane.encode(jnp.asarray(x)))
        np.testing.assert_array_equal(got, want)

    def test_bit31_is_the_sign_plane_of_element_31(self):
        x = np.zeros(32, np.int8)
        x[31] = -8  # only the 2^3 plane, element 31
        planes = _u32(bitplane.encode(torch.from_numpy(x)))
        assert planes[3, 0] == 0x80000000 and not planes[:3].any()
        back = bitplane.decode(torch.from_numpy(planes.view(np.int32)))
        np.testing.assert_array_equal(back.numpy(), x)

    @pytest.mark.parametrize("signed", [True, False])
    def test_decode_matches_reference_on_all_words(self, signed):
        w = _words(np.random.default_rng(1), (3, 4, 5))
        got = bitplane.decode(torch.from_numpy(w.view(np.int32)), signed=signed).numpy()
        want = np.asarray(ref_bitplane.decode(jnp.asarray(w), signed=signed))
        np.testing.assert_array_equal(got, want)

    def test_encode_weights_and_pad_to_word(self):
        q = _int4(np.random.default_rng(2), (40, 24))
        got = bitplane.encode_weights(bitplane.pad_to_word(torch.from_numpy(q), axis=0))
        want = ref_bitplane.encode_weights(ref_bitplane.pad_to_word(jnp.asarray(q), axis=0))
        assert got.shape == (24, 4, 2)
        np.testing.assert_array_equal(_u32(got), np.asarray(want))


class TestQuant:
    @pytest.mark.parametrize("bits", [8, 4])
    def test_quantize_weights_and_acts_bit_identical(self, bits):
        rng = np.random.default_rng(3)
        w = rng.normal(size=(48, 20)).astype(np.float32)
        w[3, 2] = 0.5 * np.abs(w[:, 2]).max() / 7 * 7  # exact .5 steps happen
        x = rng.normal(size=(5, 48)).astype(np.float32)
        for port_fn, ref_fn, a in ((quant.quantize_weights, ref_quant.quantize_weights, w),
                                   (quant.quantize_acts, ref_quant.quantize_acts, x)):
            got = port_fn(torch.from_numpy(a), bits=bits)
            want = ref_fn(jnp.asarray(a), bits=bits)
            np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
            np.testing.assert_array_equal(got.scale.numpy().view(np.uint32),
                                          np.asarray(want.scale).view(np.uint32))

    def test_round_half_to_even(self):
        x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 7.0]])
        q = quant.quantize(x, bits=8, scale=torch.ones((1, 1)))
        assert q.data.tolist() == [[0, 2, 2, 0, -2, 7]]

    @pytest.mark.parametrize("shape,axis", [((6, 5), 0), ((3, 8), 1), ((2, 4, 6), -1)])
    def test_pack_int4_bytes_match_reference_and_round_trip(self, shape, axis):
        q = _int4(np.random.default_rng(7), shape)
        q.reshape(-1)[:4] = [-8, 7, 7, -8]  # both extremes in both nibbles
        got = quant.pack_int4(torch.from_numpy(q), axis=axis)
        want = ref_quant.pack_int4(jnp.asarray(q), axis=axis)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = quant.unpack_int4(got, axis=axis).numpy()
        np.testing.assert_array_equal(back, q)
        np.testing.assert_array_equal(
            back, np.asarray(ref_quant.unpack_int4(want, axis=axis)))

    def test_pack_int4_rejects_odd_length(self):
        with pytest.raises(ValueError, match="even"):
            quant.pack_int4(torch.zeros((3, 2), dtype=torch.int8))


class TestDim:
    def test_decompositions_match_reference(self):
        rng = np.random.default_rng(8)
        w16 = rng.integers(-32768, 32768, size=(9, 7)).astype(np.int16)
        w16.reshape(-1)[:3] = [-32768, 32767, -1]
        w32 = rng.integers(-2**31, 2**31, size=(9, 7)).astype(np.int32)
        for port, want in ((dim.decompose_int16(torch.from_numpy(w16)),
                            ref_dim.decompose_int16(jnp.asarray(w16))),
                           (dim.decompose_int32(torch.from_numpy(w32)),
                            ref_dim.decompose_int32(jnp.asarray(w32)))):
            for a, b in zip(port, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            dim.compose_int16(*dim.decompose_int16(torch.from_numpy(w16))).numpy(), w16)

    def test_wide_matmuls_wrap_like_reference(self):
        rng = np.random.default_rng(9)
        x = rng.integers(-128, 128, size=(3, 700)).astype(np.int8)
        x[0] = 127
        w16 = rng.integers(-32768, 32768, size=(700, 4)).astype(np.int16)
        w16[:, 0] = 32767  # 127 · 32767 · 700 leaves int32
        w32 = rng.integers(-2**31, 2**31, size=(700, 4)).astype(np.int32)
        np.testing.assert_array_equal(
            dim.matmul_w16a8(torch.from_numpy(x), torch.from_numpy(w16)).numpy(),
            np.asarray(ref_dim.matmul_w16a8(jnp.asarray(x), jnp.asarray(w16))))
        np.testing.assert_array_equal(
            dim.matmul_w32a8(torch.from_numpy(x), torch.from_numpy(w32)).numpy(),
            np.asarray(ref_dim.matmul_w32a8(jnp.asarray(x), jnp.asarray(w32))))
        assert dim.MAX_K_PER_PASS == ref_dim.MAX_K_PER_PASS


class TestBsdp:
    def test_popcount32_all_bits(self):
        w = _words(np.random.default_rng(4), (257,))
        w[:3] = [0, 0xFFFFFFFF, 0x80000000]
        got = bsdp.popcount32(torch.from_numpy(w.view(np.int32))).numpy()
        want = np.array([bin(int(v)).count("1") for v in w])
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("signed", [True, False])
    def test_popcount_and_matmul_planes_match_reference(self, signed):
        rng = np.random.default_rng(5)
        x, w = _words(rng, (3, 4, 6)), _words(rng, (7, 4, 6))
        xt, wt = (torch.from_numpy(a.view(np.int32)) for a in (x, w))
        want = np.asarray(ref_bsdp.bsdp_matmul_planes(jnp.asarray(x), jnp.asarray(w),
                                                      signed=signed))
        got_pc = bsdp.bsdp_popcount(xt[:, None], wt[None], signed=signed).numpy()
        got_mm = bsdp.bsdp_matmul_planes(xt, wt, signed=signed).numpy()
        ref_pc = np.asarray(ref_bsdp.bsdp_popcount(
            jnp.asarray(x)[:, None], jnp.asarray(w)[None], signed=signed))
        np.testing.assert_array_equal(got_pc, ref_pc)
        np.testing.assert_array_equal(got_mm, want)
        np.testing.assert_array_equal(got_pc, want)

    @pytest.mark.parametrize("signed", [True, False])
    @pytest.mark.parametrize("m", [1, 4])
    def test_gemv_entry_points_match_reference(self, m, signed):
        """``bsdp_gemv`` in both forms and ``bsdp_gemv_popcount``, from raw
        int4 activations (the reference's GEMV API), bit-exact."""
        rng = np.random.default_rng(7 + m)
        x = _int4(rng, (m, 96), signed)
        wq = _int4(rng, (96, 40), signed)
        w_planes = bitplane.encode_weights(torch.from_numpy(wq))
        ref_w = ref_bitplane.encode_weights(jnp.asarray(wq))
        np.testing.assert_array_equal(_u32(w_planes), np.asarray(ref_w))
        want = x.astype(np.int32) @ wq.astype(np.int32)
        for form in ("popcount", "matmul"):
            got = bsdp.bsdp_gemv(w_planes, torch.from_numpy(x), signed=signed, form=form)
            ref = ref_bsdp.bsdp_gemv(ref_w, jnp.asarray(x), signed=signed, form=form)
            assert got.dtype == torch.int32 and tuple(got.shape) == (m, 40)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            np.testing.assert_array_equal(got.numpy(), want)
        x_planes = bitplane.encode_acts(torch.from_numpy(x))
        got = bsdp.bsdp_gemv_popcount(w_planes, x_planes, signed=signed)
        ref = ref_bsdp.bsdp_gemv_popcount(ref_w, ref_bitplane.encode_acts(jnp.asarray(x)),
                                          signed=signed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        with pytest.raises(ValueError, match="unknown form"):
            bsdp.bsdp_gemv(w_planes, torch.from_numpy(x), form="mxu")

    def test_matmul_planes_is_the_int4_dot_product(self):
        rng = np.random.default_rng(6)
        x, w = _int4(rng, (4, 96)), _int4(rng, (5, 96))
        got = bsdp.bsdp_matmul_planes(bitplane.encode(torch.from_numpy(x)),
                                      bitplane.encode(torch.from_numpy(w)))
        np.testing.assert_array_equal(got.numpy(), x.astype(np.int32) @ w.T.astype(np.int32))


class TestConvertParams:
    def test_residency_payloads_bit_identical_to_reference(self):
        _check_payloads("ffn=bsdp_fused,mixer=w8a16")

    @pytest.mark.parametrize("mode", ["w8a8", "ffn=bsdp,mixer=w4a8", "w4a4_bsdp"])
    def test_new_format_payloads_bit_identical_to_reference(self, mode):
        _check_payloads(mode)


def _check_payloads(mode):
    ref_cfg = ref_smoke_config("qwen3-1.7b").scaled(n_layers=2, vocab_size=128)
    cfg = get_smoke_config("qwen3-1.7b").scaled(n_layers=2, vocab_size=128)
    ref_params = P.materialize(ref_model.specs(ref_cfg, 1), jax.random.PRNGKey(0))
    ref_q = ref_engine.convert_params(ref_params, ref_cfg, mode, min_dim=16)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    assert params["layers"][1]["ffn"]["w_in"].dtype == torch.bfloat16
    q = engine.convert_params(params, cfg, mode, min_dim=16)
    slot = ref_q["stack"]["slot0"]
    n_checked = 0
    for i, layer in enumerate(q["layers"]):
        for group, names in (("ffn", ("w_in", "w_out")),
                             ("mixer", ("wq", "wk", "wv", "wo"))):
            for name in names:
                got, want = layer[group][name], slot[group][name]
                assert got.mode == want.mode and (got.k, got.n) == (want.k, want.n)
                data = got.data.numpy()
                if got.data.dtype == torch.int32:  # plane words
                    data = data.view(np.uint32)
                np.testing.assert_array_equal(data, np.asarray(want.data[i]))
                np.testing.assert_array_equal(
                    got.scale.numpy().view(np.uint32),
                    np.asarray(want.scale[i]).view(np.uint32))
                n_checked += 1
    assert n_checked == 12
