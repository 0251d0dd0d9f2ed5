"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device (decided in
the ``cuda`` fixture, never at import).  On a machine with a card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.  This
file imports no JAX, so it runs where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import bsdp_gemm, dim_kernel, gemv_int4, gemv_int8, ops, ref

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
