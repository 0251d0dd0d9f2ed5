"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device (decided in
the ``cuda`` fixture, never at import).  On a machine with a card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.  This
file imports no JAX, so it runs where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

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
            for kernel in ("gemv", "gemm_fused"):
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
