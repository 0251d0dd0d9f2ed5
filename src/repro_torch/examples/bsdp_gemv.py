"""The paper's core experiment: amortized bit-serial GEMV (§IV + §VI).

Twin of the JAX package's ``examples/bsdp_gemv.py``::

    PYTHONPATH=src python -m repro_torch.examples.bsdp_gemv [--device cpu] [--calls 10]

Encodes a quantized int4 weight matrix (K = 4096, N = 2048) into the BSDP
bit-plane layout ONCE, then runs repeated GEMVs against fresh activations
(M = 4 int4 rows a call) — the paper's "matrix preloaded into PIM"
scenario — in every compute form: Algorithm 2's popcount and the one
plane-interleaved contraction (plain PyTorch, :mod:`repro_torch.core.bsdp`),
and ``ops.bsdp_matmul`` with the ``gemv`` (the popcount kernel, at M = 4 as
the reference's ``kernel="gemv"``), ``gemm``, ``gemm_fused`` kernels and
the batch's own dispatch (M > 1: ``gemm``).  Each call is checked bit-exact
against the int32 oracle ``ref.bsdp_ref`` and timed with a device sync;
the encode-amortization lines are printed.  Runs on the card unless
``--device cpu`` is given (the kernel wrappers then take their plain
versions).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import bitplane, bsdp
from repro_torch.kernels import ops, ref

K, N, CALLS, M = 4096, 2048, 10, 4

#: the compute forms, each ``fn(planes, a) -> int32 [M, N]``
FORMS = {
    "popcount (Algorithm 2, cao / lsl_add)":
        lambda planes, a: bsdp.bsdp_gemv(planes, a, form="popcount"),
    "plane-matmul (one plane-interleaved contraction)":
        lambda planes, a: bsdp.bsdp_gemv(planes, a, form="matmul"),
    "gemv kernel (popcount)": lambda planes, a: ops.bsdp_matmul(a, planes, kernel="gemv"),
    "gemm kernel (batched serving)": lambda planes, a: ops.bsdp_matmul(a, planes, kernel="gemm"),
    "gemm_fused kernel (one contraction a tile)":
        lambda planes, a: ops.bsdp_matmul(a, planes, kernel="gemm_fused"),
    "auto-dispatch (M>1 -> gemm)": lambda planes, a: ops.bsdp_matmul(a, planes),
}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--calls", type=int, default=CALLS)
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    rng = np.random.default_rng(0)
    w4 = torch.from_numpy(rng.integers(-8, 8, (K, N)).astype(np.int8)).to(device)
    _sync(device)
    t0 = time.perf_counter()
    planes = bitplane.encode_weights(w4)
    _sync(device)
    t_encode = time.perf_counter() - t0
    print(f"one-time bit-plane encode: {t_encode * 1e3:.1f} ms "
          f"({planes.numel() * 4 / 1e6:.1f} MB resident vs "
          f"{K * N * 2 / 1e6:.1f} MB bf16 — 4x smaller)")

    forms = {}
    for name, fn in FORMS.items():
        total, outs = 0.0, []
        for _ in range(args.calls):
            a = torch.from_numpy(rng.integers(-8, 8, (M, K)).astype(np.int8)).to(device)
            _sync(device)
            t0 = time.perf_counter()
            out = fn(planes, a)
            _sync(device)
            total += time.perf_counter() - t0
            assert torch.equal(out, ref.bsdp_ref(a, w4)), name
            outs.append(out.cpu().numpy())
        per = total / args.calls
        forms[name] = {"ms": per * 1e3, "outs": outs}
        print(f"{name:<48} {per * 1e3:8.2f} ms/GEMV  "
              f"(encode amortized over {args.calls} calls: "
              f"+{t_encode / args.calls / per * 100:.1f}% each)")
    print("bsdp_gemv OK — all forms bit-exact vs the int32 oracle")
    return {"encode_ms": t_encode * 1e3, "planes": planes.cpu().numpy(), "forms": forms}


if __name__ == "__main__":
    main()
