"""PyTorch/CUDA port of the bit-plane serving system in :mod:`repro`.

The package keeps the JAX package's module names (``core.bitplane``,
``kernels.ops``, ``serve.engine`` ...) so each module's counterpart is easy
to find, but it imports nothing of ``repro`` and never imports ``jax``.

Dispatch goes by the tensor's device: a kernel wrapper given a CPU tensor
runs its plain PyTorch version; given a CUDA tensor it launches the
hand-written Hopper kernel (``csrc/*.cu``) or raises.  Entry points
(:class:`repro_torch.serve.engine.ServeEngine`, ``materialize``, the
``launch.serve`` CLI) default to ``device="cuda"`` and raise when no GPU
is present unless the caller asks for ``"cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions on the CPU"
        )
    return dev
