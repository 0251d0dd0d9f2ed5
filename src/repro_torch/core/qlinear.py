"""QuantLinear: the paper's weight-resident quantized GEMV as a layer.

Stable import surface; the semantics live in
:mod:`repro_torch.core.residency` (counterpart of :mod:`repro.core.qlinear`).
"""

from __future__ import annotations

from repro_torch.core.residency import (  # noqa: F401  (stable re-exports)
    QuantLinearState,
    apply,
    from_float,
    resident_bytes,
)
