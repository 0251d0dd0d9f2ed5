"""The paper's own workload: a quantized, weight-resident GEMV service.

Twin of the JAX package's ``repro.configs.upmem_gemv``: one giant GEMV
layer bank, the paper's 256 MB-128 GB matrices (§VI), whose rows the mesh
shards as the paper tiles the matrix over 2,551 DPUs.  It is not a model
and stays out of the architecture registry (``ARCH_NAMES``); its largest
sizes do not fit one 80 GB card.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class GemvServiceConfig:
    name: str = "upmem-gemv"
    d_in: int = 16384          # K (vector length)
    d_out: int = 16384         # N (rows); the size sweep scales it
    mode: str = "w8a8"         # bf16 | w8a16 | w8a8 | w4a8 | w4a4_bsdp
    scenario: str = "gemv_v"   # gemv_v (weights resident) | gemv_mv (streamed)
    batch: int = 1


CONFIG = GemvServiceConfig()

SIZE_SWEEP = [  # (d_out, d_in): the paper's 256 MB .. ~128 GB int8 matrices
    (16384, 16384),      # 256 MB
    (32768, 32768),      # 1 GB
    (65536, 65536),      # 4 GB
    (131072, 131072),    # 16 GB
    (262144, 262144),    # 64 GB
    (371_712, 371_712),  # ~128 GB
]
