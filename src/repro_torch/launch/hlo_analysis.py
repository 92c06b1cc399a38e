"""Hardware constants of the port's card (counterpart of ``repro.launch.hlo_analysis``).

The reference keeps its TPU v5e constants and an XLA HLO-text parser
(``collective_bytes``) here.  Torch programs produce no HLO, so the
parser is not carried; the module keeps its name so a reader finds the
constants where the reference keeps them.  They are those of one NVIDIA
H100 SXM (NVIDIA H100 Tensor Core GPU datasheet, dense rates without
sparsity), at its full 700 W power limit.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12      # fp32 outside the tensor cores (no TF32)
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9             # device memory
# NVLink 4 (datasheet): 900 GB/s of bidirectional bandwidth a card, so
# 450e9 bytes/s each way.  The dry run computes no collective term (no
# partitioner), so nothing reads it yet.
NVLINK_BW = 450e9            # bytes/s, one direction
