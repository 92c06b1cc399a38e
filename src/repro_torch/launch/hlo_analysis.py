"""Hardware constants of the port's card (counterpart of ``repro.launch.hlo_analysis``).

The reference keeps its TPU v5e constants and an XLA HLO-text parser
(``collective_bytes``) here.  Torch programs produce no HLO, so the
parser is not carried: the dry run counts DTensor's collectives as they
run (``launch.dryrun.StepCounter``), by the parser's rule.  The module
keeps its name so a reader finds the constants where the reference
keeps them.  They are those of one NVIDIA
H100 SXM (NVIDIA H100 Tensor Core GPU datasheet, dense rates without
sparsity), at its full 700 W power limit.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12      # fp32 outside the tensor cores (no TF32)
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9             # device memory
# NVLink 4 (datasheet): 900 GB/s of bidirectional bandwidth a card, so
# 450e9 bytes/s each way.  The dry run charges a collective at this rate
# when its group lies within one node (NODE_CARDS cards).
NVLINK_BW = 450e9            # bytes/s, one direction
# NVIDIA DGX H100: 8 cards a node on NVLink 4 (NVSwitch), and one 400
# Gb/s ConnectX-7 InfiniBand port a card between nodes, 50e9 bytes/s
# each way.  A collective whose group spans more than one node (every
# axis of the 16x16 and 2x16x16 meshes) is charged at this rate.
NODE_CARDS = 8
IB_BW = 50e9                 # bytes/s, one direction, a card
