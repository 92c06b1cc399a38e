"""Flags that change what the model computes (port of ``repro.models.flags``).

Both are off by default, as in the reference, whose baseline keeps
them off; the dry run turns them on with ``--opts bf16_stream`` and
``--opts moe_dispatch``.

``ATTN_BF16_STREAM``: the plain attention versions (``kernels.ref``,
which run for CPU and meta tensors) round the softmax weights to V's
dtype before the weighted sum, as the reference's ``_attend`` does when
it keeps the QK^T and AV operands in bf16 with fp32 accumulation.  The
products of bf16 operands are exact in fp32, so the scores need no
change.  K1 and K2 always stream bf16 operands and accumulate in fp32,
and are not affected.

``MOE_DECODE_DISPATCH``: MoE decode runs the capacity dispatch instead
of gathering each token's expert weights when the step has at least as
many (token, expert) pairs as experts (``T * top_k >= num_experts``).

Not carried, because they steer XLA and nothing here:

- ``WHERE_CACHE_UPDATE`` writes the decode cache with ``where`` instead
  of a scatter, which GSPMD partitions without rematerialising a
  sequence-sharded cache.  The port's ``attention._write`` already
  writes its slot in place; the dry run refuses ``--opts where_cache``.
- ``SCAN_UNROLL`` / ``unrolled_scans`` and ``PROBE_BLOCK_Q`` exist
  because XLA's HloCostAnalysis counts a while loop's body once.  Eager
  torch runs no scan: its counters see every layer.
- ``SEQ_PARALLEL_ATTN`` is read nowhere in the reference.
"""
from __future__ import annotations

ATTN_BF16_STREAM = False
MOE_DECODE_DISPATCH = False
