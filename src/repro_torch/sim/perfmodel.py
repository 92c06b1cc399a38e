"""SplitWise-style instance performance model.

SplitWise (§7.1 of the paper) predicts batch execution time from real
inference profiles with an interpolation model split into prompt
(compute-bound) and decode (memory-bound) phases.  We keep the same
functional form:

  prefill time  = prompt_tokens / prompt_tps            (serial, MXU-bound)
  decode TBT    = base_tbt * (1 + batch_alpha * occupancy)

so one instance's sustained throughput is bounded by its decode slots
(max_batch) and by KV memory (kv_capacity_tokens ≈ max_batch × typical
request footprint) — "effective memory utilization" then moves through
the 30–70 % band the paper's thresholds assume.

Anchors: Llama2-70B prompt TPS ≈ 21 000 (Fig. 9); sustained input TPS at
target latency 95–522 (H100) / 68–293 (A100) from §2.1.  TPU v5e profiles
for the ten assigned architectures are derived from the dry-run roofline
(197 TFLOP/s bf16, 819 GB/s HBM per chip): prompt_tps ~ MXU-bound prefill,
base_tbt ~ HBM-bound weight streaming per token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class PerfProfile:
    name: str
    gpu: str
    prompt_tps: float          # prefill tokens/s per instance (burst)
    base_tbt: float            # decode seconds/token/request (light load)
    batch_alpha: float         # TBT degradation vs occupancy
    max_batch: int             # concurrent decode slots
    kv_capacity_tokens: int    # effective-memory token capacity
    gpus_per_instance: int
    load_time_local: float = 600.0    # cold start, weights in region (s)
    load_time_remote: float = 7200.0  # weights fetched cross-region (s)
    spot_swap_time: float = 60.0      # spot <-> private role flip (s)

    def decode_tbt(self, occupancy: float) -> float:
        return self.base_tbt * (1.0 + self.batch_alpha * occupancy)


def _p(name, gpu, prompt_tps, base_tbt, alpha, batch, cap, gpus, **kw):
    return PerfProfile(name, gpu, prompt_tps, base_tbt, alpha, batch, cap,
                       gpus, **kw)


PROFILES: Dict[str, PerfProfile] = {}

# --------------------------------------------------------------------------
# Paper models (H100 default; @a100 variants for the ablation §7.2.7)
# --------------------------------------------------------------------------
for prof in [
    _p("bloom-176b", "h100", 8_000, 0.050, 1.0, 10, 29_000, 8),
    _p("bloom-176b@a100", "a100", 5_000, 0.080, 1.0, 8, 23_500, 8,
       load_time_local=900.0),
    _p("llama2-70b", "h100", 21_000, 0.040, 1.0, 12, 35_000, 8),
    _p("llama2-70b@a100", "a100", 12_000, 0.065, 1.0, 10, 29_000, 8,
       load_time_local=900.0),
    _p("llama3.1-8b", "h100", 120_000, 0.010, 0.8, 48, 141_000, 8),
    _p("llama3.1-8b@a100", "a100", 70_000, 0.016, 0.8, 36, 106_000, 8,
       load_time_local=900.0),
    _p("llama3.2-3b", "h100", 250_000, 0.006, 0.8, 64, 188_000, 8),
    _p("llama3.2-3b@a100", "a100", 150_000, 0.010, 0.8, 48, 141_000, 8,
       load_time_local=900.0),
    _p("llama4-scout", "h100", 90_000, 0.015, 0.9, 24, 70_500, 8),
]:
    PROFILES[prof.name] = prof

# --------------------------------------------------------------------------
# Assigned architectures on TPU v5e slices
# --------------------------------------------------------------------------
for prof in [
    _p("starcoder2-7b", "v5e-4x4", 100_000, 0.010, 0.9, 40, 117_500, 16),
    _p("mamba2-370m", "v5e-4x4", 900_000, 0.002, 0.3, 128, 376_000, 16),
    _p("zamba2-7b", "v5e-4x4", 100_000, 0.009, 0.5, 64, 188_000, 16),
    _p("llama4-scout-17b-a16e", "v5e-4x4", 70_000, 0.015, 0.9, 24,
       70_500, 16),
    _p("stablelm-12b", "v5e-4x4", 60_000, 0.016, 0.9, 32, 94_000, 16),
    _p("qwen2-72b", "v5e-4x4", 17_000, 0.042, 1.0, 12, 35_000, 16),
    _p("deepseek-v3-671b", "v5e-8x8", 9_000, 0.028, 1.1, 32, 94_000, 64,
       load_time_local=1800.0),
    _p("gemma-7b", "v5e-4x4", 95_000, 0.010, 0.9, 40, 117_500, 16),
    _p("whisper-tiny", "v5e-2x2", 2_000_000, 0.001, 0.2, 256, 752_000, 4),
    _p("pixtral-12b", "v5e-4x4", 60_000, 0.016, 0.9, 32, 94_000, 16),
]:
    PROFILES[prof.name] = prof


def get_profile(name: str) -> PerfProfile:
    if name not in PROFILES:
        raise KeyError(f"no perf profile for {name!r}; "
                       f"available: {sorted(PROFILES)}")
    return PROFILES[name]

# NOTE on workload subsampling: traffic thinned by factor f is served by a
# fleet whose instance-count limits are scaled by f (see benchmarks) — the
# per-instance arrival process, utilization and latency distributions are
# then unchanged, only the number of instances (and simulated events)
# shrinks.  Profiles themselves are never rescaled.


def sustained_input_tps(prof: PerfProfile, mean_prompt: float = 2200.0,
                        mean_out: float = 270.0) -> float:
    """θ_{i,k}: sustained input TPS per instance at target latency —
    decode-slot bound at near-full batch (the regime the §2.1 Q1–Q3
    serving numbers describe)."""
    per_req = mean_out * prof.decode_tbt(0.85)
    return prof.max_batch / per_req * mean_prompt
