"""A benchmark root of tiny cells for the CPU tests: a copy of ``bench/``
with one dense and one hybrid configuration a few dozen wide, a mix of
short requests, and their cells in a ``BENCHMARK.json`` of its own."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

DENSE = {"name": "tiny-dense", "family": "dense", "num_layers": 2,
         "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 200, "act": "gelu", "norm": "layernorm",
         "use_qkv_bias": True, "rope_theta": 100000.0, "norm_eps": 1e-06,
         "sliding_window": 0, "dtype": "bfloat16", "vocab_pad_multiple": 64}
HYBRID = {"name": "tiny-hybrid", "family": "hybrid", "num_layers": 3,
          "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "head_dim": 16,
          "d_ff": 128, "vocab_size": 200, "act": "silu", "norm": "rmsnorm",
          "use_qkv_bias": False, "rope_theta": 10000.0, "norm_eps": 1e-06,
          "sliding_window": 0, "ssm_state": 16, "ssm_headdim": 16,
          "ssm_expand": 2, "ssm_chunk": 16, "attn_every": 2,
          "dtype": "bfloat16", "vocab_pad_multiple": 64}
MIX = {"slots": 4,
       "prompt": {"median": 24, "sigma": 0.5, "min": 8, "max": 40},
       "output": {"median": 6, "sigma": 0.5, "min": 3, "max": 12},
       "iw": {"rate_per_s": 40.0, "iwf_share": 0.65,
              "deadline_steps": {"IW-F": 2, "IW-N": 20}},
       "niw": {"depth": 4},
       "warmup_steps": 3, "trace_steps": 2, "check_tokens": 30}


def make_root(tmp: Path, limit: float = 1.0) -> Path:
    """A root under ``tmp`` with cells ``tiny-dense.short`` and
    ``tiny-hybrid.short``, held to ``limit``."""
    root = tmp / "root"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    configs, workloads = [], []
    for m in (DENSE, HYBRID):
        cfg = {"model": m, "engine": {"max_seq": 64, "scheduler": "dpa",
                                      "kernels": []}}
        path = f"bench/configs/{m['name']}.json"
        (root / path).write_text(json.dumps(cfg))
        configs.append({"name": m["name"], "source": "tests",
                        "file": path, "reduced": [], "why": "tiny"})
        cell = f"{m['name']}.short"
        workloads.append({"name": cell, "config": m["name"],
                          "traffic": "short", "chips": 1, "why": "tiny"})
        (root / "bench" / "limits" / f"{cell}.json").write_text(
            json.dumps({"max_logit_gap": limit}))
    (root / "bench" / "traffic" / "short.json").write_text(json.dumps(MIX))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench.update(configs=configs, workloads=workloads)
    for mt in bench["end_to_end"] + bench["per_layer"]:
        mt.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
