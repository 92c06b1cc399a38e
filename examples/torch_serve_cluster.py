"""End-to-end serving on the PyTorch port: a real model instance behind the
SageServe scheduling stack.

Counterpart of ``examples/serve_cluster.py`` on ``repro_torch``.  A
reduced StarCoder2 instance (actual forward passes through the port's
kernels on CUDA, continuous batching, DPA scheduling) serves a batched
mixed IW-F/IW-N/NIW request stream; NIW requests flow through the Queue
Manager and are drip-fed on capacity signals — the single-instance
slice of the full SageServe stack running on live compute rather than
the simulator's perf model.  Weights are random, from a seeded
``torch.Generator``.

    PYTHONPATH=src python examples/torch_serve_cluster.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api import PolicySpec, resolve
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.dist.sharding import unbox
from repro_torch.models import model
from repro_torch.serving.engine import ServeRequest, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduce_for_smoke(get_arch("starcoder2-7b"))
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    leaves = unbox(params)
    print(f"model: {cfg.name} (reduced) on {dev}, {len(leaves)} parameter "
          f"leaves under the reference's keys, "
          f"{sum(t.numel() for t in leaves.values()):,} parameters")
    # scheduler and queue manager come from the same registry the
    # simulator uses — the real-model path shares the control-plane API
    eng = ServingEngine(cfg, params, max_batch=4, max_seq=128,
                        scheduler="dpa", device=dev)
    qm = resolve("queue", PolicySpec("niw", {"one_thresh": 0.99,
                                             "two_thresh": 0.6}))
    rng = np.random.default_rng(0)

    # 9 interactive + 6 NIW requests
    iw, niw = [], []
    for i in range(9):
        tier = "IW-F" if i % 3 == 0 else "IW-N"
        r = ServeRequest(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, int(rng.integers(8, 24))).astype(np.int32),
            max_new_tokens=12, tier=tier, arrival=float(i),
            ttft_deadline=i + (3.0 if tier == "IW-F" else 30.0))
        iw.append(r)
    # ServeRequest satisfies the shared RequestLike shape, so the NIW
    # queue manager handles engine requests exactly like simulator ones
    for i in range(9, 15):
        r = ServeRequest(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 16).astype(np.int32),
            max_new_tokens=12, model="starcoder2-7b", tier="NIW",
            arrival=float(i), ttft_deadline=i + 24 * 3600.0)
        niw.append(r)
        qm.submit(r)

    for r in iw:
        eng.submit(r)
    # engine loop with queue-manager capacity signals
    with torch.inference_mode():
        while eng.has_work or qm.depth() > 0:
            util = eng.active / eng.max_batch
            for released in qm.on_capacity_signal(
                    "starcoder2-7b", "local", util, float(eng.step_count)):
                eng.submit(released)
            eng.step()
            if eng.step_count > 2000:
                raise RuntimeError("engine did not drain")

    done = iw + niw
    if any(r.done_step is None for r in done):
        raise RuntimeError("some requests did not finish")
    print(f"served {len(done)} requests ({len(iw)} IW / {len(niw)} NIW) "
          f"in {eng.step_count} engine steps")
    for r in done:
        print(f"  req {r.rid:2d} [{r.tier:4s}] ttft_step={r.ttft_step:4d} "
              f"done={r.done_step:4d} tokens={len(r.tokens)}")
    iwf_ttft = max(r.ttft_step - int(r.arrival) for r in iw
                   if r.tier == "IW-F")
    print(f"IW-F worst queueing (steps): {iwf_ttft} — DPA kept fast-tier "
          f"ahead while NIW back-filled spare slots")


if __name__ == "__main__":
    main()
