"""Whole runs of tiny cells on the CPU: found by name from files alone,
correct when sound, and not correct under each fault a serving cell can
have, or with the fp8 control in the program's place."""
import itertools
import json
import time

import pytest
import torch

from bench.harness import check, runner, spec
from bench.tests.tiny import MIX, make_root

torch.set_num_threads(1)

#: the tiny cells' limit: sound runs read at most 0.023 on seeds 1-6, the
#: fp8 control at least 0.067 (under ``steps``' clock)
LIMIT = 0.05
CELLS = ["tiny-dense.short", "tiny-hybrid.short"]


def steps():
    """A clock that advances a millisecond a reading: a run's steps do
    not depend on how fast the host is."""
    c = itertools.count()
    return lambda: next(c) * 1e-3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"), limit=LIMIT)


def run(root, cell, seed=1, trace=False, control=False):
    c = spec.load_cell(root, cell)
    return runner.execute(root, c, seed, 1.0, trace, "cpu",
                          time.perf_counter(), control=control,
                          clock=steps())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = run(root, cell)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"itl_p95_ms", "output_tokens_per_s",
                                   "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "check"
    assert out["check"]["tokens_compared"] >= MIX["check_tokens"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_interactive_tail_per_layer(root, cell):
    """The IW first-token tail is read in the traced run, beside the
    admission wait, and in no run without a trace."""
    out = run(root, cell, trace=True)
    assert out["correct"], out["check"]
    tail = out["metrics"]["iw_ttft_p95_ms.admission"]["value"]
    wait = out["metrics"]["iw_queue_wait_p50_ms"]["value"]
    assert tail > 0 and wait >= 0 and tail >= wait
    assert "itl_p95_ms" not in out["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_three_seeds(root, cell):
    """The reference at fp8 in the program's place reads above the limit
    on every seed, where the program reads within it."""
    for seed in (1, 2, 3):
        out = run(root, cell, seed=seed, control=True)
        assert out["check"]["max_logit_gap"]["value"] <= LIMIT
        assert out["check"]["control_gap"] > LIMIT


def _state_unchanged(monkeypatch):
    from repro_torch.models import model as model_mod
    real = model_mod.decode_step

    def decode(cfg, params, tokens, cache, cur_pos, **kw):
        saved = {k: {n: t.clone() for n, t in v.items()}
                 for k, v in cache.items()}
        logits, _ = real(cfg, params, tokens, cache, cur_pos, **kw)
        for k, v in saved.items():
            for n, t in v.items():
                cache[k][n].copy_(t)
        return logits, cache
    monkeypatch.setattr(model_mod, "decode_step", decode)


def _half_batch(monkeypatch):
    from repro_torch.models import model as model_mod
    real = model_mod.decode_step

    def decode(cfg, params, tokens, cache, cur_pos, **kw):
        logits, cache = real(cfg, params, tokens, cache, cur_pos, **kw)
        half = logits.shape[0] // 2
        return torch.cat([logits[:half], logits[:logits.shape[0] - half]]), \
            cache
    monkeypatch.setattr(model_mod, "decode_step", decode)


def _token_altered(monkeypatch):
    from repro_torch.models import model as model_mod
    real = model_mod.decode_step

    def decode(cfg, params, tokens, cache, cur_pos, **kw):
        logits, cache = real(cfg, params, tokens, cache, cur_pos, **kw)
        return torch.roll(logits, 1, dims=-1), cache
    monkeypatch.setattr(model_mod, "decode_step", decode)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered],
                         ids=["state_unchanged", "half_batch",
                              "token_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(root, cell, fault,
                                                  monkeypatch):
    fault(monkeypatch)
    out = run(root, cell)
    assert not out["correct"], out["check"]


def test_a_cell_mix_and_metric_added_as_files_are_found(root, tmp_path):
    """A new mix, a new cell of it and a new per-layer metric: files added,
    none edited, and the run reports the metric."""
    import shutil
    new = tmp_path / "root"
    shutil.copytree(root, new)
    mix = dict(MIX, slots=2)
    (new / "bench" / "traffic" / "pairs.json").write_text(json.dumps(mix))
    (new / "bench" / "limits" / "tiny-dense.pairs.json").write_text(
        json.dumps({"max_logit_gap": LIMIT}))
    (new / "bench" / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return float(len(run.window.steps))\n")
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-dense.pairs",
                               "config": "tiny-dense", "traffic": "pairs",
                               "chips": 1, "why": "two slots"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine admission",
                               "moves": "output_tokens_per_s",
                               "workloads": ["tiny-dense.pairs"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(new, "tiny-dense.pairs")
    assert cell.mix["slots"] == 2
    assert "steps_in_window" in [m["name"] for m in cell.per_layer]
    assert "steps_in_window" not in [
        m["name"] for m in spec.load_cell(new, "tiny-dense.short").per_layer]
    out = runner.execute(new, cell, 1, 1.0, True, "cpu",
                         time.perf_counter(), clock=steps())
    assert out["metrics"]["steps_in_window"]["value"] > 0
    assert out["correct"]


def test_sample_takes_the_longest_and_enough_tokens():
    import numpy as np
    served = [check.Served(np.arange(3), [1] * n) for n in (2, 9, 3, 4, 5)]
    s = check.sample(served, 7, 12)
    assert s[0] is served[1]
    assert sum(len(x.tokens) for x in s) >= 12
    assert check.sample(served, 7, 12) == s
    assert check.sample([], 7, 12) == []


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["starcoder2-7b.repo-completion",
                                  "zamba2-7b.long-doc",
                                  "starcoder2-7b.long-context"])
def test_cell_on_the_card(card, cell):
    """A short run of each cell of BENCHMARK.json on the card."""
    import subprocess
    import sys
    from bench.tests.tiny import BENCH
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", cell, "--seed", "2147483711",
                          "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, timeout=900,
                         cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
