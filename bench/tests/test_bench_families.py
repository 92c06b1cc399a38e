"""The family modules (``bench/families/``): the readings of the cells
already measured held to exact literals, no harness file or metric
reader that branches on a family's name, and a new family entered as
files alone."""
import ast
import hashlib
import importlib.util
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from bench.harness import runner, spec
from bench.tests.tiny import BENCH, MIX, make_root

torch.set_num_threads(1)

ROOT = BENCH.parent
PROMPTS = [1, 64, 1339, 2048, 3584]
CONTEXTS = [0, 5, 1999, 3000, 4094]

#: each cell's leaves, model FLOPs and K1/K2 work as the harness counted
#: them before the family modules (the sha256 is of the JSON list of
#: [name, shape, dtype, init] in draw order); equal, not close
PINNED = {
    "starcoder2-7b.repo-completion": {
        "leaves": 420,
        "leaves_sha256": "8eb61b82607e0c9efaa7a71f61a5e575"
                         "de299421673f909e878e5c2374691531",
        "matmul_weights": 7172259840,
        "step_flops": 106562281144320,
        "k1_work": (5403967488, 639370496),
        "k2_work": [(589824, 655616), (1226833920, 41959424),
                    (529148805120, 877869824), (1237554561024, 1342701568),
                    (3789218119680, 2349727744)]},
    "zamba2-7b.long-doc": {
        "leaves": 741,
        "leaves_sha256": "8babaa546f8a3357ab4ca1a847340c38"
                         "289be6c5b720d389467482a593af917f",
        "matmul_weights": 9305268224,
        "step_flops": 132929588420608,
        "k1_work": (1835638784, 1845787440),
        "k2_work": [(200704, 401520), (417464320, 25697280),
                    (180057579520, 537635280), (421112315904, 822312960),
                    (1289386721280, 1439047680)]},
    "starcoder2-7b.long-context": {
        "leaves": 420,
        "leaves_sha256": "8eb61b82607e0c9efaa7a71f61a5e575"
                         "de299421673f909e878e5c2374691531",
        "matmul_weights": 7172259840,
        "step_flops": 106562281144320,
        "k1_work": (5441716224, 681329920),
        "k2_work": [(589824, 655616), (1226833920, 41959424),
                    (529148805120, 877869824), (1237554561024, 1342701568),
                    (3789218119680, 2349727744)]},
}


def mfu():
    path = BENCH / "metrics" / "mfu.py"
    s = importlib.util.spec_from_file_location("pinned_mfu", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


@pytest.fixture(params=sorted(PINNED))
def cell(request):
    return spec.load_cell(ROOT, request.param)


def test_leaves_are_pinned(cell):
    m = cell.config["model"]
    leaves = cell.family.leaves(m)
    canon = json.dumps([[n, list(s), d, k] for n, s, d, k in leaves])
    want = PINNED[cell.name]
    assert len(leaves) == want["leaves"]
    assert hashlib.sha256(canon.encode()).hexdigest() == want["leaves_sha256"]


def test_model_flops_are_pinned(cell):
    m = cell.config["model"]
    want = PINNED[cell.name]
    assert cell.family.matmul_weights(m) == want["matmul_weights"]
    assert mfu().step_flops(cell.family, m, PROMPTS, CONTEXTS) \
        == want["step_flops"]


def test_attention_kernel_work_is_pinned(cell):
    m = cell.config["model"]
    want = PINNED[cell.name]
    assert cell.family.k1_work(m, CONTEXTS, cell.mix["slots"]) \
        == want["k1_work"]
    assert [cell.family.k2_work(m, S) for S in PROMPTS] == want["k2_work"]


def _names_family(node) -> bool:
    if isinstance(node, ast.Name):
        return node.id == "family"
    if isinstance(node, ast.Attribute):
        return node.attr == "family"
    return isinstance(node, ast.Subscript) \
        and isinstance(node.slice, ast.Constant) \
        and node.slice.value == "family"


def _is_name(node) -> bool:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return any(_is_name(e) for e in node.elts)
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


@pytest.mark.parametrize("folder", ["harness", "metrics"])
def test_no_harness_file_branches_on_a_family_name(folder):
    for path in sorted((BENCH / folder).glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Compare):
                sides = [node.left] + node.comparators
                assert not (any(map(_names_family, sides))
                            and any(map(_is_name, sides))), \
                    (path.name, node.lineno)


SSM = {"name": "tiny-ssm", "family": "ssm", "num_layers": 3, "d_model": 64,
       "num_heads": 0, "num_kv_heads": 0, "head_dim": 0, "d_ff": 0,
       "vocab_size": 200, "act": "silu", "norm": "rmsnorm",
       "use_qkv_bias": False, "norm_eps": 1e-06, "ssm_state": 16,
       "ssm_headdim": 16, "ssm_expand": 2, "ssm_chunk": 16,
       "dtype": "bfloat16", "vocab_pad_multiple": 64}

SSM_FAMILY = '''"""The port's pure Mamba2 family: the hybrid family's Mamba2 layers,
no attention."""
from bench.families import dense, hybrid
from bench.harness.weights import embedding

config = dense.config


def leaves(m):
    out = embedding(m)
    for i in range(m["num_layers"]):
        out += hybrid.ssm_layer(f"layers.{i}", m)
    return out


def attention_layers(m):
    return 0


def matmul_weights(m):
    return m["num_layers"] * hybrid.ssm_weights(m) + dense.head_weights(m)


def prefill_attention_flops(m, S):
    return 0


def decode_attention_flops(m, cur):
    return 0


def k1_work(m, contexts, slots):
    return 0, 0


def k2_work(m, S):
    return 0, 0
'''

SSM_REFERENCE = '''"""Plain float32 reference of the pure Mamba2 family."""
import torch

from bench.reference.dense import embed, head, norm, sub
from bench.reference.hybrid import mixer


@torch.no_grad()
def forward(w, m, seqs, firsts, mm):
    xs = embed(w, seqs)
    for i in range(m["num_layers"]):
        lw = sub(w, f"layers.{i}.mixer")
        xs = [x + mixer(norm(x, w, f"layers.{i}.norm", m), lw, m, mm)
              for x in xs]
    return head(w, xs, firsts, m, mm)
'''


def _files(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _add_cell(root, model, files=()):
    """Add ``model``'s configuration, a cell of it on the tiny mix and
    ``files`` (path, text) to ``root``: files, and entries appended to
    its BENCHMARK.json."""
    for path, text in files:
        (root / path).write_text(text)
    path = f"bench/configs/{model['name']}.json"
    (root / path).write_text(json.dumps(
        {"model": model, "engine": {"max_seq": 64, "scheduler": "dpa",
                                    "kernels": []}}))
    name = f"{model['name']}.short"
    (root / "bench" / "limits" / f"{name}.json").write_text(
        json.dumps({"max_logit_gap": 0.05}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": model["name"], "source": "tests",
                             "file": path, "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": name, "config": model["name"],
                               "traffic": "short", "chips": 1,
                               "why": "tiny"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


def test_a_family_added_as_files_runs_correct(tmp_path):
    """A third family (the port's pure Mamba2 one, built from the hybrid
    family's pieces) enters as its family module, its reference, its
    config, limits and entries: its cell runs correct, traced, and no
    file that was there changed but BENCHMARK.json, which only grew."""
    root = make_root(tmp_path)
    before = _files(root)
    old = json.loads((root / "BENCHMARK.json").read_text())
    name = _add_cell(root, SSM, [("bench/families/ssm.py", SSM_FAMILY),
                                 ("bench/reference/ssm.py", SSM_REFERENCE)])
    c = spec.load_cell(root, name)
    ticks = iter(range(10**9))
    out = runner.execute(root, c, 1, 1.0, True, "cpu", time.perf_counter(),
                         clock=lambda: next(ticks) * 1e-3)
    assert out["correct"], out["check"]
    assert out["check"]["tokens_compared"] >= MIX["check_tokens"]
    assert out["metrics"]["mfu"]["value"] > 0
    assert "k1_roofline" not in out["metrics"]
    after = _files(root)
    changed = [p for p, h in before.items() if after[p] != h]
    assert changed == [Path("BENCHMARK.json")]
    new = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads"):
        assert new[key][:len(old[key])] == old[key]
    assert {k: v for k, v in new.items() if k not in ("configs",
                                                      "workloads")} \
        == {k: v for k, v in old.items() if k not in ("configs",
                                                      "workloads")}


def test_an_unknown_family_names_the_files_to_add(tmp_path):
    root = make_root(tmp_path)
    name = _add_cell(root, dict(SSM, name="tiny-rwkv", family="rwkv"))
    with pytest.raises(LookupError) as err:
        spec.load_cell(root, name)
    assert "bench/families/rwkv.py" in str(err.value)
    assert "bench/reference/rwkv.py" in str(err.value)
    shutil.rmtree(root)
