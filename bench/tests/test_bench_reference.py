"""The plain references on small hand-checked cases, and against the
port at a tiny float32 size (the test may import both; the references
themselves import nothing of the port)."""
import math

import pytest
import torch

from bench.families import dense as dense_family
from bench.families import hybrid as hybrid_family
from bench.harness import weights
from bench.reference import dense, hybrid, precision
from bench.tests.tiny import DENSE, HYBRID

torch.set_num_threads(1)


def test_rope_by_hand():
    x = torch.randn(3, 2, 4)
    y = dense.rope(x, 10000.0)
    assert torch.equal(y[0], x[0])                 # position 0: no turn
    # position 1, first pair of halves: angle 1 rad (freq 1)
    c, s = math.cos(1.0), math.sin(1.0)
    assert y[1, 0, 0] == pytest.approx(float(x[1, 0, 0] * c - x[1, 0, 2] * s),
                                       abs=1e-6)
    assert y[1, 0, 2] == pytest.approx(float(x[1, 0, 0] * s + x[1, 0, 2] * c),
                                       abs=1e-6)


def test_attention_by_hand():
    """Two positions, one head of width 2, identity projections: the first
    attends to itself, the second softmax-weights both values by its
    scores against the keys, turned by RoPE (one pair: 1 rad a
    position)."""
    m = {"num_heads": 1, "num_kv_heads": 1, "head_dim": 2, "rope_theta": 1e4}
    eye = torch.eye(2)
    lw = {"wq": eye, "wk": eye, "wv": eye, "wo": eye}
    h = torch.tensor([[1.0, 0.0], [0.0, 2.0]])
    out = dense.attention(h, lw, m, precision.exact)
    assert torch.allclose(out[0], h[0])
    # q at position 1 is [0, 2] turned by 1 rad: [-2 sin 1, 2 cos 1]; its
    # scores: against k0 = [1, 0] (not turned), against itself 4
    p = torch.softmax(torch.tensor([-2 * math.sin(1.0), 4.0]) / math.sqrt(2),
                      0)
    assert torch.allclose(out[1], p[0] * h[0] + p[1] * h[1], atol=1e-6)


def test_ssd_chunks_equal_the_recurrence():
    g = torch.Generator().manual_seed(0)
    L, H, P, N = 300, 3, 2, 4
    x = torch.randn(L, H, P, generator=g)
    dt = torch.rand(L, H, generator=g) * 0.1
    A = -torch.arange(1, H + 1, dtype=torch.float32)
    B = torch.randn(L, N, generator=g)
    C = torch.randn(L, N, generator=g)
    y = hybrid.ssd(x, dt, A, B, C)
    h = torch.zeros(H, P, N)
    for t in range(L):
        h = h * torch.exp(dt[t] * A)[:, None, None] \
            + dt[t][:, None, None] * x[t][:, :, None] * B[t][None, None, :]
        assert torch.allclose(y[t], h @ C[t], atol=1e-4, rtol=1e-4)


def test_fp8_rounds_each_slice_to_e4m3():
    t = torch.tensor([[448.0, 1.0, 0.3], [2.0, -1.0, 0.0]])
    r = precision.round_e4m3(t, -1)
    assert r[0, 0] == 448.0 and r[0, 1] == 1.0
    assert r[0, 2] != 0.3 and abs(float(r[0, 2]) - 0.3) < 0.3 / 8
    assert torch.equal(r[1], t[1])      # exact in e4m3 at scale 2/448
    assert torch.allclose(precision.exact(t, t.T), t @ t.T)


@pytest.mark.parametrize("m", [DENSE, HYBRID], ids=["dense", "hybrid"])
def test_reference_agrees_with_the_port_in_float32(m):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as model_mod

    m = dict(m, dtype="float32")
    cfg = ModelConfig(**m)
    module = model_mod.module(cfg, "meta")
    leaves = (dense_family if m["family"] == "dense" else hybrid_family).leaves
    w = weights.make(leaves(m), 5, "cpu")
    weights.load(module, w)
    tokens = torch.randint(0, m["vocab_size"], (1, 40),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        port, _, _ = model_mod.forward(cfg, module, {"tokens": tokens})
    family = dense if m["family"] == "dense" else hybrid
    ref = family.forward(w, m, [tokens[0]], [0], precision.exact)[0]
    assert torch.allclose(ref, port[0].float(), atol=2e-4, rtol=2e-4)


def test_weights_are_seeded_and_shaped_from_the_config():
    a = weights.make(dense_family.leaves(DENSE), 3, "cpu")
    b = weights.make(dense_family.leaves(DENSE), 3, "cpu")
    c = weights.make(dense_family.leaves(DENSE), 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.head"], c["embed.head"])
    assert a["embed.tok"].shape == (256, 64)          # 200 padded to 64s
    assert a["dense_layers.1.attn.wk"].shape == (64, 32)
    h = weights.make(hybrid_family.leaves(HYBRID), 3, "cpu")
    assert torch.allclose(h["layers.0.mixer.A_log"],
                          torch.log(torch.arange(1.0, 9.0)))
    dt = torch.nn.functional.softplus(h["layers.0.mixer.dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-6 and float(dt.max()) <= 0.1 + 1e-6


def test_load_refuses_another_tree():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as model_mod

    module = model_mod.module(ModelConfig(**DENSE), "meta")
    with pytest.raises(ValueError):
        weights.load(module, weights.make(
            dense_family.leaves(dict(DENSE, d_ff=64)), 0, "cpu"))
