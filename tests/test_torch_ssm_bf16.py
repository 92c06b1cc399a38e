"""bf16 decode drift of the SSM and hybrid families, the port against the JAX package.

On one set of weights, in bf16, a seeded prompt of 64 tokens is
prefilled and 8 more tokens are decoded one step at a time; the last
decode step's logits are compared with a full forward over all 72
tokens (relative L2).  Both packages do this on the same weights
(``unbox`` -> numpy -> torch), and the port's gap must lie within twice
the reference's, plus 1e-3.  So the port's bf16 decode drifts from its
own full forward no further than the reference's drifts from its own.

Measured gaps (port / reference) on the reduced configs of
``reduce_for_smoke``: mamba2-370m 1.331e-2 / 1.365e-2; zamba2-7b
1.380e-2 / 1.402e-2; the 5-layer hybrid 2.316e-2 / 2.521e-2.  In fp32
the port's decode agrees with its full forward within 1e-3
(``tests/test_torch_model.py::test_ssm_decode_matches_full_forward``):
the bf16 drift is rounding, the reference's own behaviour, which the
port repeats.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduce_for_smoke as jreduce
from repro.dist.sharding import unbox
from repro.models import model as jmodel
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.models import model
from repro_torch.models.convert import params_from_reference
from repro_torch.serving.engine import _write_slot

#: reduced SSM (Mamba2) and hybrid (Zamba2) configs, as
#: ``tests/test_torch_model.py`` builds them
ARCHS = {"mamba2-370m": ("mamba2-370m", {}),
         "zamba2-7b": ("zamba2-7b", {}),
         "zamba2-7b-l5": ("zamba2-7b", dict(num_layers=5, attn_every=2))}
PROMPT, STEPS = 64, 8
#: the port's gap may be at most RATIO x the reference's + SLACK
RATIO, SLACK = 2.0, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want) -> float:
    got, want = (np.asarray(x, np.float32).ravel() for x in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def reference_gap(jcfg, tree, toks) -> float:
    n = toks.shape[1]
    full, _, _ = jmodel.forward(jcfg, tree, {"tokens": jnp.asarray(toks)})
    _, pre, _ = jmodel.forward(jcfg, tree,
                               {"tokens": jnp.asarray(toks[:, :PROMPT])},
                               return_cache=True)
    cache = jmodel.merge_prefill_cache(jmodel.init_decode_cache(jcfg, 1, n),
                                       pre)
    for t in range(PROMPT, n):
        logits, cache = jmodel.decode_step(
            jcfg, tree, jnp.asarray(toks[:, t:t + 1]), cache,
            jnp.asarray([t], jnp.int32))
    return rel_l2(logits[0, 0].astype(jnp.float32),
                  full[0, -1].astype(jnp.float32))


def port_gap(cfg, lm, toks) -> float:
    n = toks.shape[1]
    toks = torch.from_numpy(toks)
    with torch.no_grad():
        full, _, _ = model.forward(cfg, lm, {"tokens": toks})
        _, pre, _ = model.forward(cfg, lm, {"tokens": toks[:, :PROMPT]},
                                  return_cache=True)
        cache = model.init_decode_cache(cfg, 1, n, device="cpu")
        _write_slot(cache, pre, 0)
        for t in range(PROMPT, n):
            logits, cache = model.decode_step(
                cfg, lm, toks[:, t:t + 1], cache,
                torch.tensor([t], dtype=torch.int32))
    return rel_l2(logits[0, 0].float(), full[0, -1].float())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_bf16_decode_drift_is_the_references(arch):
    base, kw = ARCHS[arch]
    kw = dict(kw, dtype="bfloat16")
    jcfg = dataclasses.replace(jreduce(jget_arch(base)), **kw)
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(base)), **kw)
    tree = jax.tree.map(np.asarray,
                        unbox(jmodel.init(jcfg, jax.random.PRNGKey(0))))
    lm = params_from_reference(cfg, tree, "cpu")
    toks = np.random.default_rng(17).integers(
        0, cfg.vocab_size, (1, PROMPT + STEPS)).astype(np.int32)
    want = reference_gap(jcfg, tree, toks)
    got = port_gap(cfg, lm, toks)
    print(f"{arch}: bf16 decode vs full forward, rel L2: port {got:.3e}, "
          f"reference {want:.3e}")
    assert np.isfinite(got) and np.isfinite(want)
    assert got <= RATIO * want + SLACK, (got, want)
