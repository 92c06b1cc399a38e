"""mfu: the model FLOPs of the window's steps over the window's wall time
at the card's bf16 peak (%), host clock: no profiler runs in the window.

Model FLOPs: 2 x the weights each token is multiplied by x the tokens
(every prompt token of each admitted prefill, the head included, and
one token for each active slot's decode; idle slots count nothing),
plus attention: 2 H hd S (S + 1) for a causal prefill of S tokens and
4 H hd (cur + 1) for a decode at position cur, per attention
application.  The Mamba2 scan's own products are left out, so for a
hybrid model this counts low.
"""
from bench.harness import peaks, shapes


def matmul_weights(m):
    """Weights a token is multiplied by: projections, MLPs and the head."""
    d, H, Hkv, hd, f = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                        m["head_dim"], m["d_ff"])
    attn = 2 * d * H * hd + 2 * d * Hkv * hd
    mlp = (3 if m["act"] in ("silu", "geglu") else 2) * d * f
    head = d * shapes.padded_vocab(m)
    if m["family"] == "hybrid":
        di, N, Hs, _ = shapes.ssm_dims(m)
        ssm = d * (2 * di + 2 * N + Hs) + di * d
        return (m["num_layers"] * ssm
                + shapes.attention_layers(m) * (attn + mlp) + head)
    return m["num_layers"] * (attn + mlp) + head


def step_flops(m, prompts, contexts):
    w = matmul_weights(m)
    H, hd = m["num_heads"], m["head_dim"]
    n = shapes.attention_layers(m)
    flops = sum(2 * w * S + n * 2 * H * hd * S * (S + 1) for S in prompts)
    flops += sum(2 * w + n * 4 * H * hd * (c + 1) for c in contexts)
    return flops


def read(run):
    w = run.window
    if not w.steps or w.t_end <= w.t0:
        return None
    flops = sum(step_flops(run.model, s.prompts, s.contexts)
                for s in w.steps)
    return 100.0 * flops / ((w.t_end - w.t0) * peaks.BF16_FLOPS)
