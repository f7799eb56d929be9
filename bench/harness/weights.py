"""The served weights, made by the benchmark from the run's seed: one
buffer in the served dtype on the served device, filled by one
`torch.randn` call from a `torch.Generator` on that device, then scaled in
a few calls. Every leaf is a view of it, named as the program's module
names its parameters (`system.hand_over` checks the two lists agree), so
the program and the reference read the same bytes and nothing is copied.

Matrices are normal with std 1/sqrt(fan_in), fan_in being the input width
(d_model for the embedding and the output head, so that the embedded
tokens and the logits have unit scale), but the layers' output
projections (attention's wo, the MLP's wo) are drawn at OUT_GAIN times
that: the residual stream is then the layers' and not the token's own
embedding. With a plain draw a tied head (qwen3) puts the input token
first at nearly every position, greedy decoding repeats it, and neither
bf16 nor float8 moves a served token, so the comparison could not fail;
queries and keys drawn larger make attention sharp and the network
chaotic, where bf16 alone moves the tokens. Norm scales are drawn too, so
a path that ignored one would show: RMSNorm's (and qk-norm's: an offset
from 1) at std 0.1, LayerNorm's at 1 + N(0, 0.1).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

NORM_STD = 0.1
OUT_GAIN = 2.0
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def padded_vocab(m: Dict) -> int:
    """The embedding table's rows: the vocabulary padded to 256."""
    return -(-m["vocab_size"] // 256) * 256


def leaves(m: Dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(name, shape, std, shift) of every parameter of the dense decoder:
    the leaf is N(shift, std^2)."""
    d, h, hkv, hd, f = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                        m["head_dim"], m["d_ff"])
    V = padded_vocab(m)
    mat = lambda fan, gain=1.0: gain / math.sqrt(fan)    # noqa: E731
    # a norm's scale near its identity: RMSNorm's is an offset from 1
    norm = (NORM_STD, 1.0 if m["norm"] == "layernorm" else 0.0)
    out = [("embed.w", (V, d), mat(d), 0.0)]
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1.scale", (d,)) + norm, (p + "ln2.scale", (d,)) + norm,
                (p + "attn.wq", (d, h * hd), mat(d), 0.0),
                (p + "attn.wk", (d, hkv * hd), mat(d), 0.0),
                (p + "attn.wv", (d, hkv * hd), mat(d), 0.0),
                (p + "attn.wo", (h * hd, d), mat(h * hd, OUT_GAIN), 0.0)]
        if m.get("qk_norm"):
            out += [(p + "attn.q_scale", (hd,)) + norm,
                    (p + "attn.k_scale", (hd,)) + norm]
        out.append((p + "mlp.wi", (d, f), mat(d), 0.0))
        if m["gated_mlp"]:
            out.append((p + "mlp.wg", (d, f), mat(d), 0.0))
        out.append((p + "mlp.wo", (f, d), mat(f, OUT_GAIN), 0.0))
    out.append(("final_norm.scale", (d,)) + norm)
    if not m["tie_embeddings"]:
        out.append(("unembed.w", (d, V), mat(d), 0.0))
    return out


def make(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of run `seed`, as views of one buffer."""
    spec = sorted(leaves(m), key=lambda x: (x[2], x[3]))   # by distribution
    sizes = [math.prod(s) for _, s, _, _ in spec]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=DTYPES[m["dtype"]])
    out, at, group = {}, 0, {}
    for (name, shape, std, shift), n in zip(spec, sizes):
        out[name] = flat[at:at + n].view(shape)
        g = group.setdefault((std, shift), [at, at])
        g[1] = at + n
        at += n
    with torch.no_grad():
        for (std, shift), (a, b) in group.items():
            flat[a:b].mul_(std).add_(shift)
    return out
