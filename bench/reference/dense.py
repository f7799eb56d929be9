"""Plain float32 reference of the dense decoder block (qwen3-0.6b,
nemotron-4-15b): embedding, then per layer a norm, grouped-query attention
with rotary positions, the residual, a norm, the MLP and the residual; a
final norm and the output head. No kernel, no cache, no batching: one
sequence, layer by layer, each layer's weights cast to float32 as it runs
(the served dtype stays on the card), attention in blocks of queries so a
32k-token sequence fits. TF32 is switched off (`exact_matmuls`).

It reads the weights the benchmark made, by the names under which the
benchmark hands them to the program (`embed.w`, `blocks.{i}.attn.wq`, ...;
a projection is `x @ w`, w of shape (d_in, d_out)).

Departures from the published descriptions, kept because the served
program has them (the weights are random, so none is a question of
fidelity to trained checkpoints):

* the embedding is multiplied by sqrt(d_model) (neither Qwen3 nor
  Nemotron-4 scales it);
* RMSNorm multiplies by (1 + scale) (Qwen3 stores the factor itself; the
  same family of functions, parametrised from 1);
* Nemotron-4's LayerNorm has a scale and no bias, and its rotary embedding
  turns the whole head (partial rotary is not confirmed for the 15B model);
* rotary embeddings rotate split halves (as Hugging Face's `rotate_half`).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch

Cast = Callable[[str, torch.Tensor], torch.Tensor]
HEAD_CHUNK = 32768


def exact_matmuls():
    """float32 matrix products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _f32(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.float32)


def rmsnorm(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale)


def layernorm(x, scale, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale


def rope(x, pos, theta):
    """x (S, heads, D): rotate the split halves by pos * theta^(-2i/D)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, block: int):
    """Causal softmax attention, q (S, H, D), k and v (S, Hkv, D); query
    head h reads kv head h // (H / Hkv). Blocks of `block` queries."""
    S, H, D = q.shape
    hkv = k.shape[1]
    g = H // hkv
    out = torch.empty_like(q)
    kt = k.permute(1, 0, 2)                     # (Hkv, S, D)
    vt = v.permute(1, 0, 2)
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        qb = q[i0:i1].reshape(i1 - i0, hkv, g, D).permute(1, 2, 0, 3)
        s = torch.einsum("hgqd,hkd->hgqk", qb, kt[:, :i1]) / math.sqrt(D)
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        ki = torch.arange(i1, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, float("-inf"))
        p = torch.softmax(s, dim=-1)
        ob = torch.einsum("hgqk,hkd->hgqd", p, vt[:, :i1])
        out[i0:i1] = ob.permute(2, 0, 1, 3).reshape(i1 - i0, H, D)
    return out


ACT = {"silu": torch.nn.functional.silu,
       "squared_relu": lambda x: torch.relu(x).square(),
       "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh")}


def by_rows(fn, x, rows: int):
    """fn over blocks of `rows` rows of x (a row-wise function), into one
    output: the same numbers, a block's intermediates at a time."""
    first = fn(x[:rows])
    if x.shape[0] <= rows:
        return first
    out = x.new_empty((x.shape[0],) + first.shape[1:])
    out[:rows] = first
    for r0 in range(rows, x.shape[0], rows):
        out[r0:r0 + rows] = fn(x[r0:r0 + rows])
    return out


def logits_at(w: Dict[str, torch.Tensor], m: Dict, tokens: torch.Tensor,
              at: Sequence[int], device, cast: Optional[Cast] = None,
              cast_in: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
              block: int = 512, rows: int = 4096) -> torch.Tensor:
    """float32 logits over the true vocabulary at positions `at` of the
    sequence `tokens` (1-D), shape (len(at), vocab_size). `cast` is applied
    to every weight matrix as it is loaded, with its name, and `cast_in` to
    every matrix product's input rows (the control's lower precision).
    `block` queries attend at a time, and the row-wise parts run `rows`
    positions at a time."""
    cast = cast or (lambda name, t: t)
    cin = cast_in or (lambda t: t)
    mat = lambda name: cast(name, _f32(w[name], device))  # noqa: E731
    vec = lambda name: _f32(w[name], device)            # noqa: E731
    norm = rmsnorm if m["norm"] == "rmsnorm" else layernorm
    d, H, hkv, D = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    act = ACT[m["activation"]]
    tokens = tokens.to(device=device, dtype=torch.long)
    S = tokens.shape[0]
    pos = torch.arange(S, device=device)
    # the looked-up rows only (the control's scales are per row)
    h = cast("embed.w", _f32(w["embed.w"][tokens], device)) * math.sqrt(d)
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        x = cin(norm(h, vec(p + "ln1.scale")))
        q = (x @ mat(p + "attn.wq")).reshape(S, H, D)
        k = (x @ mat(p + "attn.wk")).reshape(S, hkv, D)
        v = (x @ mat(p + "attn.wv")).reshape(S, hkv, D)
        del x
        if m.get("qk_norm"):
            q = rmsnorm(q, vec(p + "attn.q_scale"))
            k = rmsnorm(k, vec(p + "attn.k_scale"))
        q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
        o = cin(attention(q, k, v, block).reshape(S, H * D))
        del q, k, v
        h = h + o @ mat(p + "attn.wo")
        del o
        ln2, wi, wo = vec(p + "ln2.scale"), mat(p + "mlp.wi"), mat(p + "mlp.wo")
        wg = mat(p + "mlp.wg") if m["gated_mlp"] else None

        def mlp(hb):
            x = cin(norm(hb, ln2))
            u = x @ wi
            u = act(x @ wg) * u if wg is not None else act(u)
            return cin(u) @ wo
        h = h + by_rows(mlp, h, rows)
        del ln2, wi, wo, wg
    hs = cin(norm(h[torch.as_tensor(list(at), device=device,
                                    dtype=torch.long)],
                  vec("final_norm.scale")))
    del h
    V = m["vocab_size"]
    out = torch.empty((hs.shape[0], V), device=device)
    for v0 in range(0, V, HEAD_CHUNK):      # the head a block of columns
        v1 = min(V, v0 + HEAD_CHUNK)        # at a time
        if m["tie_embeddings"]:
            wc = cast("embed.w", _f32(w["embed.w"][v0:v1], device)).T
        else:
            wc = cast("unembed.w", _f32(w["unembed.w"][:, v0:v1], device))
        out[:, v0:v1] = hs @ wc
    return out


def fp8_cast(name: str, t: torch.Tensor) -> torch.Tensor:
    """The control's weights: float8 e4m3 with one scale per output
    column (per row of the embedding table, whose rows are the output
    head's columns), dequantized to float32."""
    dim = 1 if name == "embed.w" else 0
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_rows(t: torch.Tensor) -> torch.Tensor:
    """The control's matrix-product inputs: float8 e4m3 with one scale per
    row (per token), dequantized to float32."""
    amax = t.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
