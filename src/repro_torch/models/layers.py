"""Shared primitive layers: norms, activations, the MLP, RoPE, embeddings.

Each layer with weights is an `nn.Module` holding its parameters in the JAX
package's layouts (a projection is `x @ w` with w of shape (d_in, d_out)),
and the math is a plain function over tensors, so converted weights drop in
leaf by leaf. Details that a stock torch module gets wrong are kept: RMSNorm
scales by (1 + scale), LayerNorm has a scale and no bias and runs in fp32
(OLMo's `nonparametric_ln` has neither), gelu is the tanh approximation
(`jax.nn.gelu`'s default, not torch's), RoPE rotates split halves, and the
embedding multiplies by sqrt(d_model) (for every family) while the
unembedding does not.
Only what the ported configurations use is here (`transformer.check_ported`
names the rest).
"""
from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F
from torch import nn


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised serving parameter (no autograd)."""
    return nn.Parameter(torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                                    device=device), requires_grad=False)


def _leaf_seed(seed: int, name: str) -> int:
    """A per-leaf seed from the leaf's name: adding or removing a parameter
    never reshuffles the others, and the seed is the same in every process
    (unlike Python's salted `hash`)."""
    h = hashlib.blake2b(f"{seed}:{name}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


@torch.no_grad()
def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Fan-in-scaled normal init, in place, the JAX package's scheme: scales
    at ones, biases at zeros, every other leaf normal with std
    1/sqrt(fan_in) (fan_in = shape[-2], or shape[-1] for a vector), drawn in
    float32 from an explicit per-leaf `torch.Generator` on the parameter's
    device and cast to its dtype."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() == 0:
            p.zero_()
        elif leaf.startswith(("ln", "norm", "scale")) or leaf.endswith("scale"):
            p.fill_(1.0)
        elif leaf in ("bias", "b") or leaf.endswith("_bias"):
            p.zero_()
        else:
            fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
            gen = torch.Generator(device=p.device)
            gen.manual_seed(_leaf_seed(seed, name))
            w = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                            device=p.device)
            p.copy_(w * (1.0 / math.sqrt(max(fan_in, 1))))
    return module


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x, scale, eps: float = 1e-5):
    """Scale-only LayerNorm (no scale either when `scale` is None),
    computed in fp32 and cast back."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x if scale is None else x * scale.float()).to(dt)


def nonparametric_ln(x, eps: float = 1e-5):
    """OLMo's LayerNorm without a learned scale or bias."""
    return layernorm(x, None, eps)


class RMSNorm(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.scale = param((cfg.d_model,), cfg.torch_dtype, device)

    def forward(self, x):
        return rmsnorm(x, self.scale)


class LayerNorm(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.scale = param((cfg.d_model,), cfg.torch_dtype, device)

    def forward(self, x):
        return layernorm(x, self.scale)


class NonparametricLN(nn.Module):
    """A norm with no parameter (the reference's `norm_skeleton` is {})."""

    def __init__(self, cfg, device):
        super().__init__()

    def forward(self, x):
        return nonparametric_ln(x)


def make_norm(cfg, device) -> nn.Module:
    """The reference's `apply_norm` dispatch, as a module per cfg.norm."""
    return {"rmsnorm": RMSNorm, "layernorm": LayerNorm,
            "nonparametric_ln": NonparametricLN}[cfg.norm](cfg, device)


# --------------------------------------------------------------------------- #
# Activations / gated MLP
# --------------------------------------------------------------------------- #
def gelu(x):
    """`jax.nn.gelu` with its default approximate=True: the tanh form."""
    return F.gelu(x, approximate="tanh")


def squared_relu(x):
    r = F.relu(x)
    return r * r


ACTIVATIONS = {"silu": F.silu, "gelu": gelu, "squared_relu": squared_relu}


class MLP(nn.Module):
    """wi, wo, and wg when cfg.gated_mlp; hidden width `d_ff` (default
    cfg.d_ff; a MoE's shared experts pass n_shared_experts x d_ff)."""

    def __init__(self, cfg, device, d_ff=None):
        super().__init__()
        d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.torch_dtype
        self.wi = param((d, f), dt, device)
        if cfg.gated_mlp:
            self.wg = param((d, f), dt, device)
        self.wo = param((f, d), dt, device)


def apply_mlp(mlp: MLP, cfg, x):
    """Gated: act(x @ wg) * (x @ wi) @ wo; not gated: act(x @ wi) @ wo; act
    per cfg.activation."""
    act = ACTIVATIONS[cfg.activation]
    h = x @ mlp.wi
    h = act(x @ mlp.wg) * h if cfg.gated_mlp else act(h)
    return h @ mlp.wo


# --------------------------------------------------------------------------- #
# Rotary embeddings
# --------------------------------------------------------------------------- #
def rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D) or (B, S, D); positions: (S,) int."""
    dim = x.shape[-1]
    inv = rope_freqs(dim, theta, x.device)  # (D/2,)
    ang = positions.to(device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == 4:  # head axis present: (S, 1, D/2) broadcasts over B, H
        cos, sin = cos[:, None, :], sin[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, dtype, device=None):
    """Whisper-style fixed sinusoidal embeddings (seq, dim): row p is
    [sin(p * inv), cos(p * inv)] with inv = exp(-(0, 2, ..) / dim *
    ln 10000), computed in fp32 and cast to `dtype`."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim * math.log(10000.0))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# --------------------------------------------------------------------------- #
# Embedding / unembedding
# --------------------------------------------------------------------------- #
def embed(w, cfg, tokens):
    return F.embedding(tokens, w) * math.sqrt(cfg.d_model)


def unembed(embed_w, h, unembed_w=None):
    """Tied (unembed_w None: the embedding table, without the sqrt(d)
    scale) or untied (unembed_w (d_model, padded_vocab)) unembedding."""
    if unembed_w is None:
        return h @ embed_w.T
    return h @ unembed_w


__all__ = ["param", "init_params", "rmsnorm", "layernorm", "nonparametric_ln",
           "RMSNorm", "LayerNorm", "NonparametricLN", "make_norm", "gelu",
           "squared_relu", "ACTIVATIONS", "MLP", "apply_mlp", "rope_freqs",
           "apply_rope", "sinusoidal_positions", "embed", "unembed"]
