"""Mixture-of-Experts with the JAX package's grouped-capacity dispatch
(`src/repro/models/moe.py`), step for step.

Tokens are cut into groups of `min(1024, B·S)` (the last one padded). In each
group a float32 router picks every token's top-K experts, the gates are
renormalised, and each (token, k) takes the next free place of its expert's
queue, in token-major, k-minor order; a place at or past the capacity `cap =
ceil(n·K·cf / E)` is dropped (the residual path keeps the token). The kept
tokens are gathered into an (E, G·cap, D) buffer, every expert's FFN runs as
one batched product over it, and each (token, k) reads its row back weighted
by gate·keep. The shared experts, an MLP of n_shared_experts x d_ff, add to
every token.

Capacity makes a token's output depend on the other tokens of its group:
dead decode lanes and a prefill bucket's pad rows take places too, as in the
reference. `reduced_config` sets cf = E/K (no token is ever dropped) so that
the tests' grouping cannot change routing.

Two index rules of JAX are made explicit: a dropped (token, k) is written to
an extra dump row and column of a (G, E + 1, cap + 1) slot table that is
sliced off (JAX's `mode="drop"`), and its read back comes from a zero pad
(JAX clamps the index and multiplies by a zero gate). Every shape is static
and nothing is read back to the host — no `nonzero`, boolean-mask indexing
or `one_hot` (which reads the indices' range on the CPU) — so the body can
be captured in a CUDA graph. The products are `torch.bmm`: the reference
computes them in jnp, outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import ACTIVATIONS, MLP, apply_mlp, param

GROUP_SIZE = 1024


class MoE(nn.Module):
    """router (d, E) in float32 whatever the model's dtype; wi, wg (E, d,
    fe) and wo (E, fe, d) stacked over the experts; shared, an MLP of
    n_shared_experts x d_ff, when the config has shared experts."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, fe, e, dt = cfg.d_model, cfg.d_expert, cfg.n_experts, \
            cfg.torch_dtype
        self.router = param((d, e), torch.float32, device)
        self.wi = param((e, d, fe), dt, device)
        if cfg.gated_mlp:
            self.wg = param((e, d, fe), dt, device)
        self.wo = param((e, fe, d), dt, device)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, device,
                              d_ff=cfg.n_shared_experts * cfg.d_ff)


def group_tokens(x, group_size: int):
    """(B, S, D) -> ((G, group_size, D), N): the token axis flattened and
    right-padded with zeros to whole groups."""
    B, S, D = x.shape
    N = B * S
    flat = x.reshape(N, D)
    pad = (-N) % group_size
    if pad:
        flat = F.pad(flat, (0, 0, 0, pad))
    return flat.reshape(-1, group_size, D), N


def capacity(cfg: ModelConfig, n: int) -> int:
    """Places per expert in a group of n tokens, as the reference counts
    them."""
    return max(1, int(-(-n * cfg.top_k * cfg.capacity_factor
                        // cfg.n_experts)))


def route(moe: MoE, cfg: ModelConfig, xg):
    """xg (G, n, D) -> (gate, eidx, pos, keep), each (G, n, K): the
    renormalised gates of the top-K experts in descending order, their
    indices, each (token, k)'s place in its expert's queue (an exclusive
    cumsum over the token-major, k-minor order) and whether it is under the
    capacity."""
    E, K = cfg.n_experts, cfg.top_k
    G, n, _ = xg.shape
    probs = torch.softmax(xg.float() @ moe.router, dim=-1)  # (G, n, E)
    gate, eidx = torch.topk(probs, K, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    onehot = (eidx[..., None] == torch.arange(E, device=xg.device)).long()
    flat = onehot.reshape(G, n * K, E)
    pos_flat = flat.cumsum(1) - flat
    pos = (pos_flat.reshape(G, n, K, E) * onehot).sum(-1)
    return gate, eidx, pos, pos < capacity(cfg, n)


def apply_moe(moe: MoE, cfg: ModelConfig, x, group_size: int = GROUP_SIZE):
    """x (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xg, N = group_tokens(x, min(group_size, B * S))
    G, n, _ = xg.shape
    cap = capacity(cfg, n)
    dev = x.device
    gate, eidx, pos, keep = route(moe, cfg, xg)

    # the (G, E, cap) table of token ids, n (a zero pad token) where empty;
    # dropped (token, k) pairs land in the dump row E / column cap
    slot_e = torch.where(keep, eidx, torch.full_like(eidx, E))
    slot_p = torch.where(keep, pos, torch.full_like(pos, cap))
    g_ix = torch.arange(G, device=dev)[:, None, None].expand(G, n, K)
    token_of = torch.arange(n, device=dev)[None, :, None].expand(G, n, K)
    table = torch.full((G, E + 1, cap + 1), n, dtype=torch.long, device=dev)
    table[g_ix, slot_e, slot_p] = token_of
    table = table[:, :E, :cap]
    xg_pad = torch.cat([xg, xg.new_zeros((G, 1, D))], dim=1)
    expert_in = xg_pad[torch.arange(G, device=dev)[:, None, None], table]

    # the batched expert FFN: (E, G·cap, D) x (E, D, fe)
    act = ACTIVATIONS[cfg.activation]
    ein = expert_in.transpose(0, 1).reshape(E, G * cap, D)
    h = torch.bmm(ein, moe.wi)
    h = act(torch.bmm(ein, moe.wg)) * h if cfg.gated_mlp else act(h)
    eout = torch.bmm(h, moe.wo).reshape(E, G, cap, D).transpose(0, 1)

    # each (token, k) reads its row back (a dropped one from the zero pad)
    eout = F.pad(eout, (0, 0, 0, 1, 0, 1))  # (G, E + 1, cap + 1, D)
    back = eout[g_ix, slot_e, slot_p]  # (G, n, K, D)
    back = back * (gate * keep).to(back.dtype)[..., None]
    y = back.sum(2).reshape(G * n, D)[:N].reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + apply_mlp(moe.shared, cfg, x)
    return y


__all__ = ["MoE", "apply_moe", "route", "capacity", "group_tokens",
           "GROUP_SIZE"]
