"""Decoder-only LM assembled from a ModelConfig: an embedding, one `Block`
per layer in an `nn.ModuleList`, a final norm and the tied unembedding, with
the prefill / decode entry points the serving engine uses.

Caches keep the JAX package's pytree. Every ported layer is a global GQA
layer of a one-kind pattern, so all of them stack under "groups"/"p0":
`{"groups": {"p0": {"k", "v"}}}` with leaves (n_layers, batch, ctx, Hkv,
hd); layer i reads leaf[i].
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from .blocks import Block, block_decode, block_prefill
from .config import ATTN_GLOBAL, ModelConfig
from .layers import RMSNorm, embed, param, unembed


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a configuration the port does not serve
    yet: it serves dense global-GQA decoders with RMSNorm, SwiGLU and tied
    embeddings (qwen3-0.6b)."""
    missing = [what for what, ok in (
        (f"block_pattern {cfg.block_pattern}",
         cfg.block_pattern == (ATTN_GLOBAL,)),
        (f"n_experts {cfg.n_experts}", not cfg.n_experts),
        (f"norm {cfg.norm!r}", cfg.norm == "rmsnorm"),
        (f"activation {cfg.activation!r}", cfg.activation == "silu"),
        ("gated_mlp False", cfg.gated_mlp),
        ("untied embeddings", cfg.tie_embeddings),
        ("encoder-decoder", not cfg.is_encoder_decoder),
        (f"frontend {cfg.frontend!r}", cfg.frontend == "none"),
    ) if not ok]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: "
            f"{', '.join(missing)}")


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = nn.Module()
        self.embed.w = param((cfg.padded_vocab, cfg.d_model),
                             cfg.torch_dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.embed.w.device


def layer_cache(caches, i: int) -> Dict[str, torch.Tensor]:
    return {n: leaf[i] for n, leaf in caches["groups"]["p0"].items()}


def stack_layers(per_layer: List[Dict[str, torch.Tensor]]) -> Dict:
    """Per-layer {"k","v"} -> the cache tree, layers on the leading axis."""
    return {"groups": {"p0": {n: torch.stack([u[n] for u in per_layer])
                              for n in ("k", "v")}}}


def lm_hidden(lm: LM, cfg: ModelConfig, tokens, *, caches=None,
              start_pos: int = 0, kv_lens=None, prefix_start=None,
              attention_impl: str = "torch"):
    """Run the stack over (B, S) tokens. Returns (post-final-norm hidden
    (B, S, D), the new tokens' caches as a tree)."""
    h = embed(lm.embed.w, cfg, tokens).to(cfg.torch_dtype)
    outs = []
    for i, block in enumerate(lm.blocks):
        prefix = None if caches is None else layer_cache(caches, i)
        h, co = block_prefill(block, cfg, h, start_pos, cache=prefix,
                              kv_lens=kv_lens, prefix_start=prefix_start,
                              attention_impl=attention_impl)
        outs.append(co)
    return lm.final_norm(h), stack_layers(outs)


def lm_prefill(lm: LM, cfg: ModelConfig, tokens, *, caches=None,
               start_pos: int = 0, kv_lens=None, prefix_start=None,
               logits_at=None, attention_impl: str = "torch"):
    """Prefill: returns (logits (B,V), caches_out). logits_at selects the
    position whose logits are returned (the engine passes true_len-1 when
    the token batch is right-padded to a bucket; default: last position)."""
    h, caches_out = lm_hidden(lm, cfg, tokens, caches=caches,
                              start_pos=start_pos, kv_lens=kv_lens,
                              prefix_start=prefix_start,
                              attention_impl=attention_impl)
    if logits_at is None:
        hh = h[:, -1]
    elif not torch.is_tensor(logits_at) or logits_at.dim() == 0:
        hh = h[:, int(logits_at)]
    else:  # per-sequence gather
        hh = h[torch.arange(h.shape[0], device=h.device),
               logits_at.to(h.device).long()]
    return unembed(lm.embed.w, hh), caches_out


def lm_decode(lm: LM, cfg: ModelConfig, token, caches, position,
              kv_lens=None, ctx_limit=None, attention_impl: str = "torch"):
    """One decode step. token: (B,) int; caches as from `Model.init_cache`.
    Returns (logits (B,V), cache updates) — the new token's K/V only, in the
    cache tree's layout with length 1."""
    h = embed(lm.embed.w, cfg, token[:, None]).to(cfg.torch_dtype)
    ups = []
    for i, block in enumerate(lm.blocks):
        h, up = block_decode(block, cfg, h, position, layer_cache(caches, i),
                             kv_lens=kv_lens, ctx_limit=ctx_limit,
                             attention_impl=attention_impl)
        ups.append(up)
    return unembed(lm.embed.w, lm.final_norm(h)[:, 0]), stack_layers(ups)
