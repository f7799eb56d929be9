"""Decoder-only LM assembled from a ModelConfig: an embedding, one `Block`
per layer in an `nn.ModuleList`, a final norm and the (tied or untied)
unembedding, with the prefill / decode entry points the serving engine
uses.

Caches keep the JAX package's pytree. Every ported configuration has a
one-kind pattern, so all layers stack under "groups"/"p0" with the layer on
the leading axis; layer i reads leaf[i]. The leaves are the kind's: "k", "v"
(n_layers, batch, ctx, Hkv, hd) for global GQA; "s" (n_layers, batch,
nh_pad, hs, hs) and "shift", "cshift" (n_layers, batch, 1, d_model) for
RWKV6.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from .blocks import Block, block_decode, block_prefill
from .config import ATTN_GLOBAL, RWKV6, ModelConfig
from .layers import embed, make_norm, param, unembed


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a configuration the port does not serve
    yet. It serves two families: dense global-GQA decoders with RMSNorm,
    SwiGLU and tied embeddings (qwen3-0.6b), and attention-free RWKV6 with
    LayerNorm and untied embeddings (rwkv6-3b), whose FFN is the
    channel-mix."""
    if cfg.block_pattern == (RWKV6,):
        family = (("norm", cfg.norm, "layernorm"),
                  ("tie_embeddings", cfg.tie_embeddings, False))
    else:
        family = (("block_pattern", cfg.block_pattern, (ATTN_GLOBAL,)),
                  ("norm", cfg.norm, "rmsnorm"),
                  ("activation", cfg.activation, "silu"),
                  ("gated_mlp", cfg.gated_mlp, True),
                  ("tie_embeddings", cfg.tie_embeddings, True))
    common = (("n_experts", cfg.n_experts, 0),
              ("is_encoder_decoder", cfg.is_encoder_decoder, False),
              ("frontend", cfg.frontend, "none"))
    missing = [f"{what} {got!r}" for what, got, want in family + common
               if got != want]
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
        self.blocks = nn.ModuleList(Block(cfg, kind, device)
                                    for kind in cfg.layer_kinds())
        self.final_norm = make_norm(cfg, device)
        self.unembed = nn.Module()
        if not cfg.tie_embeddings:
            self.unembed.w = param((cfg.d_model, cfg.padded_vocab),
                                   cfg.torch_dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.w.device


def layer_cache(caches, i: int) -> Dict[str, torch.Tensor]:
    return {n: leaf[i] for n, leaf in caches["groups"]["p0"].items()}


def stack_layers(per_layer: List[Dict[str, torch.Tensor]]) -> Dict:
    """Per-layer cache leaves -> the cache tree, layers on the leading
    axis."""
    return {"groups": {"p0": {n: torch.stack([u[n] for u in per_layer])
                              for n in per_layer[0]}}}


def lm_logits(lm: LM, h):
    return unembed(lm.embed.w, h, getattr(lm.unembed, "w", None))


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
    return lm_logits(lm, hh), caches_out


def lm_decode(lm: LM, cfg: ModelConfig, token, caches, position,
              kv_lens=None, ctx_limit=None, attention_impl: str = "torch"):
    """One decode step. token: (B,) int; caches as from `Model.init_cache`.
    Returns (logits (B,V), cache updates) — the new token's K/V only, in the
    cache tree's layout with length 1, or the updated RWKV state."""
    h = embed(lm.embed.w, cfg, token[:, None]).to(cfg.torch_dtype)
    ups = []
    for i, block in enumerate(lm.blocks):
        h, up = block_decode(block, cfg, h, position, layer_cache(caches, i),
                             kv_lens=kv_lens, ctx_limit=ctx_limit,
                             attention_impl=attention_impl)
        ups.append(up)
    return lm_logits(lm, lm.final_norm(h)[:, 0]), stack_layers(ups)
