"""Per-layer block: (norm -> sequence mixer -> residual) + (norm -> FFN ->
residual), specialised by the layer's kind. The ported kinds:

* global and local (sliding-window) GQA attention + the MLP, gated or not
  (`attn`, `mlp`); its cache is the new tokens' K/V, which the engine
  appends;
* MLA (`attn`, the latent attention); its cache is the new tokens' latent
  `ckv` and rope key `krope`, which the engine appends;
* in a MoE config (`cfg.n_experts`), every attention or RG-LRU layer holds
  the grouped-capacity MoE (`moe`) in place of the MLP;
* RWKV6 time-mix + channel-mix (`tmix`, `cmix`); its cache is a fixed-size
  state — `s` (the WKV state), `shift` (the time-mix's last *normed* input
  token) and `cshift` (the channel-mix's) — which the engine replaces;
* RG-LRU + the gated MLP (`rglru`, `mlp`); its cache is a fixed-size state —
  `h` (the recurrence) and `conv` (the conv's last K-1 inputs) — which the
  engine replaces.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .attention import (MLA, Attention, gqa_decode, gqa_prefill, mla_decode,
                        mla_prefill)
from .config import (ATTN_GLOBAL, ATTN_LOCAL, ATTN_MLA, RGLRU, RWKV6,
                     ModelConfig)
from .layers import MLP, apply_mlp, make_norm
from .moe import MoE, apply_moe
from .recurrent import (RGLRU as RGLRUMix, ChannelMix, TimeMix, rglru_decode,
                        rglru_init_state, rglru_prefill, rwkv6_decode,
                        rwkv6_init_state, rwkv6_prefill, rwkv_cmix)

ATTN_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, ATTN_MLA)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, device):
        super().__init__()
        self.kind = kind
        self.ln1 = make_norm(cfg, device)
        self.ln2 = make_norm(cfg, device)
        if kind == ATTN_MLA:
            self.attn = MLA(cfg, device)
        elif kind in ATTN_KINDS:
            self.attn = Attention(cfg, device)
        elif kind == RGLRU:
            self.rglru = RGLRUMix(cfg, device)
        elif kind == RWKV6:
            self.tmix = TimeMix(cfg, device)
            self.cmix = ChannelMix(cfg, device)
        else:
            raise NotImplementedError(f"layer kind {kind!r} is not ported")
        if kind != RWKV6:
            if cfg.n_experts:
                self.moe = MoE(cfg, device)
            else:
                self.mlp = MLP(cfg, device)


def _ffn(block: Block, cfg: ModelConfig, x):
    """The FFN of an attention or RG-LRU layer: the MoE or the MLP."""
    if cfg.n_experts:
        return apply_moe(block.moe, cfg, x)
    return apply_mlp(block.mlp, cfg, x)


def _cmix(block: Block, cfg: ModelConfig, x, cache: Optional[Dict]):
    prev = cache["cshift"] if cache is not None else torch.zeros(
        (x.shape[0], 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    return rwkv_cmix(block.cmix, cfg, x, prev)


def block_prefill(block: Block, cfg: ModelConfig, x, start_pos,
                  cache: Optional[Dict] = None, kv_lens=None,
                  prefix_start=None, attention_impl: str = "torch"
                  ) -> Tuple[torch.Tensor, Dict]:
    """cache: prefix KV (append-prefill) or recurrent state; None = fresh (a
    recurrent layer then starts from the zero state). Returns (x_out, the
    new tokens' {"k","v"} or the updated state)."""
    h = block.ln1(x)
    if block.kind == RWKV6:
        state = cache if cache is not None else rwkv6_init_state(
            cfg, x.shape[0], x.device)
        out, cache_out = rwkv6_prefill(
            block.tmix, cfg, h, {"s": state["s"], "shift": state["shift"]},
            attention_impl=attention_impl)
        x = x + out
        out, cshift = _cmix(block, cfg, block.ln2(x), cache)
        return x + out, {**cache_out, "cshift": cshift}
    if block.kind == RGLRU:
        state = cache if cache is not None else rglru_init_state(
            cfg, x.shape[0], x.device)
        out, cache_out = rglru_prefill(block.rglru, cfg, h, state,
                                       attention_impl=attention_impl)
    elif block.kind == ATTN_MLA:
        out, cache_out = mla_prefill(block.attn, cfg, h, start_pos,
                                     prefix_kv=cache, kv_lens=kv_lens,
                                     prefix_start=prefix_start,
                                     attention_impl=attention_impl)
    else:
        out, cache_out = gqa_prefill(block.attn, cfg, block.kind, h,
                                     start_pos, prefix_kv=cache,
                                     kv_lens=kv_lens,
                                     prefix_start=prefix_start,
                                     attention_impl=attention_impl)
    x = x + out
    x = x + _ffn(block, cfg, block.ln2(x))
    return x, cache_out


def block_decode(block: Block, cfg: ModelConfig, x1, position, cache: Dict,
                 kv_lens=None, ctx_limit: Optional[int] = None,
                 attention_impl: str = "torch") -> Tuple[torch.Tensor, Dict]:
    """x1: (B,1,D). Returns (x_out, the new token's {"k","v"} or
    {"ckv","krope"}, which the engine appends, or the updated recurrent
    state, which it replaces).
    `ctx_limit` (an upper bound on kv_lens) trims the attention cache read;
    a recurrent layer reads neither, and its decode step is torch ops."""
    h = block.ln1(x1)
    if block.kind == RWKV6:
        out, cache_out = rwkv6_decode(block.tmix, cfg, h,
                                      {"s": cache["s"],
                                       "shift": cache["shift"]})
        x1 = x1 + out
        out, cshift = _cmix(block, cfg, block.ln2(x1), cache)
        return x1 + out, {**cache_out, "cshift": cshift}
    if block.kind == RGLRU:
        out, cache_out = rglru_decode(block.rglru, cfg, h, cache)
    elif block.kind == ATTN_MLA:
        out, cache_out = mla_decode(block.attn, cfg, h, position, cache,
                                    kv_lens=kv_lens, ctx_limit=ctx_limit,
                                    attention_impl=attention_impl)
    else:
        out, cache_out = gqa_decode(block.attn, cfg, block.kind, h, position,
                                    cache, kv_lens=kv_lens,
                                    ctx_limit=ctx_limit,
                                    attention_impl=attention_impl)
    x1 = x1 + out
    x1 = x1 + _ffn(block, cfg, block.ln2(x1))
    return x1, cache_out
