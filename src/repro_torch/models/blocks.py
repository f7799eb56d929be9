"""Per-layer block: (norm -> global GQA attention -> residual) + (norm ->
SwiGLU MLP -> residual), the only layer of the ported configurations."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .attention import Attention, gqa_decode, gqa_prefill
from .config import ModelConfig
from .layers import MLP, RMSNorm, apply_mlp


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg, device)
        self.ln2 = RMSNorm(cfg, device)
        self.attn = Attention(cfg, device)
        self.mlp = MLP(cfg, device)


def block_prefill(block: Block, cfg: ModelConfig, x, start_pos,
                  cache: Optional[Dict] = None, kv_lens=None,
                  prefix_start=None, attention_impl: str = "torch"
                  ) -> Tuple[torch.Tensor, Dict]:
    """cache: prefix KV (append-prefill); None = fresh. Returns (x_out,
    the new tokens' {"k","v"})."""
    out, cache_out = gqa_prefill(block.attn, cfg, block.ln1(x), start_pos,
                                 prefix_kv=cache, kv_lens=kv_lens,
                                 prefix_start=prefix_start,
                                 attention_impl=attention_impl)
    x = x + out
    x = x + apply_mlp(block.mlp, block.ln2(x))
    return x, cache_out


def block_decode(block: Block, cfg: ModelConfig, x1, position, cache: Dict,
                 kv_lens=None, ctx_limit: Optional[int] = None,
                 attention_impl: str = "torch") -> Tuple[torch.Tensor, Dict]:
    """x1: (B,1,D). Returns (x_out, the new token's {"k","v"}); the engine
    appends them. `ctx_limit` (an upper bound on kv_lens) trims the cache
    read."""
    out, cache_out = gqa_decode(block.attn, cfg, block.ln1(x1), position,
                                cache, kv_lens=kv_lens, ctx_limit=ctx_limit,
                                attention_impl=attention_impl)
    x1 = x1 + out
    x1 = x1 + apply_mlp(block.mlp, block.ln2(x1))
    return x1, cache_out
