"""Model facade: one object per ModelConfig exposing init, the slot cache
and the two serving entry points — prefill and single-token decode."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device

from . import transformer
from .config import ModelConfig
from .layers import init_params


class Model:
    def __init__(self, cfg: ModelConfig):
        transformer.check_ported(cfg)
        self.cfg = cfg

    def init(self, seed: int = 0, device=None) -> transformer.LM:
        """Seeded weights on `device` (default "cuda"; raises without a card
        unless device="cpu")."""
        return init_params(transformer.LM(self.cfg, resolve_device(device)),
                           seed)

    def init_cache(self, batch: int, ctx: int, device=None) -> Dict[str, Any]:
        """Zeroed slot cache in the JAX package's tree:
        {"groups": {"p0": {"k", "v"}}}, each (n_layers, batch, ctx, Hkv,
        hd)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.kv_cache_dtype or cfg.dtype)
        shape = (cfg.n_layers, batch, ctx, cfg.n_kv_heads, cfg.head_dim)
        dev = resolve_device(device)
        return {"groups": {"p0": {n: torch.zeros(shape, dtype=dt, device=dev)
                                  for n in ("k", "v")}}}

    @torch.no_grad()
    def prefill(self, params, tokens, *, caches=None, start_pos: int = 0,
                kv_lens=None, prefix_start=None, logits_at=None,
                attention_impl: str = "torch"):
        """(logits (B,V), caches_out). caches=None: fresh turn-1 prefill;
        otherwise append-prefill against the cached prefix (engine mode:
        prefix_start=0 with kv_lens masking the padded buffer).
        `attention_impl="cuda"` sends fresh prefill attention through K2."""
        return transformer.lm_prefill(params, self.cfg, tokens, caches=caches,
                                      start_pos=start_pos, kv_lens=kv_lens,
                                      prefix_start=prefix_start,
                                      logits_at=logits_at,
                                      attention_impl=attention_impl)

    @torch.no_grad()
    def decode_step(self, params, token, caches, position, kv_lens=None,
                    ctx_limit=None, attention_impl: str = "torch"):
        """(logits (B,V), cache_updates): the new token's K/V only; the
        cache manager appends them. `ctx_limit` bounds kv_lens and trims the
        cache read. `attention_impl="cuda"` serves decode attention through
        K1."""
        return transformer.lm_decode(params, self.cfg, token, caches,
                                     position, kv_lens=kv_lens,
                                     ctx_limit=ctx_limit,
                                     attention_impl=attention_impl)


def merge_decode_cache(caches, updates):
    """Fold one decode step's K/V into the caches by concatenation along the
    length axis. Used by simple rollout loops; the serving engine writes
    into slot buffers in place instead (repro_torch.engine.kvcache)."""
    ups = updates["groups"]["p0"]
    return {"groups": {"p0": {
        n: torch.cat([leaf, ups[n].to(leaf.dtype)], dim=2)
        for n, leaf in caches["groups"]["p0"].items()}}}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
