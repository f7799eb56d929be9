"""Model facade: one object per ModelConfig exposing init, the slot cache,
the two serving entry points — prefill and single-token decode, under
no_grad — and the training forward (`hidden`, `logits`, with autograd)
for the decoder-only families (`transformer.LM`) and the encoder-decoder
(`encdec.EncDec`) alike."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.device import resolve_device

from . import encdec, transformer
from .config import (ATTN_GLOBAL, ATTN_LOCAL, ATTN_MLA, RGLRU, RWKV6,
                     ModelConfig)
from .layers import init_params
from .recurrent import _rwkv_dims

# cache leaves that grow by one row per token (the rest are fixed states)
GROWING_KEYS = ("k", "v", "ckv", "krope")


def layer_cache_shapes(cfg: ModelConfig, kind: str, batch: int, ctx: int
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each cache leaf one layer of `kind` holds after
    `ctx` tokens — the reference's `block_cache_skeleton`. Attention caches
    (GQA K/V, MLA's latent and rope key) grow (a local layer's is at most its window long); recurrent states are
    fixed-size. RWKV6's nh_pad comes from `recurrent._rwkv_dims`, as in the
    model itself (the reference's skeleton takes `rwkv_pad_heads_to or nh`,
    which disagrees with its model when 0 < rwkv_pad_heads_to < nh — F6)."""
    kv_dt = cfg.kv_torch_dtype
    dt = cfg.torch_dtype
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        L = min(ctx, cfg.window) if kind == ATTN_LOCAL and cfg.window else ctx
        shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
        return {"k": (shape, kv_dt), "v": (shape, kv_dt)}
    if kind == ATTN_MLA:  # the compressed latent and the shared rope key
        return {"ckv": ((batch, ctx, cfg.kv_lora_rank), kv_dt),
                "krope": ((batch, ctx, cfg.qk_rope_dim), kv_dt)}
    if kind == RWKV6:
        hs = cfg.rwkv_head_size
        _, nh_pad, _ = _rwkv_dims(cfg)
        shift = (batch, 1, cfg.d_model)
        return {"s": ((batch, nh_pad, hs, hs), torch.float32),
                "shift": (shift, dt), "cshift": (shift, dt)}
    if kind == RGLRU:
        return {"h": ((batch, cfg.lru_width), torch.float32),
                "conv": ((batch, cfg.conv1d_width - 1, cfg.lru_width), dt)}
    raise NotImplementedError(f"layer kind {kind!r} is not ported")


class Model:
    def __init__(self, cfg: ModelConfig):
        transformer.check_ported(cfg)
        self.cfg = cfg

    def module(self, device) -> torch.nn.Module:
        """The uninitialised module: an `EncDec` for an encoder-decoder,
        else an `LM`."""
        cls = encdec.EncDec if self.cfg.is_encoder_decoder else transformer.LM
        return cls(self.cfg, device)

    def init(self, seed: int = 0, device=None) -> torch.nn.Module:
        """Seeded weights on `device` (default "cuda"; raises without a card
        unless device="cpu")."""
        return init_params(self.module(resolve_device(device)), seed)

    def init_cache(self, batch: int, ctx: int, device=None) -> Dict[str, Any]:
        """Zeroed slot cache in the JAX package's tree (`lm_cache_skeleton`):
        {"groups": {"p{j}": leaves with the pattern's repetitions on a
        leading axis}, "rem": {"p{j}": leaves}} — see `transformer` for the
        layering and `layer_cache_shapes` for each kind's leaves; an
        encoder-decoder's is {"self" | "cross": {"k", "v"}} with the decoder
        layer on the leading axis (`encdec.cache_shapes`)."""
        cfg = self.cfg
        dev = resolve_device(device)
        z = lambda lead, spec: torch.zeros(  # noqa: E731
            lead + spec[0], dtype=spec[1], device=dev)
        if cfg.is_encoder_decoder:
            return {sec: {n: z((), spec) for n in ("k", "v")}
                    for sec, spec in encdec.cache_shapes(cfg, batch,
                                                         ctx).items()}
        pat, n_groups, rem = cfg.pattern_groups()
        tree: Dict[str, Any] = {}
        if n_groups:
            tree["groups"] = {
                f"p{j}": {n: z((n_groups,), sp) for n, sp in
                          layer_cache_shapes(cfg, kind, batch, ctx).items()}
                for j, kind in enumerate(pat)}
        if rem:
            tree["rem"] = {
                f"p{j}": {n: z((), sp) for n, sp in
                          layer_cache_shapes(cfg, kind, batch, ctx).items()}
                for j, kind in enumerate(rem)}
        return tree

    def hidden(self, params, tokens, *, frontend_embeds=None,
               remat: bool = False):
        """Training forward -> post-norm hidden states (B, S, D), with
        autograd (not under no_grad): no cache, the reference's train path
        (`attention_impl="torch"`: no kernel launch), rematerialised at
        `cfg.remat_granularity` when `remat`. A vision model's frontend rows
        are dropped; an encoder-decoder's `frontend_embeds` are its
        frames."""
        if self.cfg.is_encoder_decoder:
            return encdec.encdec_hidden(params, self.cfg, tokens,
                                        frontend_embeds=frontend_embeds,
                                        remat=remat)
        return transformer.lm_hidden(params, self.cfg, tokens, mode="train",
                                     frontend_embeds=frontend_embeds,
                                     remat=remat)[0]

    def logits(self, params, hidden):
        """The unembedding of hidden states (..., D) -> (..., padded
        vocab), in the model's dtype."""
        return transformer.lm_logits(params, hidden)

    @torch.no_grad()
    def prefill(self, params, tokens, *, caches=None, start_pos: int = 0,
                kv_lens=None, prefix_start=None, logits_at=None,
                frontend_embeds=None, attention_impl: str = "torch"):
        """(logits (B,V), caches_out). caches=None: fresh turn-1 prefill;
        otherwise append-prefill against the cached prefix (engine mode:
        prefix_start=0 with kv_lens masking the padded buffer). A recurrent
        layer takes its state from `caches` and reads no kv_lens.
        `frontend_embeds` (B, F, D): a vision model's patch embeddings,
        before the tokens; an encoder-decoder's frames, which a fresh
        prefill encodes. `attention_impl="cuda"` sends fresh global prefill
        attention through K2, the RWKV WKV recurrence through K3 and the
        RG-LRU recurrence through K4."""
        fn = (encdec.encdec_prefill if self.cfg.is_encoder_decoder
              else transformer.lm_prefill)
        return fn(params, self.cfg, tokens, caches=caches,
                  start_pos=start_pos, kv_lens=kv_lens,
                  prefix_start=prefix_start, logits_at=logits_at,
                  frontend_embeds=frontend_embeds,
                  attention_impl=attention_impl)

    @torch.no_grad()
    def decode_step(self, params, token, caches, position, kv_lens=None,
                    ctx_limit=None, attention_impl: str = "torch"):
        """(logits (B,V), cache_updates): the new token's K/V only, which
        the cache manager appends, or the updated recurrent state, which it
        replaces. `ctx_limit` bounds kv_lens and trims the cache read.
        `attention_impl="cuda"` serves global decode attention through K1
        (local attention and the recurrent decode steps are torch ops under
        both impls). An encoder-decoder's updates are its "self" rows only;
        its "cross" rows are read, never updated."""
        fn = (encdec.encdec_decode if self.cfg.is_encoder_decoder
              else transformer.lm_decode)
        return fn(params, self.cfg, token, caches, position, kv_lens=kv_lens,
                  ctx_limit=ctx_limit, attention_impl=attention_impl)


def merge_decode_cache(caches, updates):
    """Fold one decode step's updates into the caches: K/V concatenate along
    the length axis (axis 2 under "groups" and an encoder-decoder's "self",
    behind the layer axis; axis 1 under "rem"), fixed states are replaced,
    and an encoder-decoder's "cross" rows are kept. Used by simple rollout
    loops; the serving engine writes into slot buffers in place instead
    (repro_torch.engine.kvcache)."""
    if "self" in caches:
        return {"self": {n: torch.cat([leaf, updates["self"][n].to(
            leaf.dtype)], dim=2) for n, leaf in caches["self"].items()},
            "cross": caches["cross"]}
    return {sec: {key: {
        n: (torch.cat([leaf, updates[sec][key][n].to(leaf.dtype)],
                      dim=2 if sec == "groups" else 1)
            if n in GROWING_KEYS else updates[sec][key][n])
        for n, leaf in node.items()} for key, node in tree.items()}
        for sec, tree in caches.items()}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
