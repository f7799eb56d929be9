"""Encoder-decoder model (whisper's backbone) of the port.

The audio conv frontend is a STUB, as in the reference
(`repro/models/encdec.py`): the caller passes precomputed frame embeddings
(B, F, d_model), and the encoder is a bidirectional transformer over them
with fixed sinusoidal positions and no RoPE. Each decoder layer adds
cross-attention to the encoder's output, whose K/V a fresh (turn-1)
prefill computes once — the compute-bound first phase of this family —
and the cache keeps as fixed rows; an append and every decode step read
them and never write them.

The cache tree is the reference's: {"self": {"k", "v": (L, B, ctx, Hkv,
hd)}, "cross": {"k", "v": (L, B, encoder_seq, Hkv, hd)}}, the decoder
layer on the leading axis. A slot's length counts decoder positions only:
the frames live in "cross" (ROADMAP queue 3, F14).

The decoder's self-attention is the decoder-only path's `gqa_prefill` /
`gqa_decode` (RoPE at the decoder positions on top of the sinusoidal
table, as in the reference), so under `attention_impl="cuda"` a fresh
prefill reaches K2 and a decode step K1. The encoder's attention and
every cross-attention are the non-causal `online_attention`, torch ops
under both impls (K2 is causal only and K1 needs a new token).

The training forward `encdec_hidden` runs the encoder once and each
decoder layer (rematerialised, with its cross K/V recomputed inside it,
under `remat`) without a cache.

The sinusoidal table (`max_seq` rows) is one buffer built once on the
model's device and indexed by a device tensor, so a decode step captures
in a CUDA graph. Two reference faults are designed out here: a padded
prefill honours `logits_at` (F15), and decode returns only the "self"
rows, which the engine folds while the "cross" rows stay as they are
(F13).
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import (Attention, _proj_qkv, _repeat_kv, cross_attention,
                        encode_cross_kv, gqa_decode, gqa_prefill,
                        online_attention)
from .config import ATTN_GLOBAL, ModelConfig
from .layers import (MLP, apply_mlp, embed, make_norm, param,
                     sinusoidal_positions, unembed)
from .transformer import check_ported, logits_of


class EncoderBlock(nn.Module):
    """ln1, the bidirectional self-attention `attn`, ln2, the MLP."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = make_norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.ln2 = make_norm(cfg, device)
        self.mlp = MLP(cfg, device)


class DecoderBlock(nn.Module):
    """ln1, the causal self-attention `attn`, lnx, the cross-attention
    `cross`, ln2, the MLP. No projection has a qk-norm: `check_ported`
    admits an encoder-decoder only without one (the reference's encoder
    and cross-attention would not apply it)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = make_norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.lnx = make_norm(cfg, device)
        self.cross = Attention(cfg, device)
        self.ln2 = make_norm(cfg, device)
        self.mlp = MLP(cfg, device)


class EncDec(nn.Module):
    """embed, `n_encoder_layers` EncoderBlocks, enc_norm, `n_layers`
    DecoderBlocks, final_norm and the untied unembed; `pos_table` is the
    sinusoidal table, a buffer (not a parameter: it is no weight)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = nn.Module()
        self.embed.w = param((cfg.padded_vocab, cfg.d_model),
                             cfg.torch_dtype, device)
        self.encoder = nn.ModuleList(EncoderBlock(cfg, device)
                                     for _ in range(cfg.n_encoder_layers))
        self.enc_norm = make_norm(cfg, device)
        self.decoder = nn.ModuleList(DecoderBlock(cfg, device)
                                     for _ in range(cfg.n_layers))
        self.final_norm = make_norm(cfg, device)
        self.unembed = nn.Module()
        self.unembed.w = param((cfg.d_model, cfg.padded_vocab),
                               cfg.torch_dtype, device)
        self.register_buffer(
            "pos_table", sinusoidal_positions(cfg.max_seq, cfg.d_model,
                                              cfg.torch_dtype, device),
            persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.w.device


def cache_shapes(cfg: ModelConfig, batch: int, ctx: int):
    """{"self" | "cross": (shape, dtype)} of the cache tree's leaves (each
    section holds "k" and "v")."""
    kv_dt = cfg.kv_torch_dtype
    tail = (cfg.n_kv_heads, cfg.head_dim)
    return {"self": ((cfg.n_layers, batch, ctx) + tail, kv_dt),
            "cross": ((cfg.n_layers, batch, cfg.encoder_seq) + tail,
                      cfg.torch_dtype)}


def _positions(m: EncDec, pos) -> torch.Tensor:
    """Rows of the sinusoidal table at `pos`, a device-tensor gather."""
    return m.pos_table[pos.to(m.device).long()]


def run_encoder(m: EncDec, cfg: ModelConfig, frame_embeds):
    """frame_embeds (B, F, D) from the stub frontend -> the encoder's
    normed output (B, F, D)."""
    B, F, _ = frame_embeds.shape
    pos = torch.arange(F, device=m.device)
    h = frame_embeds.to(m.device, cfg.torch_dtype) + _positions(m, pos)[None]
    for blk in m.encoder:
        q, k, v = _proj_qkv(blk.attn, cfg, blk.ln1(h))
        o = online_attention(q, _repeat_kv(k, cfg.n_heads),
                             _repeat_kv(v, cfg.n_heads), pos, pos,
                             causal=False)
        h = h + o.reshape(B, F, -1) @ blk.attn.wo
        h = h + apply_mlp(blk.mlp, cfg, blk.ln2(h))
    return m.enc_norm(h)


def _layer(tree: Dict, i: int) -> Dict[str, torch.Tensor]:
    return {n: t[i] for n, t in tree.items()}


def _stack(per_layer: List[Dict[str, torch.Tensor]]) -> Dict:
    return {n: torch.stack([u[n] for u in per_layer])
            for n in per_layer[0]}


def encdec_prefill(m: EncDec, cfg: ModelConfig, tokens, *,
                   frontend_embeds=None, caches=None, start_pos=0,
                   kv_lens=None, prefix_start=None, logits_at=None,
                   attention_impl: str = "torch"):
    """Fresh (caches None) or append prefill of (B, S) decoder tokens from
    position `start_pos` (an int or a (1,) device tensor). Fresh: runs the
    encoder over `frontend_embeds` and each decoder layer's cross K/V once;
    append: reads the cross K/V and the self prefix from `caches` (the
    prefix layouts and kv_lens are `gqa_prefill`'s). Returns (logits at
    `logits_at` (F15; default the last position), {"self": the new
    tokens' K/V} plus, when fresh, {"cross": the encoder's K/V})."""
    B, S = tokens.shape
    pos = start_pos + torch.arange(S, device=m.device)
    h = (embed(m.embed.w, cfg, tokens).to(cfg.torch_dtype)
         + _positions(m, pos)[None])
    if caches is None:
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: a fresh prefill needs the "
                             "frontend's frame embeddings")
        enc = run_encoder(m, cfg, frontend_embeds)
        cross = [encode_cross_kv(blk.cross, cfg, enc) for blk in m.decoder]
    else:
        cross = [_layer(caches["cross"], i) for i in range(cfg.n_layers)]
    new_self = []
    for i, blk in enumerate(m.decoder):
        prefix = None if caches is None else _layer(caches["self"], i)
        out, kv = gqa_prefill(blk.attn, cfg, ATTN_GLOBAL, blk.ln1(h),
                              start_pos, prefix_kv=prefix, kv_lens=kv_lens,
                              prefix_start=prefix_start,
                              attention_impl=attention_impl)
        h = h + out
        h = h + cross_attention(blk.cross, cfg, blk.lnx(h), cross[i])
        h = h + apply_mlp(blk.mlp, cfg, blk.ln2(h))
        new_self.append(kv)
    h = m.final_norm(h)
    logits = unembed(m.embed.w, logits_of(h, logits_at), m.unembed.w)
    out = {"self": _stack(new_self)}
    if caches is None:
        out["cross"] = _stack(cross)
    return logits, out


def encdec_hidden(m: EncDec, cfg: ModelConfig, tokens, *,
                  frontend_embeds, remat: bool = False):
    """Training forward: the decoder's post-final-norm hidden states (B, S,
    D) over the encoder's output for `frontend_embeds`. No cache; the
    encoder is not rematerialised; with `remat` each decoder layer runs
    under `torch.utils.checkpoint`, its cross K/V recomputed inside it
    (reference `encdec_hidden`)."""
    B, S = tokens.shape
    pos = torch.arange(S, device=m.device)
    h = (embed(m.embed.w, cfg, tokens).to(cfg.torch_dtype)
         + _positions(m, pos)[None])
    enc = run_encoder(m, cfg, frontend_embeds)

    def layer(blk, x, enc_out):
        x = x + gqa_prefill(blk.attn, cfg, ATTN_GLOBAL, blk.ln1(x), 0)[0]
        x = x + cross_attention(blk.cross, cfg, blk.lnx(x),
                                encode_cross_kv(blk.cross, cfg, enc_out))
        return x + apply_mlp(blk.mlp, cfg, blk.ln2(x))

    for blk in m.decoder:
        h = (checkpoint(partial(layer, blk), h, enc, use_reentrant=False)
             if remat else layer(blk, h, enc))
    return m.final_norm(h)


def encdec_decode(m: EncDec, cfg: ModelConfig, token, caches, position,
                  kv_lens=None, ctx_limit=None,
                  attention_impl: str = "torch"):
    """One decode step of (B,) tokens at `position` (scalar or (B,)):
    the sinusoidal row by device index, then each decoder layer's
    `gqa_decode` (K1 under "cuda") against the self rows trimmed to
    `ctx_limit`, and its cross-attention over all the cross rows. Returns
    (logits (B, V), {"self": the new token's K/V}) — the cross rows are
    not an update (F13)."""
    B = token.shape[0]
    pos = torch.as_tensor(position, device=m.device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    h = (embed(m.embed.w, cfg, token[:, None]).to(cfg.torch_dtype)
         + _positions(m, pos)[:, None])
    ups = []
    for i, blk in enumerate(m.decoder):
        out, up = gqa_decode(blk.attn, cfg, ATTN_GLOBAL, blk.ln1(h), position,
                             _layer(caches["self"], i), kv_lens=kv_lens,
                             ctx_limit=ctx_limit,
                             attention_impl=attention_impl)
        h = h + out
        h = h + cross_attention(blk.cross, cfg, blk.lnx(h),
                                _layer(caches["cross"], i))
        h = h + apply_mlp(blk.mlp, cfg, blk.ln2(h))
        ups.append(up)
    logits = unembed(m.embed.w, m.final_norm(h)[:, 0], m.unembed.w)
    return logits, {"self": _stack(ups)}
