"""GQA attention, global and sliding-window: blocked online-softmax prefill
and append-prefill, the chunked sliding-window prefill, the two-branch decode
against a slot cache, `flash_attention` (an autograd Function whose
backward recomputes the probabilities: the reference's custom-VJP flash
attention, for training), and the routes into the port's CUDA kernels
(`attention_impl="cuda"`); and MLA (DeepSeek-style latent attention), whose
cache is the compressed latent and one shared rope key, with the expanded
prefill and the absorbed-matrix decode.

Conventions follow the JAX package's `models/attention.py`: q, k, v are
(B, S, H, D); decode reads a cache (B, L, Hkv, D) that it never writes —
it returns the new token's K/V and the cache manager appends it. A layer's
kind picks its RoPE theta (`rope_theta_local` for a local layer) and its
window (`cfg.window` for a local layer, 0 for a global one). The kernels are
reached as in the reference, K2 for a fresh global prefill and K1 for a
global decode, and besides K2's append instance for a bf16 global append
against a slot's prefix (the reference attends those in jnp ops); a local
layer and an MLA layer run torch ops under both impls (the reference has no
kernel there either).

A quantized cache (`kv_cache_dtype`: int8 standing for int8 x
`kv_quant_scale`) follows one rule. Every write into it goes through
`quantize_kv`: a decode step returns its new token's rows quantized, and a
prefill returns its rows in the model's dtype for the slot cache's folds
to quantize (`engine.kvcache`). Every read of it for attention goes through
`dequantize_kv` — the append's prefix included — or hands K1 the int8 rows
with the scale. The reference folds a prefill's rows into an int8 cache by
a plain cast (F23) and attends to an append's int8 prefix as raw integers
(F24); ROADMAP queue 3.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.kernels.decode_attention import dequantize
from repro_torch.kernels.ref import (NEG_INF, PAD_POS, PREFIX_KV_CHUNK,
                                     online_attention, prefix_attention)
from repro_torch.kernels.ref import repeat_kv as _repeat_kv

from .config import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig
from .layers import apply_rope, param, rope_freqs

ATTN_IMPLS = ("torch", "cuda")


class Attention(nn.Module):
    """wq (d, H·hd), wk / wv (d, Hkv·hd), wo (H·hd, d), plus q_scale /
    k_scale (hd,) when the config has qk-norm."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.head_dim, cfg.torch_dtype
        self.wq = param((d, cfg.n_heads * hd), dt, device)
        self.wk = param((d, cfg.n_kv_heads * hd), dt, device)
        self.wv = param((d, cfg.n_kv_heads * hd), dt, device)
        self.wo = param((cfg.n_heads * hd, d), dt, device)
        self.qk_norm = cfg.qk_norm
        if cfg.qk_norm:
            self.q_scale = param((hd,), dt, device)
            self.k_scale = param((hd,), dt, device)


class MLA(nn.Module):
    """w_dkv (d, rank + rope) compresses a token to its latent and rope key;
    w_uk (rank, H, nope) and w_uv (rank, H, v_head_dim) expand the latent
    per head; wo (H·v_head_dim, d); the query is wq (d, H·(nope + rope)), or
    w_dq (d, q_rank) then w_uq (q_rank, H·(nope + rope)) when the config
    has a q_lora_rank."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dt, H = cfg.d_model, cfg.torch_dtype, cfg.n_heads
        qd = cfg.qk_nope_dim + cfg.qk_rope_dim
        self.w_dkv = param((d, cfg.kv_lora_rank + cfg.qk_rope_dim), dt,
                           device)
        self.w_uk = param((cfg.kv_lora_rank, H, cfg.qk_nope_dim), dt, device)
        self.w_uv = param((cfg.kv_lora_rank, H, cfg.v_head_dim), dt, device)
        self.wo = param((H * cfg.v_head_dim, d), dt, device)
        if cfg.q_lora_rank:
            self.w_dq = param((d, cfg.q_lora_rank), dt, device)
            self.w_uq = param((cfg.q_lora_rank, H * qd), dt, device)
        else:
            self.wq = param((d, H * qd), dt, device)


def rope_single(x, positions, theta: float):
    """RoPE for a single decode step with PER-SEQUENCE positions.
    x: (B, 1, H, D) or (B, 1, D); positions: (B,) or scalar int."""
    pos = torch.as_tensor(positions, device=x.device).to(torch.float32)
    if pos.dim() == 0:
        pos = pos.expand(x.shape[0])
    dim = x.shape[-1]
    inv = rope_freqs(dim, theta, x.device)
    ang = pos[:, None] * inv  # (B, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (dim // 2,)
    cos, sin = cos.reshape(shape), sin.reshape(shape)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _qk_norm(x, scale, eps=1e-6):
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)


# --------------------------------------------------------------------------- #
# KV-cache quantization (decode tail)
# --------------------------------------------------------------------------- #
def quantize_kv(x, cfg: ModelConfig):
    if not cfg.kv_cache_dtype or cfg.kv_cache_dtype == cfg.dtype:
        return x
    s = cfg.kv_quant_scale
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(
        getattr(torch, cfg.kv_cache_dtype))


def dequantize_kv(x, cfg: ModelConfig):
    if not cfg.kv_cache_dtype or x.dtype == cfg.torch_dtype:
        return x
    return dequantize(x, cfg.kv_quant_scale, cfg.torch_dtype)


def local_attention(q, k, v, q_start: int, window: int, *,
                    q_chunk: int = 256):
    """Sliding-window causal attention, linear in sequence length.

    q, k, v: (B, S, H, D) aligned (kv covers the same positions as q plus any
    cached prefix to the left already included in k/v). Each Q chunk reads
    exactly the `window + q_chunk` keys that end at the chunk's end — O(S·W)
    in all. k and v are padded by `window + q_chunk` on the left and by the
    query padding on the right, so every chunk's slice lies inside them.
    (The reference pads only the left; its `dynamic_slice` then clamps the
    last chunk's start when S > q_chunk and S % q_chunk != 0, shifting that
    chunk's keys against their positions — ROADMAP queue 3, F7.)"""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    prefix = Skv - Sq  # cached tokens to the left of q
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    q_chunk = min(q_chunk, Sq)
    pq = (-Sq) % q_chunk
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    span = window + q_chunk  # keys visible to one q chunk
    k_pad = torch.nn.functional.pad(k, (0, 0, 0, 0, span, pq))
    v_pad = torch.nn.functional.pad(v, (0, 0, 0, 0, span, pq))
    outs = []
    for qs in range(0, Sq + pq, q_chunk):
        q_blk = q[:, qs:qs + q_chunk]
        start = prefix + qs + q_chunk  # k_pad index of the chunk's end - span
        k_blk = k_pad[:, start:start + span]
        v_blk = v_pad[:, start:start + span]
        qp = q_start + qs + torch.arange(q_chunk, device=dev)
        kp = q_start + qs + q_chunk - span + torch.arange(span, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(),
                         k_blk.float()) * scale
        ok = (kp[None, :] <= qp[:, None]) & (kp[None, :] > qp[:, None]
                                             - window)
        ok &= kp[None, :] >= 0
        s = torch.where(ok[None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float()))
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(q.dtype)


# --------------------------------------------------------------------------- #
# Flash attention with a recomputing backward (training memory)
#
# Autograd through `online_attention` saves every key chunk's online-softmax
# carriers (m, l, acc) and probabilities. `flash_attention` saves only
# (q, k, v, out, lse) and recomputes the probabilities chunk by chunk in its
# backward — the flash-attention backward in torch ops, the reference's
# custom-VJP `flash_attention` (reference models/attention.py).
# --------------------------------------------------------------------------- #
FLASH_KV_CHUNK = 512


def _flash_chunks(k, v, kv_chunk):
    """k, v padded with zero rows to whole chunks of `kv_chunk` keys."""
    Skv = k.shape[1]
    kv_chunk = min(kv_chunk, Skv)
    pk = (-Skv) % kv_chunk
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
    return k, v, kv_chunk


def _flash_mask(qpos, kpos, Skv, kv_start, causal, window):
    """(Sq, C) visibility of one key chunk: a real key (not the chunk's
    padding), at or before the query when causal, inside the window."""
    ok = (kpos[None, :] < Skv + kv_start).expand(qpos.shape[0], -1)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return ok


def _flash_fwd_impl(q, k, v, q_start, kv_start, causal, window, kv_chunk):
    """(out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) fp32): one online
    softmax over the key chunks, q whole."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    k, v, kv_chunk = _flash_chunks(k, v, kv_chunk)
    qpos = q_start + torch.arange(Sq, device=dev)
    qf = q.float()
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for j0 in range(0, k.shape[1], kv_chunk):
        k_blk, v_blk = k[:, j0:j0 + kv_chunk], v[:, j0:j0 + kv_chunk]
        kpos = kv_start + j0 + torch.arange(kv_chunk, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
        ok = _flash_mask(qpos, kpos, Skv, kv_start, causal, window)
        s = torch.where(ok[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   v_blk.float())
        m = m_new
    out = (acc / torch.clamp(l[..., None], min=1e-20)).transpose(1, 2)
    lse = m + torch.log(torch.clamp(l, min=1e-20))
    return out.to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, dout, q_start, kv_start, causal, window,
               kv_chunk):
    """(dq, dk, dv): the probabilities recomputed from lse chunk by chunk,
    Delta = rowsum(dout * out)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    kp, vp, kv_chunk = _flash_chunks(k, v, kv_chunk)
    qpos = q_start + torch.arange(Sq, device=dev)
    qf, do = q.float(), dout.float()
    delta = torch.einsum("bqhd,bqhd->bhq", do, out.float())
    dq = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for j0 in range(0, kp.shape[1], kv_chunk):
        k_blk, v_blk = kp[:, j0:j0 + kv_chunk].float(), \
            vp[:, j0:j0 + kv_chunk].float()
        kpos = kv_start + j0 + torch.arange(kv_chunk, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk) * scale
        ok = _flash_mask(qpos, kpos, Skv, kv_start, causal, window)
        p = torch.where(ok[None, None], torch.exp(s - lse[..., None]),
                        torch.zeros_like(s))
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, do))
        dp = torch.einsum("bqhd,bkhd->bhqk", do, v_blk)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_blk)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))
    dk = torch.cat(dks, dim=1)[:, :Skv]
    dv = torch.cat(dvs, dim=1)[:, :Skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_start, kv_start, causal, window, kv_chunk):
        out, lse = _flash_fwd_impl(q, k, v, q_start, kv_start, causal,
                                   window, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_start, kv_start, causal, window, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, q_start: int, kv_start: int, causal: bool,
                    window: int, kv_chunk: int = FLASH_KV_CHUNK):
    """q: (B, Sq, H, D); k, v: (B, Skv, H, D) (heads pre-expanded). Causal
    / sliding-window attention whose backward keeps O(1)-in-S residuals per
    key chunk: it saves (q, k, v, out, lse) and recomputes the rest."""
    return _FlashAttention.apply(q, k, v, q_start, kv_start, causal, window,
                                 kv_chunk)


# --------------------------------------------------------------------------- #
# Decode attention (two-branch flash-decode combine)
# --------------------------------------------------------------------------- #
def _partial_softmax(s, mask):
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), p


def decode_attention(q1, k_cache, v_cache, k_new, v_new, *, kv_lens=None,
                     window: int = 0, pos=None):
    """One-token GQA attention against cache + the freshly produced token.

    q1: (B, 1, H, D); caches: (B, L, Hkv, D); new: (B, 1, Hkv, D). A
    two-branch flash combine: the cache is read-only and never concatenated
    with the new token. With `window` and the token's position `pos`
    (scalar or (B,)), cache row idx is visible only if idx > pos - window:
    the cache starts at position 0, so a row's index is its position."""
    B, _, H, D = q1.shape
    L = k_cache.shape[1]
    Hkv = k_cache.shape[2]
    G = H // Hkv
    dev = q1.device
    scale = 1.0 / math.sqrt(D)
    qg = q1.reshape(B, Hkv, G, D).float()

    s_c = torch.einsum("bngd,blnd->bngl", qg, k_cache.float()) * scale
    idx = torch.arange(L, device=dev)
    mask_c = torch.ones((B, 1, 1, L), dtype=torch.bool, device=dev)
    if kv_lens is not None:
        mask_c &= idx[None, None, None, :] < kv_lens.to(dev)[:, None, None,
                                                             None]
    if window and pos is not None:
        p_ = torch.as_tensor(pos, device=dev)
        p_ = p_.reshape(-1, 1, 1, 1) if p_.dim() else p_
        mask_c &= idx[None, None, None, :] > (p_ - window)
    m_c, l_c, p_c = _partial_softmax(s_c, mask_c)
    o_c = torch.einsum("bngl,blnd->bngd", p_c, v_cache.float())

    s_n = torch.einsum("bngd,blnd->bngl", qg, k_new.float()) * scale
    m_n, l_n, p_n = _partial_softmax(s_n, torch.ones_like(s_n,
                                                          dtype=torch.bool))
    o_n = torch.einsum("bngl,blnd->bngd", p_n, v_new.float())

    m = torch.maximum(m_c, m_n)
    c_c, c_n = torch.exp(m_c - m), torch.exp(m_n - m)
    l = l_c * c_c + l_n * c_n
    out = (o_c * c_c[..., None] + o_n * c_n[..., None]) / torch.clamp(
        l[..., None], min=1e-20)
    return out.reshape(B, 1, H, D).to(q1.dtype)


# --------------------------------------------------------------------------- #
# Full attention blocks (projection + rope + attention + output)
# --------------------------------------------------------------------------- #
def _proj_qkv(attn: Attention, cfg: ModelConfig, x):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ attn.wq).reshape(B, S, cfg.n_heads, hd)
    k = (x @ attn.wk).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ attn.wv).reshape(B, S, cfg.n_kv_heads, hd)
    if attn.qk_norm:
        q = _qk_norm(q, attn.q_scale)
        k = _qk_norm(k, attn.k_scale)
    return q, k, v


def _check_impl(attention_impl: str):
    if attention_impl not in ATTN_IMPLS:
        raise ValueError(f"attention_impl {attention_impl!r} not in "
                         f"{ATTN_IMPLS}")


def _theta_window(cfg: ModelConfig, kind: str):
    """(RoPE theta, window) of a layer of `kind`."""
    if kind == ATTN_GLOBAL:
        return cfg.rope_theta, 0
    if kind == ATTN_LOCAL:
        return cfg.rope_theta_local, cfg.window
    raise ValueError(f"attention kind {kind!r} is not ported")


def gqa_prefill(attn: Attention, cfg: ModelConfig, kind: str, x,
                start_pos: int, prefix_kv: Optional[Dict] = None,
                kv_lens=None, prefix_start: Optional[int] = None,
                attention_impl: str = "torch"):
    """Prefill / append-prefill of a global or local (sliding-window) layer.
    Returns (out, {"k","v"} new-token cache).

    prefix_kv layouts:
      * default (prefix_start=None): the prefix buffer ends exactly at
        start_pos (contiguous history).
      * engine slots (prefix_start=0): the prefix buffer starts at position
        0 and may be right-padded beyond the live length; pass kv_lens to
        mask the padding.

    `attention_impl="cuda"` routes FRESH global-attention prefill (no
    prefix, no kv_lens masking, window 0) through the flash-prefill kernel
    K2, at any S: the kernel masks its ragged last tile. The other fresh
    prefills take the reference's branches in its order: `flash_attention`
    under `cfg.flash_vjp` (windows included), then `local_attention` for a
    local layer, then the online-softmax path (one chunk under
    `cfg.attn_block_full`). An append against an engine slot's prefix
    (prefix_start given, kv_lens masking it, window 0) whose q, new rows
    and prefix are all bf16 goes under "cuda" to K2's append instance
    (`ops.append_attention`); the slot's live rows precede the new tokens
    (kv_lens <= start_pos - prefix_start), so only kv_lens masks the
    prefix. The other prefix reads (an int8 or fp32 prefix, a local layer,
    a contiguous history) and kv_lens-masked cases take the online-softmax
    path (`prefix_attention`) with the layer's window."""
    _check_impl(attention_impl)
    B, S, _ = x.shape
    q, k, v = _proj_qkv(attn, cfg, x)
    theta, window = _theta_window(cfg, kind)
    pos = start_pos + torch.arange(S, device=x.device)
    q = apply_rope(q, pos, theta)
    k = apply_rope(k, pos, theta)
    new_cache = {"k": k, "v": v}

    if prefix_kv is not None:
        pk, pv = prefix_kv["k"], prefix_kv["v"]
        # The one routing point of K2's append instance. The kernel sees no
        # positions: it masks the prefix by kv_lens alone and takes every
        # live row as earlier than every new token. That holds because the
        # engine's appends and pool hits pass kv_lens = start_pos with
        # prefix_start = 0 (kv_lens <= start_pos - prefix_start); both may
        # be device tensors inside a graph, so it is not checked here.
        if (attention_impl == "cuda" and window == 0 and kv_lens is not None
                and prefix_start is not None
                and all(t.dtype == torch.bfloat16 for t in (q, k, pk))):
            from repro_torch.kernels import ops
            out = ops.append_attention(q, pk, pv, k, v, kv_lens, impl="cuda")
        else:
            # a quantized prefix is read dequantized, as decode reads it
            # (the reference concatenates its int8 rows as they are, F24)
            pstart = ((start_pos - pk.shape[1]) if prefix_start is None
                      else prefix_start)
            out = prefix_attention(q, dequantize_kv(pk, cfg),
                                   dequantize_kv(pv, cfg), k, v, pos, pstart,
                                   kv_lens, window=window)
    elif attention_impl == "cuda" and kv_lens is None and window == 0:
        from repro_torch.kernels import ops
        out = ops.prefill_attention(q, k, v, impl="cuda")
    else:
        kf = _repeat_kv(k, cfg.n_heads)
        vf = _repeat_kv(v, cfg.n_heads)
        if cfg.flash_vjp and kv_lens is None and not cfg.attn_block_full:
            out = flash_attention(q, kf, vf, start_pos, start_pos, True,
                                  window, FLASH_KV_CHUNK)
        elif window and not cfg.attn_block_full:
            out = local_attention(q, kf, vf, start_pos, window)
        else:
            ch = (1 << 30) if cfg.attn_block_full else 256
            out = online_attention(q, kf, vf, pos, pos, causal=True,
                                   window=window, kv_lens=kv_lens,
                                   q_chunk=ch, kv_chunk=ch)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ attn.wo, new_cache


def _trim_ctx(leaf, ctx_limit: Optional[int]):
    """A view of a growing cache leaf's length axis (axis 1) cut to the
    caller-provided live-length upper bound — the decode tail then reads
    only the live KV prefix instead of the whole max_ctx buffer."""
    if ctx_limit is None or leaf.shape[1] <= ctx_limit:
        return leaf
    return leaf[:, :ctx_limit]


def gqa_decode(attn: Attention, cfg: ModelConfig, kind: str, x1, position,
               cache: Dict, kv_lens=None, ctx_limit: Optional[int] = None,
               attention_impl: str = "torch"):
    """x1: (B,1,D); cache: {"k","v"} (B,L,Hkv,hd); position scalar or (B,).
    `ctx_limit` is an upper bound on kv_lens: the cache read is trimmed to
    it. `attention_impl="cuda"` serves a global layer's attention through
    the flash-decode kernel K1, which takes the new token as a second
    branch — nothing is scattered into the trimmed cache, so a slot longer
    than the trimmed read (an idle one) cannot index past it. A local layer,
    or a call without kv_lens, takes the two-branch torch combine with the
    layer's window. Returns (out, new_kv)."""
    _check_impl(attention_impl)
    q, k, v = _proj_qkv(attn, cfg, x1)
    theta, window = _theta_window(cfg, kind)
    q = rope_single(q, position, theta)
    k = rope_single(k, position, theta)
    k_c = _trim_ctx(cache["k"], ctx_limit)
    v_c = _trim_ctx(cache["v"], ctx_limit)
    if attention_impl == "cuda" and kv_lens is not None and window == 0:
        # an int8 cache goes to K1 as it is, with its scale: no dequantized
        # copy of it is made (the plain version for CPU tensors makes one)
        from repro_torch.kernels import ops
        scale = cfg.kv_quant_scale if k_c.dtype == torch.int8 else None
        out = ops.decode_attention(
            q[:, 0].contiguous(), k_c, v_c, kv_lens, impl="cuda",
            k_new=k[:, 0].contiguous(), v_new=v[:, 0].contiguous(),
            kv_scale=scale)[:, None]
    else:
        out = decode_attention(q, dequantize_kv(k_c, cfg),
                               dequantize_kv(v_c, cfg), k, v,
                               kv_lens=kv_lens, window=window, pos=position)
    out = out.reshape(x1.shape[0], 1, cfg.n_heads * cfg.head_dim)
    return out @ attn.wo, {"k": quantize_kv(k, cfg), "v": quantize_kv(v, cfg)}


# --------------------------------------------------------------------------- #
# MLA (multi-head latent attention)
# --------------------------------------------------------------------------- #
def _mla_q(attn: MLA, cfg: ModelConfig, x):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope)), before RoPE."""
    B, S, _ = x.shape
    q = ((x @ attn.w_dq) @ attn.w_uq if cfg.q_lora_rank else x @ attn.wq)
    q = q.reshape(B, S, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    return q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]


def _latent(attn: MLA, cfg: ModelConfig, x):
    """(ckv (B, S, rank), krope (B, S, rope)), before RoPE."""
    dkv = x @ attn.w_dkv
    return dkv[..., :cfg.kv_lora_rank], dkv[..., cfg.kv_lora_rank:]


def mla_prefill(attn: MLA, cfg: ModelConfig, x, start_pos,
                prefix_kv: Optional[Dict] = None, kv_lens=None,
                prefix_start: Optional[int] = None,
                attention_impl: str = "torch"):
    """Prefill / append-prefill of an MLA layer in the expanded form: the
    latent is expanded per head (K = [latent·W_uk, shared rope key], V =
    latent·W_uv padded to the QK dim) and attended causally; the absorbed
    form pays off only at decode. Returns (out, {"ckv", "krope"}): the new
    tokens' latent and rope key, what the cache stores. The prefix layouts
    and kv_lens are gqa_prefill's, and so is the prefix's padding to whole
    key chunks (a ctx bucket and the whole buffer then give the same
    bytes). Torch ops under both impls."""
    _check_impl(attention_impl)
    B, S, _ = x.shape
    theta = cfg.rope_theta
    pos = start_pos + torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_q(attn, cfg, x)
    q_rope = apply_rope(q_rope, pos, theta)
    ckv, krope = _latent(attn, cfg, x)
    krope = apply_rope(krope, pos, theta)
    new_cache = {"ckv": ckv, "krope": krope}

    kv_valid = None
    if prefix_kv is not None:
        P = prefix_kv["ckv"].shape[1]
        pad = (-P) % PREFIX_KV_CHUNK
        pstart = (start_pos - P) if prefix_start is None else prefix_start
        kv_pos = torch.cat([pstart + torch.arange(P, device=x.device),
                            pos.new_full((pad,), PAD_POS), pos])

        def rows(prefix, new):  # dequantized, as in gqa_prefill (F24)
            prefix = torch.nn.functional.pad(dequantize_kv(prefix, cfg),
                                             (0, 0, 0, pad))
            return torch.cat([prefix, new], dim=1)
        ckv_all = rows(prefix_kv["ckv"], ckv)
        krope_all = rows(prefix_kv["krope"], krope)
        if kv_lens is not None:
            kv_valid = torch.cat(
                [torch.arange(P + pad, device=x.device)[None, :]
                 < kv_lens.to(x.device)[:, None],
                 torch.ones((B, S), dtype=torch.bool, device=x.device)],
                dim=1)
            kv_lens = None
        chunks = dict(kv_chunk=PREFIX_KV_CHUNK)
    else:
        ckv_all, krope_all, kv_pos = ckv, krope, pos
        ch = (1 << 30) if cfg.attn_block_full else 256
        chunks = dict(q_chunk=ch, kv_chunk=ch)

    k_nope = torch.einsum("blr,rhd->blhd", ckv_all, attn.w_uk)
    vv = torch.einsum("blr,rhd->blhd", ckv_all, attn.w_uv)
    k_full = torch.cat([k_nope, krope_all[:, :, None, :].expand(
        *k_nope.shape[:3], cfg.qk_rope_dim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    vv = torch.nn.functional.pad(vv, (0, k_full.shape[-1] - vv.shape[-1]))
    out = online_attention(q_full, k_full, vv, pos, kv_pos, causal=True,
                           kv_lens=kv_lens, kv_valid=kv_valid, **chunks)
    out = out[..., :cfg.v_head_dim].reshape(B, S,
                                            cfg.n_heads * cfg.v_head_dim)
    return out @ attn.wo, new_cache


def mla_decode(attn: MLA, cfg: ModelConfig, x1, position, cache: Dict,
               kv_lens=None, ctx_limit: Optional[int] = None,
               attention_impl: str = "torch"):
    """Absorbed-matrix MLA decode: W_uk is folded into the query, so the
    scores are taken in the latent space against the cache's ckv (B, L,
    rank) and krope (B, L, rope) directly; the cached and the new token's
    branches are merged by their partial softmaxes; the latent context goes
    through W_uv per head after a cast to the model's dtype. The scores and
    the context are fp32 products of the operands (the reference's
    `preferred_element_type=float32`). Torch ops under both impls. Returns
    (out, the new token's {"ckv", "krope"})."""
    _check_impl(attention_impl)
    B = x1.shape[0]
    theta = cfg.rope_theta
    q_nope, q_rope = _mla_q(attn, cfg, x1)
    q_rope = rope_single(q_rope, position, theta)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, attn.w_uk)
    ckv_n, krope_n = _latent(attn, cfg, x1)
    krope_n = rope_single(krope_n, position, theta)
    new_cache = {"ckv": quantize_kv(ckv_n, cfg),
                 "krope": quantize_kv(krope_n, cfg)}
    ckv_c = dequantize_kv(_trim_ctx(cache["ckv"], ctx_limit), cfg).float()
    krope_c = dequantize_kv(_trim_ctx(cache["krope"], ctx_limit),
                            cfg).float()
    ckv_n, krope_n = ckv_n.float(), krope_n.float()
    q_lat, q_rope = q_lat.float(), q_rope.float()

    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    L = ckv_c.shape[1]
    s_c = (torch.einsum("bshr,blr->bshl", q_lat, ckv_c)
           + torch.einsum("bshd,bld->bshl", q_rope, krope_c)) * scale
    s_n = (torch.einsum("bshr,blr->bshl", q_lat, ckv_n)
           + torch.einsum("bshd,bld->bshl", q_rope, krope_n)) * scale
    mask_c = torch.ones((B, 1, 1, L), dtype=torch.bool, device=x1.device)
    if kv_lens is not None:
        mask_c &= (torch.arange(L, device=x1.device)[None, None, None, :]
                   < kv_lens.to(x1.device)[:, None, None, None])
    m_c, l_c, p_c = _partial_softmax(s_c, mask_c)
    m_n, l_n, p_n = _partial_softmax(s_n, torch.ones_like(s_n,
                                                          dtype=torch.bool))
    ctx_c = torch.einsum("bshl,blr->bshr", p_c, ckv_c)
    ctx_n = torch.einsum("bshl,blr->bshr", p_n, ckv_n)
    m = torch.maximum(m_c, m_n)
    c_c, c_n = torch.exp(m_c - m), torch.exp(m_n - m)
    l = l_c * c_c + l_n * c_n
    ctx = (ctx_c * c_c[..., None] + ctx_n * c_n[..., None]) / torch.clamp(
        l[..., None], min=1e-20)
    out = torch.einsum("bshr,rhd->bshd", ctx.to(x1.dtype), attn.w_uv)
    out = out.reshape(B, 1, cfg.n_heads * cfg.v_head_dim)
    return out @ attn.wo, new_cache


# --------------------------------------------------------------------------- #
# Cross attention (whisper's decoder)
# --------------------------------------------------------------------------- #
def encode_cross_kv(attn: Attention, cfg: ModelConfig, enc_out):
    """The encoder output's K/V for one decoder layer, {"k", "v"} (B, F,
    Hkv, hd): computed once by a fresh prefill and cached as fixed rows."""
    B, F, _ = enc_out.shape
    k = (enc_out @ attn.wk).reshape(B, F, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_out @ attn.wv).reshape(B, F, cfg.n_kv_heads, cfg.head_dim)
    return {"k": k, "v": v}


def cross_attention(attn: Attention, cfg: ModelConfig, x, enc_kv: Dict):
    """x: (B, S, D) attends to every one of the encoder's F rows
    (`enc_kv` {"k", "v"} (B, F, Hkv, hd)), with no mask and no RoPE: the
    non-causal `online_attention`, torch ops under both impls, as the
    reference runs it outside its kernels."""
    B, S, _ = x.shape
    q = (x @ attn.wq).reshape(B, S, cfg.n_heads, cfg.head_dim)
    kf = _repeat_kv(enc_kv["k"], cfg.n_heads)
    vf = _repeat_kv(enc_kv["v"], cfg.n_heads)
    F = kf.shape[1]
    out = online_attention(q, kf, vf, torch.arange(S, device=x.device),
                           torch.arange(F, device=x.device), causal=False)
    return out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ attn.wo
