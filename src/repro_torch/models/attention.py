"""Global GQA attention: blocked online-softmax prefill and append-prefill,
the two-branch decode against a slot cache, and the routes into the port's
CUDA kernels (`attention_impl="cuda"`).

Conventions follow the JAX package's `models/attention.py`: q, k, v are
(B, S, H, D); decode reads a cache (B, L, Hkv, D) that it never writes —
it returns the new token's K/V and the cache manager appends it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from .config import ModelConfig
from .layers import apply_rope, param, rope_freqs

NEG_INF = -1e30
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


def _repeat_kv(k, n_heads):
    """(B, T, Hkv, D) -> (B, T, H, D)."""
    reps = n_heads // k.shape[2]
    if reps == 1:
        return k
    return k.repeat_interleave(reps, dim=2)


# --------------------------------------------------------------------------- #
# Blocked online-softmax attention (the flash oracle)
# --------------------------------------------------------------------------- #
def online_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                     window: int = 0, q_chunk: int = 256, kv_chunk: int = 512,
                     kv_lens=None, kv_valid=None):
    """q: (B,Sq,H,D); k,v: (B,Skv,H,D); q_pos: (Sq,), kv_pos: (Skv,) int.

    Loops over Q chunks and, inside, over KV chunks with an online softmax —
    structurally the flash algorithm, bounding temporaries to
    (B, H, q_chunk, kv_chunk). `kv_lens` (B,) optionally masks per-batch
    ragged valid lengths; `kv_valid` (B, Skv) bool is the general per-entry
    validity mask (engine slot buffers)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    pq = (-Sq) % q_chunk
    pk = (-Skv) % kv_chunk
    q_pos = q_pos.to(dev)
    kv_pos = kv_pos.to(dev)
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
        q_pos = torch.cat([q_pos, q_pos.new_full((pq,), -1)])
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        kv_pos = torch.cat([kv_pos, kv_pos.new_full((pk,), 2**31 - 1)])
        if kv_valid is not None:
            kv_valid = torch.nn.functional.pad(kv_valid, (0, pk))
    outs = []
    for qs in range(0, Sq + pq, q_chunk):
        q_blk = q[:, qs:qs + q_chunk]
        qp = q_pos[qs:qs + q_chunk]
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_chunk, D), dtype=torch.float32,
                          device=dev)
        for ks in range(0, Skv + pk, kv_chunk):
            k_blk = k[:, ks:ks + kv_chunk]
            v_blk = v[:, ks:ks + kv_chunk]
            kp = kv_pos[ks:ks + kv_chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(),
                             k_blk.float()) * scale
            ok = (kp[None, :] >= 0) & (qp[:, None] >= 0)
            if causal:
                ok &= kp[None, :] <= qp[:, None]
            if window:
                ok &= kp[None, :] > qp[:, None] - window
            mask = ok[None, None]
            if kv_lens is not None:
                mask = mask & (kp[None, None, None, :]
                               < kv_lens.to(dev)[:, None, None, None])
            if kv_valid is not None:
                mask = mask & kv_valid[:, ks:ks + kv_chunk][:, None, None, :]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, v_blk.float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-20)
        outs.append(out.transpose(1, 2))  # (B, Cq, H, D)
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(q.dtype)


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
    return (x.float() * cfg.kv_quant_scale).to(cfg.torch_dtype)


# --------------------------------------------------------------------------- #
# Decode attention (two-branch flash-decode combine)
# --------------------------------------------------------------------------- #
def _partial_softmax(s, mask):
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), p


def decode_attention(q1, k_cache, v_cache, k_new, v_new, *, kv_lens=None):
    """One-token GQA attention against cache + the freshly produced token.

    q1: (B, 1, H, D); caches: (B, L, Hkv, D); new: (B, 1, Hkv, D). A
    two-branch flash combine: the cache is read-only and never concatenated
    with the new token."""
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


def gqa_prefill(attn: Attention, cfg: ModelConfig, x, start_pos: int,
                prefix_kv: Optional[Dict] = None,
                kv_lens=None, prefix_start: Optional[int] = None,
                attention_impl: str = "torch"):
    """Prefill / append-prefill. Returns (out, {"k","v"} new-token cache).

    prefix_kv layouts:
      * default (prefix_start=None): the prefix buffer ends exactly at
        start_pos (contiguous history).
      * engine slots (prefix_start=0): the prefix buffer starts at position
        0 and may be right-padded beyond the live length; pass kv_lens to
        mask the padding.

    `attention_impl="cuda"` routes FRESH global-attention prefill (no
    prefix, no kv_lens masking) through the flash-prefill kernel K2, at any
    S: the kernel masks its ragged last tile. Append-prefill prefix reads
    and kv_lens-masked cases take the online-softmax path below."""
    _check_impl(attention_impl)
    B, S, _ = x.shape
    q, k, v = _proj_qkv(attn, cfg, x)
    pos = start_pos + torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    new_cache = {"k": k, "v": v}

    if prefix_kv is not None:
        P = prefix_kv["k"].shape[1]
        pstart = (start_pos - P) if prefix_start is None else prefix_start
        kv_pos = torch.cat([pstart + torch.arange(P, device=x.device), pos])
        k_all = torch.cat([_repeat_kv(prefix_kv["k"], cfg.n_heads),
                           _repeat_kv(k, cfg.n_heads)], dim=1)
        v_all = torch.cat([_repeat_kv(prefix_kv["v"], cfg.n_heads),
                           _repeat_kv(v, cfg.n_heads)], dim=1)
        kv_valid = None
        if kv_lens is not None:
            # padding lives only in the prefix region; new tokens are valid
            kv_valid = torch.cat(
                [torch.arange(P, device=x.device)[None, :]
                 < kv_lens.to(x.device)[:, None],
                 torch.ones((B, S), dtype=torch.bool, device=x.device)],
                dim=1)
        out = online_attention(q, k_all, v_all, pos, kv_pos, causal=True,
                               kv_valid=kv_valid)
    elif attention_impl == "cuda" and kv_lens is None:
        from repro_torch.kernels import ops
        out = ops.prefill_attention(q, k, v, impl="cuda")
    else:
        kf = _repeat_kv(k, cfg.n_heads)
        vf = _repeat_kv(v, cfg.n_heads)
        out = online_attention(q, kf, vf, pos, pos, causal=True,
                               kv_lens=kv_lens, q_chunk=256, kv_chunk=256)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ attn.wo, new_cache


def _trim_ctx(leaf, ctx_limit: Optional[int]):
    """A view of a growing cache leaf's length axis (axis 1) cut to the
    caller-provided live-length upper bound — the decode tail then reads
    only the live KV prefix instead of the whole max_ctx buffer."""
    if ctx_limit is None or leaf.shape[1] <= ctx_limit:
        return leaf
    return leaf[:, :ctx_limit]


def gqa_decode(attn: Attention, cfg: ModelConfig, x1, position, cache: Dict,
               kv_lens=None, ctx_limit: Optional[int] = None,
               attention_impl: str = "torch"):
    """x1: (B,1,D); cache: {"k","v"} (B,L,Hkv,hd); position scalar or (B,).
    `ctx_limit` is an upper bound on kv_lens: the cache read is trimmed to
    it. `attention_impl="cuda"` serves the attention through the
    flash-decode kernel K1, which takes the new token as a second branch —
    nothing is scattered into the trimmed cache, so a slot longer than the
    trimmed read (an idle one) cannot index past it. Without kv_lens the
    two-branch torch combine runs. Returns (out, new_kv)."""
    _check_impl(attention_impl)
    q, k, v = _proj_qkv(attn, cfg, x1)
    q = rope_single(q, position, cfg.rope_theta)
    k = rope_single(k, position, cfg.rope_theta)
    k_c = dequantize_kv(_trim_ctx(cache["k"], ctx_limit), cfg)
    v_c = dequantize_kv(_trim_ctx(cache["v"], ctx_limit), cfg)
    if attention_impl == "cuda" and kv_lens is not None:
        from repro_torch.kernels import ops
        out = ops.decode_attention(
            q[:, 0].contiguous(), k_c, v_c, kv_lens, impl="cuda",
            k_new=k[:, 0].contiguous(), v_new=v[:, 0].contiguous())[:, None]
    else:
        out = decode_attention(q, k_c, v_c, k, v, kv_lens=kv_lens)
    out = out.reshape(x1.shape[0], 1, cfg.n_heads * cfg.head_dim)
    return out @ attn.wo, {"k": quantize_kv(k, cfg), "v": quantize_kv(v, cfg)}
