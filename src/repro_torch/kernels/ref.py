"""Plain PyTorch oracles mirroring the JAX package's `kernels/ref.py`.
Deliberately naive (materialized scores) and written independently of the
model code, so kernel sweeps test against a second implementation."""
from __future__ import annotations

import math

import torch


def causal_attention_ref(q, k, v, *, window: int = 0):
    """q,k,v: (B, S, H, D) (same head count — GQA expanded by caller).
    Full materialized causal softmax attention."""
    B, S, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = j <= i
    if window:
        mask &= j > i - window
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def decode_attention_ref(q, k, v, lengths=None):
    """q: (B, H, D); k,v: (B, S, Hkv, D); lengths: (B,) valid KV lengths.
    One-token GQA attention."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bngd,bsnd->bngs", qg, k.float()) / math.sqrt(D)
    if lengths is not None:
        mask = (torch.arange(S, device=q.device)[None, None, None, :]
                < lengths.to(q.device)[:, None, None, None])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngs,bsnd->bngd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def wkv6_ref(r, k, v, logw, u, state):
    """Step-by-step WKV6 recurrence (the slow oracle).
    r, k, v: (B, S, H, hs); logw: (B, S, H, hs) (< 0); u: (H, hs);
    state: (B, H, hs, hs) [key, value] layout. Returns (y (B, S, H, hs),
    final_state), both float32."""
    S = r.shape[1]
    rf, kf, vf = r.float(), k.float(), v.float()
    uf = u.float()[None]
    s_ = state.float()
    ys = []
    for t in range(S):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], logw[:, t].float()
        a = torch.einsum("bhi,bhv->bhiv", kt, vt)  # outer product
        ys.append(torch.einsum("bhi,bhiv->bhv", rt, s_)
                  + torch.einsum("bhi,bhi->bh", rt, uf * kt)[..., None] * vt)
        s_ = torch.exp(wt)[..., None] * s_ + a
    if not ys:
        return rf.new_zeros(r.shape), s_
    return torch.stack(ys, dim=1), s_


def rglru_ref(log_a, b, h0):
    """Step-by-step gated linear recurrence: h_t = exp(log_a_t)*h_{t-1}+b_t.
    log_a, b: (B, S, W); h0: (B, W). Returns (h_all (B, S, W), h_final),
    both float32."""
    a = torch.exp(log_a.float())
    bf = b.float()
    h = h0.float()
    hs = []
    for t in range(b.shape[1]):
        h = a[:, t] * h + bf[:, t]
        hs.append(h)
    if not hs:
        return bf.new_zeros(b.shape), h
    return torch.stack(hs, dim=1), h
