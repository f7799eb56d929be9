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
