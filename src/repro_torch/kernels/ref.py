"""Plain PyTorch oracles mirroring the JAX package's `kernels/ref.py`.
Deliberately naive (materialized scores) and written independently of the
model code, so kernel sweeps test against a second implementation.

Besides them, the blocked online-softmax attention that the model's torch
path runs (`online_attention`) and its prefix form (`prefix_attention`), an
append's queries against a slot's prefix and then the new keys: the plain
version of K2's append instance is `prefix_attention`, so the model imports
both from here."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
PREFIX_KV_CHUNK = 512  # key chunk of an (append-)prefill against a prefix
PAD_POS = 2**31 - 1  # the position of a key row that only pads a chunk


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


# --------------------------------------------------------------------------- #
# Blocked online-softmax attention (the model's torch path)
# --------------------------------------------------------------------------- #
def repeat_kv(k, n_heads):
    """(B, T, Hkv, D) -> (B, T, H, D)."""
    reps = n_heads // k.shape[2]
    if reps == 1:
        return k
    return k.repeat_interleave(reps, dim=2)


def online_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                     window: int = 0, q_chunk: int = 256, kv_chunk: int = 512,
                     kv_lens=None, kv_valid=None):
    """q: (B,Sq,H,D); k,v: (B,Skv,H,D); q_pos: (Sq,), kv_pos: (Skv,) int.

    Loops over Q chunks and, inside, over KV chunks with an online softmax —
    structurally the flash algorithm, bounding temporaries to
    (B, H, q_chunk, kv_chunk). `kv_lens` (B,) optionally masks per-batch
    ragged valid lengths; `kv_valid` (B, Skv) bool is the general per-entry
    validity mask (engine slot buffers).

    The keys are padded with zero rows to whole chunks, at position
    2**31 - 1. A causal mask drops them; without one (`causal=False`: the
    encoder and cross-attention) the reference lets each add exp(-m) to the
    softmax's denominator whenever Skv is not a multiple of kv_chunk — 36
    phantom keys in each of whisper's 1500-frame attentions (ROADMAP queue
    3, F17). Here they are masked by their position."""
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
        kv_pos = torch.cat([kv_pos, kv_pos.new_full((pk,), PAD_POS)])
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
            else:  # F17: the pad keys
                ok &= kp[None, :] != PAD_POS
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


def prefix_attention(q, k, v, k_new, v_new, pos, prefix_start, kv_lens=None,
                     *, window: int = 0):
    """Queries at positions `pos` (S,) against a prefix k, v (B, P, Hkv, D)
    at positions prefix_start.. (rows at or past kv_lens masked), then the
    new keys k_new, v_new (B, S, Hkv, D) at `pos`, causal, with the
    layer's window: the online-softmax chunks of `online_attention` in
    fp32, KV heads expanded.

    The prefix is padded with masked rows to whole key chunks, so the new
    tokens' keys always start a chunk: a prefix trimmed to its ctx bucket
    and the whole max_ctx buffer then run the same chunks, the buffer's
    extra ones fully masked (exact no-ops), and give the same bytes on any
    device, not only where a sum's order does not depend on its length."""
    B, S, H, _ = q.shape
    P = k.shape[1]
    pad = (-P) % PREFIX_KV_CHUNK
    dev = q.device
    kv_pos = torch.cat([prefix_start + torch.arange(P, device=dev),
                        pos.new_full((pad,), PAD_POS), pos])

    def keys(prefix, new):
        prefix = torch.nn.functional.pad(repeat_kv(prefix, H),
                                         (0, 0, 0, 0, 0, pad))
        return torch.cat([prefix, repeat_kv(new, H)], dim=1)
    kv_valid = None
    if kv_lens is not None:
        # padding lives only in the prefix region; new tokens are valid
        kv_valid = torch.cat(
            [torch.arange(P + pad, device=dev)[None, :]
             < kv_lens.to(dev)[:, None],
             torch.ones((B, S), dtype=torch.bool, device=dev)], dim=1)
    return online_attention(q, keys(k, k_new), keys(v, v_new), pos, kv_pos,
                            causal=True, window=window, kv_valid=kv_valid,
                            kv_chunk=PREFIX_KV_CHUNK)
