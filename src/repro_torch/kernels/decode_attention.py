"""K1: flash-decode GQA attention (`csrc/decode_attention.cu`), its plain
PyTorch version, and the wrapper that launches the kernel.

Replaces the JAX package's Pallas kernel `flash_decode_attention`
(src/repro/kernels/decode_attention.py). The function is one query token per
sequence against its KV cache: q (B, H, D), cache k, v (B, S, Hkv, D) — a
view with a free batch stride is fine, so a cache trimmed to a ctx bucket is
passed without a copy — and per-sequence live lengths, clamped to S. An
optional new token k_new, v_new (B, Hkv, D) is attended to as one more key
after the live cache (the two-branch form of the model's decode attention),
so the caller never has to scatter it into the cache first: no write can
land past a buffer whatever a slot's length is.

The wrapper launches on `torch.cuda.current_stream()` and adds one to
`flash_decode_attention.launches` per launch; nothing else touches that
count. It takes CUDA tensors only: `ops.decode_attention` sends CPU tensors
to `decode_attention_plain`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128)
GROUPS = (1, 2, 4, 8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def decode_attention_plain(q, k, v, lengths, k_new=None, v_new=None):
    """The same function as the kernel, materialized in fp32: masked scores
    over the live cache (plus the new token), max-subtracted exponentials,
    normalised by max(l, 1e-20). Returns (B, H, D) in q's dtype."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bngd,bsnd->bngs", qg, k.float()) * scale
    live = lengths.to(q.device).clamp(0, S)
    mask = (torch.arange(S, device=q.device)[None, :] < live[:, None])
    mask = mask[:, None, None, :].expand_as(s)
    vv = v.float()
    if k_new is not None:
        s_n = torch.einsum("bngd,bnd->bng", qg, k_new.float())[..., None]
        s = torch.cat([s, s_n * scale], dim=-1)
        mask = torch.cat([mask, torch.ones_like(s_n, dtype=torch.bool)], -1)
        vv = torch.cat([vv, v_new.float()[:, None]], dim=1)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bngs,bsnd->bngd", p, vv) / torch.clamp(l, min=1e-20)
    return out.reshape(B, H, D).to(q.dtype)


def _fn():
    global _FN
    if _FN is None:
        f = _build.load("decode_attention").repro_decode_attention
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                      + [ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                         ctypes.c_void_p])
        _FN = f
    return _FN


def _check_kv(name, x, B, S, Hkv, D):
    if tuple(x.shape) != (B, S, Hkv, D):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != "
                         f"{(B, S, Hkv, D)}")
    if x.stride()[1:] != (Hkv * D, D, 1):
        raise ValueError(f"{name}: the (S, Hkv, D) dims must be contiguous, "
                         f"got strides {x.stride()}")


def flash_decode_attention(q, k, v, lengths, k_new: Optional[torch.Tensor]
                           = None, v_new: Optional[torch.Tensor] = None):
    """Launch K1 on CUDA tensors. q (B, H, D) contiguous; k, v (B, S, Hkv, D)
    with contiguous inner dims and equal strides; lengths (B,) int32;
    k_new, v_new (B, Hkv, D) contiguous or both None. float32 or bfloat16,
    head_dim in HEAD_DIMS, H / Hkv in GROUPS. Returns (B, H, D)."""
    tensors = [q, k, v] + ([k_new, v_new] if k_new is not None else [])
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_decode_attention takes CUDA tensors on one "
                         "device; CPU tensors go to decode_attention_plain")
    if (k_new is None) != (v_new is None):
        raise ValueError("pass k_new and v_new together")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"dtypes {[t.dtype for t in tensors]}: all must be "
                         "one of float32, bfloat16")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous (B, H, D), got "
                         f"{tuple(q.shape)}")
    B, H, D = q.shape
    if k.dim() != 4:
        raise ValueError(f"k must be (B, S, Hkv, D), got {tuple(k.shape)}")
    S, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if H % Hkv or H // Hkv not in GROUPS:
        raise ValueError(f"H={H}, Hkv={Hkv}: H/Hkv must be one of {GROUPS}")
    _check_kv("k", k, B, S, Hkv, D)
    _check_kv("v", v, B, S, Hkv, D)
    if k.stride() != v.stride():
        raise ValueError(f"k, v strides differ: {k.stride()} {v.stride()}")
    if k_new is not None:
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if tuple(t.shape) != (B, Hkv, D) or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous {(B, Hkv, D)}"
                                 f", got {tuple(t.shape)}")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != {(B,)}")
    out = torch.empty_like(q)
    fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_new.data_ptr() if k_new is not None else None,
                v_new.data_ptr() if v_new is not None else None,
                lengths.data_ptr(), out.data_ptr(), B, S, H, Hkv, D,
                k.stride(0), 1.0 / math.sqrt(D), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
