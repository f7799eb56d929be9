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

The kernel cuts each (sequence, KV head)'s key axis into splits, one block
each, and merges them in a second pass from the same C entry point. The
split is planned by `plan_decode_splits` from the shapes alone: the wrapper
never reads `lengths` on the host, so a launch needs no sync and can be
captured in a CUDA graph.

The cache may be int8 (the quantized decode tail, `kv_cache_dtype="int8"`):
it then stands for int8 x kv_scale, and the kernel reads the int8 rows
themselves — half the bytes of bf16 — while q, the new token and the output
keep the model's dtype. The plain version dequantizes first, as the model's
`dequantize_kv` does, and so defines the rounding.

The wrapper launches on `torch.cuda.current_stream()` and adds one to
`flash_decode_attention.launches` per call (the split kernel and its
combine count as one launch of K1); nothing else touches that count. It takes CUDA tensors only:
`ops.decode_attention` sends CPU tensors to `decode_attention_plain`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

# the head dims and group sizes K1 is instantiated for (csrc/decode_attention.cu),
# every pair with G * D <= MAX_GD: D = 160 serves stablelm-12b (G = 4), 240
# gemma3-12b's global layers (G = 2), G = 6 nemotron-4-15b (D = 128), G = 5
# llama4-scout-17b-a16e (D = 128)
HEAD_DIMS = (16, 32, 64, 128, 160, 240)
GROUPS = (1, 2, 4, 5, 6, 8, 16)
MAX_GD = 2048
# an int8 cache: every G at D = 128 (qwen3-0.6b's G = 2, olmo-1b's 1,
# nemotron-4-15b's and internvl2-26b's 6, llama4-scout-17b-a16e's 5)
INT8_HEAD_DIMS = (128,)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None
# about four blocks of K1 per SM of the H100 (132 SMs): the split kernel's
# 128-register threads leave room for four resident blocks on each
TARGET_BLOCKS = 4 * 132


def key_chunk(D: int, kv_itemsize: int = 2, G: int = 1) -> int:
    """The shortest split of K1, in keys: the rows one block loads per
    round of its loop at its deepest unroll (4 warps x 8 loads x the rows
    a warp instruction covers). A float cache is planned as bf16 at every
    G: 64 at D = 128 and 32 at D = 160 and 240. An int8 cache follows the
    kernel's piece rule (`DecodeShape::VEC`): 16 values a piece at G <= 4,
    8 at G = 5-8 and 4 at G = 16, so 128, 64 and 32 keys at D = 128. A
    shorter split costs a combine and saves no round."""
    # values in one row piece, then the lanes that load one row: its pieces
    # rounded up to a power of two, at most 32 (a row of 20 or 30 leaves
    # lanes idle)
    vec = 8 if kv_itemsize > 1 else min(16, 1 << ((64 // G).bit_length() - 1))
    pieces = D // vec
    lanes = min(32, 1 << max(0, (pieces - 1).bit_length()))
    return 4 * 8 * (32 // lanes)


@functools.lru_cache(maxsize=None)
def plan_decode_splits(B: int, Hkv: int, S: int, D: int,
                       kv_itemsize: int = 2, G: int = 1):
    """(n_split, split_len) of K1's key axis: S + 1 positions (the cache,
    then the new token) cut into n_split ranges of split_len keys, one
    block per (split, KV head, sequence). A function of the shapes only —
    never of the live lengths — so the launch needs nothing from the
    device. Enough splits for ~TARGET_BLOCKS blocks, but no more than the
    whole chunks of `key_chunk(D, kv_itemsize, G)` keys in S + 1 (G = H /
    Hkv), and none empty at the full length. Cached: a served model asks
    for a handful of shapes, once per layer and step."""
    n_keys = S + 1
    want = -(-TARGET_BLOCKS // max(1, B * Hkv))
    n = max(1, min(want, n_keys // key_chunk(D, kv_itemsize, G)))
    split_len = -(-n_keys // n)
    return -(-n_keys // split_len), split_len


def dequantize(x, kv_scale: float, dtype):
    """An int8 cache's rows as the values they stand for: x times kv_scale,
    computed in fp32 and rounded to `dtype`. The one dequantizer of the
    port: the model's `dequantize_kv` and K1's plain version both call it,
    so they define the same rounding."""
    return (x.float() * kv_scale).to(dtype)


def decode_attention_plain(q, k, v, lengths, k_new=None, v_new=None,
                           kv_scale=None):
    """The same function as the kernel, materialized in fp32: masked scores
    over the live cache (plus the new token), max-subtracted exponentials,
    normalised by max(l, 1e-20). An int8 cache is dequantized first to q's
    dtype (`kv_scale` given) by `dequantize`. Returns (B, H, D) in q's
    dtype."""
    if k.dtype == torch.int8:
        k, v = (dequantize(t, kv_scale, q.dtype) for t in (k, v))
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
        f.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                      + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                         ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_float, ctypes.c_void_p])
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
                           = None, v_new: Optional[torch.Tensor] = None,
                           kv_scale: Optional[float] = None):
    """Launch K1 on CUDA tensors. q (B, H, D) contiguous; k, v (B, S, Hkv, D)
    with contiguous inner dims and equal strides; lengths (B,) int32;
    k_new, v_new (B, Hkv, D) contiguous or both None. float32 or bfloat16,
    head_dim D in HEAD_DIMS = (16, 32, 64, 128, 160, 240), G = H / Hkv in
    GROUPS = (1, 2, 4, 5, 6, 8, 16) with G * D <= MAX_GD (2048), every tensor
    16-byte aligned (the kernel loads 16 bytes at a time). k, v may instead
    be int8 with `kv_scale` (D in INT8_HEAD_DIMS); q, k_new, v_new are then
    still float32 or bfloat16. Raises on any other shape. Returns (B, H,
    D) in q's dtype."""
    tensors = [q, k, v] + ([k_new, v_new] if k_new is not None else [])
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_decode_attention takes CUDA tensors on one "
                         "device; CPU tensors go to decode_attention_plain")
    if (k_new is None) != (v_new is None):
        raise ValueError("pass k_new and v_new together")
    kv_int8 = k.dtype == torch.int8
    want_kv = torch.int8 if kv_int8 else q.dtype
    if q.dtype not in _DTYPES or k.dtype != want_kv or v.dtype != want_kv \
            or any(t.dtype != q.dtype for t in tensors[3:]):
        raise ValueError(f"dtypes {[t.dtype for t in tensors]}: q, k_new, "
                         "v_new one of float32, bfloat16, and the cache "
                         "k, v the same or int8")
    if kv_int8 != (kv_scale is not None):
        raise ValueError("kv_scale is given with an int8 cache, and only "
                         "then")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous (B, H, D), got "
                         f"{tuple(q.shape)}")
    B, H, D = q.shape
    if k.dim() != 4:
        raise ValueError(f"k must be (B, S, Hkv, D), got {tuple(k.shape)}")
    S, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if kv_int8 and D not in INT8_HEAD_DIMS:
        raise ValueError(f"head_dim {D} with an int8 cache: not "
                         f"instantiated (only {INT8_HEAD_DIMS})")
    if H % Hkv or H // Hkv not in GROUPS:
        raise ValueError(f"H={H}, Hkv={Hkv}: H/Hkv must be one of {GROUPS}")
    if (H // Hkv) * D > MAX_GD:
        raise ValueError(f"G={H // Hkv} x head_dim {D} > {MAX_GD}: not "
                         "instantiated")
    _check_kv("k", k, B, S, Hkv, D)
    _check_kv("v", v, B, S, Hkv, D)
    if k.stride() != v.stride():
        raise ValueError(f"k, v strides differ: {k.stride()} {v.stride()}")
    if k_new is not None:
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if tuple(t.shape) != (B, Hkv, D) or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous {(B, Hkv, D)}"
                                 f", got {tuple(t.shape)}")
    if any(t.data_ptr() % 16 for t in tensors) or (
            k.stride(0) * k.element_size()) % 16:
        raise ValueError("q, k, v, k_new, v_new and k's batch stride must "
                         "be 16-byte aligned")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != {(B,)}")
    out = torch.empty_like(q)
    n_split, split_len = plan_decode_splits(B, Hkv, S, D, k.element_size(),
                                             H // Hkv)
    scratch = (torch.empty(n_split * B * H * (D + 2), dtype=torch.float32,
                           device=q.device) if n_split > 1 else None)
    fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_new.data_ptr() if k_new is not None else None,
                v_new.data_ptr() if v_new is not None else None,
                lengths.data_ptr(), out.data_ptr(),
                scratch.data_ptr() if scratch is not None else None,
                B, S, H, Hkv, D, k.stride(0), n_split, split_len,
                1.0 / math.sqrt(D), _DTYPES[q.dtype], int(kv_int8),
                float(kv_scale or 0.0), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
