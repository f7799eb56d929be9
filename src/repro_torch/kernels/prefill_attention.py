"""K2: causal (optionally sliding-window) flash prefill attention
(`csrc/prefill_attention.cu`), its plain PyTorch version, and the wrapper
that launches the kernel; and K2's append instance, an append's queries
against the slot's cached prefix and then the new keys, with its own plain
version and wrapper.

Replaces the JAX package's Pallas kernel `flash_prefill_attention`
(src/repro/kernels/prefill_attention.py). Layouts are the model's: q
(B, S, H, D), k, v (B, S, Hkv, D) with H a multiple of Hkv — the kernel reads
KV head h // G itself, so GQA needs no expanded copy. Any S works: the
ragged last tile is masked in the kernel. bf16 runs on the tensor cores
(`mma.sync`, P rounded to bf16 before P·V as in the Pallas kernel); fp32
runs on the CUDA cores in full fp32.

The append instance (`append_mma_kernel`, then `append_combine_kernel`)
replaces no Pallas kernel: the JAX package attends an append in jnp ops
that XLA fuses. It packs a KV head's G query heads as rows of one tile, cuts
the prefix and the new keys into ranges of `APPEND_SPLIT` rows, one block
each, and merges the ranges in a fixed order, so the bytes it gives depend
on the live rows alone: a prefix trimmed to its ctx bucket and the whole
buffer agree. It is bf16 only, on the tensor cores like K2's bf16 path.

Each wrapper launches on `torch.cuda.current_stream()` and adds one to its
own `.launches` per call (the append kernel and its combine count as one);
nothing else touches those counts. They take CUDA tensors only:
`ops.prefill_attention` and `ops.append_attention` send CPU tensors to the
plain versions.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import causal_attention_ref, prefix_attention

# the head dims K2 is instantiated for (csrc/prefill_attention.cu): 160 serves
# stablelm-12b, 240 gemma3-12b's global layers; any G = H / Hkv
HEAD_DIMS = (16, 32, 64, 128, 160, 240)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K/V rows one block of the append instance reads at most: the kernel's
# kAppendSplit, which it checks
APPEND_SPLIT = 1024
_FN = None
_APPEND_FN = None


def prefill_attention_plain(q, k, v, *, window: int = 0):
    """The same function as the kernel: KV heads expanded to H, then the
    materialized causal softmax of `ref.causal_attention_ref`."""
    reps = q.shape[2] // k.shape[2]
    if reps > 1:
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    return causal_attention_ref(q, k, v, window=window)


def _fn():
    global _FN
    if _FN is None:
        f = _build.load("prefill_attention").repro_prefill_attention
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _FN = f
    return _FN


def flash_prefill_attention(q, k, v, *, window: int = 0):
    """Launch K2 on CUDA tensors. q (B, S, H, D), k, v (B, S, Hkv, D), all
    contiguous and 16-byte aligned, float32 or bfloat16 (bf16 runs on the
    tensor cores), head_dim D in HEAD_DIMS = (16, 32, 64, 128, 160, 240),
    any H a multiple of Hkv. Raises on any other shape. Returns
    (B, S, H, D)."""
    if any(t.device.type != "cuda" or t.device != q.device for t in (q, k, v)):
        raise ValueError("flash_prefill_attention takes CUDA tensors on one "
                         "device; CPU tensors go to prefill_attention_plain")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: all must "
                         "be one of float32, bfloat16")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if tuple(k.shape) != (B, S, Hkv, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k, v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    out = torch.empty_like(q)
    fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, H, Hkv, D, int(window), 1.0 / math.sqrt(D),
                _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"prefill_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0


def append_attention_plain(q, k, v, k_new, v_new, kv_lens):
    """The same function as the append instance, computed as the model
    computes every append off the kernel (`ref.prefix_attention`): KV heads
    expanded, the prefix padded with masked rows to whole `PREFIX_KV_CHUNK`
    chunks, the new keys after it, and `online_attention`'s fp32 chunks
    with the prefix rows at or past kv_lens masked and the new keys causal.
    q (B, S, H, D); k, v (B, P, Hkv, D); k_new, v_new (B, S, Hkv, D);
    kv_lens (B,)."""
    S, P = q.shape[1], k.shape[1]
    # the queries after every prefix row: only kv_lens masks the prefix
    pos = P + torch.arange(S, device=q.device)
    return prefix_attention(q, k, v, k_new, v_new, pos, 0, kv_lens)


def _append_fn():
    global _APPEND_FN
    if _APPEND_FN is None:
        f = _build.load("prefill_attention").repro_append_attention
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                      + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                         ctypes.c_void_p])
        _APPEND_FN = f
    return _APPEND_FN


def flash_append_attention(q, k, v, k_new, v_new, kv_lens):
    """Launch K2's append instance on CUDA tensors, all bfloat16: q (B, S,
    H, D) and k_new, v_new (B, S, Hkv, D) contiguous; the prefix k, v (B,
    P, Hkv, D) with contiguous inner dims and equal strides (a view of a
    longer buffer is fine); kv_lens (B,) on the device. Prefix rows at or
    past kv_lens are masked, the new keys are causal. Head dim D in
    HEAD_DIMS, any H a multiple of Hkv, every tensor and the prefix's batch
    stride 16-byte aligned. Raises on anything else. Returns (B, S, H, D)."""
    tensors = (q, k, v, k_new, v_new)
    if any(t.device.type != "cuda" or t.device != q.device
           for t in tensors + (kv_lens,)):
        raise ValueError("flash_append_attention takes CUDA tensors on one "
                         "device; CPU tensors go to append_attention_plain")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"dtypes {[t.dtype for t in tensors]}: all must be "
                         "bfloat16")
    if any(t.dim() != 4 for t in tensors):
        raise ValueError("q, k, v, k_new, v_new must be 4-d")
    B, S, H, D = q.shape
    P, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, P, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"prefix k, v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if tuple(k_new.shape) != (B, S, Hkv, D) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new, v_new shapes {tuple(k_new.shape)}, "
                         f"{tuple(v_new.shape)}: want {(B, S, Hkv, D)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if not (q.is_contiguous() and k_new.is_contiguous()
            and v_new.is_contiguous()):
        raise ValueError("q, k_new, v_new must be contiguous")
    if k.stride()[1:] != (Hkv * D, D, 1) or k.stride() != v.stride():
        raise ValueError(f"prefix k, v: the (P, Hkv, D) dims must be "
                         f"contiguous and the strides equal, got "
                         f"{k.stride()}, {v.stride()}")
    if any(t.data_ptr() % 16 for t in tensors) or (k.stride(0) * 2) % 16:
        raise ValueError("q, k, v, k_new, v_new and the prefix's batch "
                         "stride must be 16-byte aligned")
    kv_lens = kv_lens.to(torch.int32).contiguous()
    if tuple(kv_lens.shape) != (B,):
        raise ValueError(f"kv_lens shape {tuple(kv_lens.shape)} != {(B,)}")
    out = torch.empty_like(q)
    n_split = -(-P // APPEND_SPLIT) + -(-S // APPEND_SPLIT)
    scratch = torch.empty(n_split * B * S * H * (D + 2), dtype=torch.float32,
                          device=q.device)
    fn = _append_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_new.data_ptr(),
                v_new.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), B, S, P, H, Hkv, D, k.stride(0),
                APPEND_SPLIT, 1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"append_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_append_attention.launches += 1
    return out


flash_append_attention.launches = 0
