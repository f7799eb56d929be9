"""K2: causal (optionally sliding-window) flash prefill attention
(`csrc/prefill_attention.cu`), its plain PyTorch version, and the wrapper
that launches the kernel.

Replaces the JAX package's Pallas kernel `flash_prefill_attention`
(src/repro/kernels/prefill_attention.py). Layouts are the model's: q
(B, S, H, D), k, v (B, S, Hkv, D) with H a multiple of Hkv — the kernel reads
KV head h // G itself, so GQA needs no expanded copy. Any S works: the
ragged last tile is masked in the kernel. bf16 runs on the tensor cores
(`mma.sync`, P rounded to bf16 before P·V as in the Pallas kernel); fp32
runs on the CUDA cores in full fp32.

The wrapper launches on `torch.cuda.current_stream()` and adds one to
`flash_prefill_attention.launches` per launch; nothing else touches that
count. It takes CUDA tensors only: `ops.prefill_attention` sends CPU
tensors to `prefill_attention_plain`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import causal_attention_ref

# the head dims K2 is instantiated for (csrc/prefill_attention.cu): 160 serves
# stablelm-12b, 240 gemma3-12b's global layers; any G = H / Hkv
HEAD_DIMS = (16, 32, 64, 128, 160, 240)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


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
