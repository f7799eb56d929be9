"""K4: the RG-LRU gated linear recurrence of RecurrentGemma
(`csrc/rglru.cu`), its plain PyTorch version, and the wrapper that launches
the kernel.

Replaces the JAX package's Pallas kernel `rglru_pallas`
(src/repro/kernels/rglru_kernel.py). h_t = exp(log_a_t) h_{t-1} + b_t over
log_a, b (B, S, W), each float32 or bfloat16, from h0 (B, W) float32.
Returns h_all (B, S, W) and h_T (B, W), both float32, for any S >= 1 and any
W (no chunk or channel-block multiple). The kernel is a blocked scan in one
launch: 8 time segments of a tile scan at once and a carry joins them.

The wrapper launches on `torch.cuda.current_stream()` and adds one to
`rglru_cuda.launches` per launch; nothing else touches that count. It takes
CUDA tensors only: `ops.rglru_scan` sends CPU tensors to `rglru_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import rglru_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def rglru_plain(log_a, b, h0):
    """The same function as the kernel: the step-by-step recurrence of
    `ref.rglru_ref`, in float32."""
    return rglru_ref(log_a, b, h0)


def _fn():
    global _FN
    if _FN is None:
        f = _build.load("rglru").repro_rglru
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
        _FN = f
    return _FN


def rglru_cuda(log_a, b, h0):
    """Launch K4 on CUDA tensors. log_a, b (B, S, W), each float32 or
    bfloat16; h0 (B, W) float32; all contiguous, S >= 1. Returns
    (h_all, h_T), float32."""
    tensors = (log_a, b, h0)
    if any(t.device.type != "cuda" or t.device != log_a.device
           for t in tensors):
        raise ValueError("rglru_cuda takes CUDA tensors on one device; CPU "
                         "tensors go to rglru_plain")
    if log_a.dtype not in _DTYPES or b.dtype not in _DTYPES:
        raise ValueError(f"dtypes {log_a.dtype}, {b.dtype}: log_a and b "
                         "must each be float32 or bfloat16")
    if h0.dtype != torch.float32:
        raise ValueError(f"dtype {h0.dtype}: h0 must be float32")
    if log_a.dim() != 3:
        raise ValueError(f"log_a must be (B, S, W), got {tuple(log_a.shape)}")
    B, S, W = log_a.shape
    if S < 1:
        raise ValueError("rglru_cuda needs S >= 1")
    if tuple(b.shape) != (B, S, W):
        raise ValueError(f"b: shape {tuple(b.shape)} != {(B, S, W)}")
    if tuple(h0.shape) != (B, W):
        raise ValueError(f"h0: shape {tuple(h0.shape)} != {(B, W)}")
    for name, t in (("log_a", log_a), ("b", b), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{t.stride()}")
    h_all = torch.empty((B, S, W), dtype=torch.float32, device=log_a.device)
    h_T = torch.empty((B, W), dtype=torch.float32, device=log_a.device)
    fn = _fn()
    with torch.cuda.device(log_a.device):
        stream = torch.cuda.current_stream(log_a.device).cuda_stream
        rc = fn(log_a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                h_all.data_ptr(), h_T.data_ptr(), B, S, W,
                _DTYPES[log_a.dtype], _DTYPES[b.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rglru kernel launch failed: cudaError {rc}")
    rglru_cuda.launches += 1
    return h_all, h_T


rglru_cuda.launches = 0
