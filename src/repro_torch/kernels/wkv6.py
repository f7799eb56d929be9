"""K3: the WKV6 recurrence of RWKV6 (`csrc/wkv6.cu`), its plain PyTorch
version, and the wrapper that launches the kernel.

Replaces the JAX package's Pallas kernel `wkv6_pallas`
(src/repro/kernels/rwkv6_kernel.py). r, k, v, logw (B, S, H, hs) in the
model's layout — the kernel reads them through their strides, so a view
needs no copy as long as its hs axis is contiguous — a bonus u (H, hs) and
a carried state (B, H, hs, hs) in [key, value] layout. Returns y
(B, S, H, hs) and the final state, both float32, for any S (no chunk
multiple, no padding). The kernel is chunk-parallel in one launch: chunks
of 8 tokens run at once from a zero state, and only the state is carried
from chunk to chunk (its header gives the plan and its bound).

The wrapper launches on `torch.cuda.current_stream()` and adds one to
`wkv6_cuda.launches` per launch; nothing else touches that count. It takes
CUDA tensors only: `ops.wkv6` sends CPU tensors to `wkv6_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import wkv6_ref

HEAD_SIZES = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def wkv6_plain(r, k, v, logw, u, state):
    """The same function as the kernel: the step-by-step recurrence of
    `ref.wkv6_ref`, in float32."""
    return wkv6_ref(r, k, v, logw, u, state)


def _fn():
    global _FN
    if _FN is None:
        f = _build.load("wkv6").repro_wkv6
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        _FN = f
    return _FN


def wkv6_cuda(r, k, v, logw, u, state):
    """Launch K3 on CUDA tensors. r, k, v (B, S, H, hs) of one dtype,
    float32 or bfloat16; logw (B, S, H, hs) float32; each with a unit hs
    stride (other strides free). u (H, hs) and state (B, H, hs, hs)
    contiguous float32. hs in HEAD_SIZES. Returns (y, final_state)."""
    tensors = (r, k, v, logw, u, state)
    if any(t.device.type != "cuda" or t.device != r.device for t in tensors):
        raise ValueError("wkv6_cuda takes CUDA tensors on one device; CPU "
                         "tensors go to wkv6_plain")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"dtypes {r.dtype}, {k.dtype}, {v.dtype}: r, k, v "
                         "must all be float32 or all bfloat16")
    if any(t.dtype != torch.float32 for t in (logw, u, state)):
        raise ValueError(f"dtypes {logw.dtype}, {u.dtype}, {state.dtype}: "
                         "logw, u and state must be float32")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, hs), got {tuple(r.shape)}")
    B, S, H, hs = r.shape
    if hs not in HEAD_SIZES:
        raise ValueError(f"head size {hs} not in {HEAD_SIZES}")
    for name, t in (("k", k), ("v", v), ("logw", logw)):
        if tuple(t.shape) != (B, S, H, hs):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{(B, S, H, hs)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the hs axis must be contiguous, got "
                             f"strides {t.stride()}")
    if tuple(u.shape) != (H, hs) or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous {(H, hs)}, got "
                         f"{tuple(u.shape)}")
    if tuple(state.shape) != (B, H, hs, hs) or not state.is_contiguous():
        raise ValueError(f"state must be a contiguous {(B, H, hs, hs)}, got "
                         f"{tuple(state.shape)}")
    y = torch.empty((B, S, H, hs), dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(state)
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (r, k, v, logw) for s in t.stride()[:3]])
    fn = _fn()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                u.data_ptr(), state.data_ptr(), y.data_ptr(),
                s_out.data_ptr(), B, S, H, hs, ctypes.addressof(strides),
                _DTYPES[r.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: cudaError {rc}")
    wkv6_cuda.launches += 1
    return y, s_out


wkv6_cuda.launches = 0
