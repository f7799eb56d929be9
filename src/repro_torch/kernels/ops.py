"""Dispatch between the port's CUDA kernels and their plain versions.

`impl="cuda"` launches the hand-written kernel for a CUDA tensor and uses
the plain PyTorch version for a CPU tensor — only because the tensor lies on
the CPU. `impl="torch"` always takes the plain version. There is no fallback
that hides a failed launch: a CUDA tensor the kernel does not take raises.

The kernels have no backward: a launch's output carries no `grad_fn`, so
a launch inside a training step would silently cut the gradient of
everything upstream. A launch with grad mode on and an input that requires
grad raises (`_refuse_grad`); training runs `attention_impl="torch"`, the
reference's train path, and never reaches a kernel.

Each wrapper counts its launches (`launch_counts`). A replayed CUDA graph
calls no wrapper, so the replica's programs (`engine.programs`) add what
their capture counted on every replay (`add_launches`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .decode_attention import decode_attention_plain, flash_decode_attention
from .prefill_attention import (append_attention_plain,
                                flash_append_attention,
                                flash_prefill_attention,
                                prefill_attention_plain)
from .rglru import rglru_cuda, rglru_plain
from .wkv6 import wkv6_cuda, wkv6_plain

IMPLS = ("cuda", "torch")
KERNELS = {"decode_attention": flash_decode_attention,
           "prefill_attention": flash_prefill_attention,
           "append_attention": flash_append_attention,
           "wkv6": wkv6_cuda,
           "rglru": rglru_cuda}


def _use_kernel(x: torch.Tensor, impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "torch" or x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


def _refuse_grad(kernel: str, *tensors) -> None:
    """Raise if a launch of `kernel` would sit inside autograd: grad mode on
    and an input that requires grad. There is no quiet fallback to the
    plain version."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an input "
            "requires grad — its output would cut the gradient; train with "
            'attention_impl="torch"')


def prefill_attention(q, k, v, *, window: int = 0, impl: str = "cuda"):
    """q: (B, S, H, D); k, v: (B, S, Hkv, D) — causal (optionally
    sliding-window) attention."""
    if _use_kernel(q, impl):
        _refuse_grad("prefill_attention", q, k, v)
        return flash_prefill_attention(q, k, v, window=window)
    return prefill_attention_plain(q, k, v, window=window)


def append_attention(q, k, v, k_new, v_new, kv_lens, *, impl: str = "cuda"):
    """q: (B, S, H, D); the prefix k, v: (B, P, Hkv, D), rows at or past
    kv_lens (B,) masked; the new k_new, v_new: (B, S, Hkv, D), causal — an
    append's attention (K2's append instance, bf16)."""
    if _use_kernel(q, impl):
        _refuse_grad("append_attention", q, k, v, k_new, v_new)
        return flash_append_attention(q, k, v, k_new, v_new, kv_lens)
    return append_attention_plain(q, k, v, k_new, v_new, kv_lens)


def decode_attention(q, k, v, lengths=None, *, impl: str = "cuda",
                     max_len: Optional[int] = None, k_new=None, v_new=None,
                     kv_scale: Optional[float] = None):
    """q: (B, H, D); k, v: (B, S, Hkv, D); lengths: (B,). Flash-decode GQA,
    optionally with the fresh token as a second branch (k_new, v_new:
    (B, Hkv, D)). `max_len` bounds the live lengths: the cache is trimmed to
    it, rounded up to a multiple of 128, before either version reads it.
    An int8 cache (int8 x `kv_scale`) goes to the kernel as it is; the
    plain version dequantizes it first. A shape the kernel has no int8
    instance for raises, as any shape it does not take does."""
    S = k.shape[1]
    if lengths is None and max_len is not None and max_len < S:
        raise ValueError("max_len < S requires lengths (see "
                         "flash_decode_attention)")
    if max_len is not None:
        s = min(S, -(-int(max_len) // 128) * 128)
        k, v = k[:, :s], v[:, :s]
    if lengths is None:
        lengths = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                             device=q.device)
    if _use_kernel(q, impl):
        _refuse_grad("decode_attention", q, k, v, k_new, v_new)
        return flash_decode_attention(q, k, v, lengths, k_new, v_new,
                                      kv_scale)
    return decode_attention_plain(q, k, v, lengths, k_new, v_new, kv_scale)


def wkv6(r, k, v, logw, u, state, *, impl: str = "cuda"):
    """WKV6: r, k, v, logw (B, S, H, hs); u (H, hs); state (B, H, hs, hs)
    float32. Returns (y, final_state), both float32."""
    if _use_kernel(r, impl):
        _refuse_grad("wkv6", r, k, v, logw, u, state)
        return wkv6_cuda(r, k, v, logw, u, state)
    return wkv6_plain(r, k, v, logw, u, state)


def rglru_scan(log_a, b, h0, *, impl: str = "cuda"):
    """Gated linear recurrence h_t = exp(log_a_t) h_{t-1} + b_t: log_a, b
    (B, S, W); h0 (B, W) float32. Returns (h_all, h_T), both float32."""
    if _use_kernel(log_a, impl):
        _refuse_grad("rglru", log_a, b, h0)
        return rglru_cuda(log_a, b, h0)
    return rglru_plain(log_a, b, h0)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    set_launch_counts({name: 0 for name in KERNELS})


def set_launch_counts(counts: Dict[str, int]) -> None:
    for name, fn in KERNELS.items():
        fn.launches = counts[name]


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Count `times` replays of a captured CUDA graph that holds `counts`
    launches of each kernel: a replay runs them without calling a wrapper
    (`engine.programs`)."""
    for name, n in counts.items():
        KERNELS[name].launches += n * times
