"""Dispatch between the port's CUDA kernels and their plain versions.

`impl="cuda"` launches the hand-written kernel for a CUDA tensor and uses
the plain PyTorch version for a CPU tensor — only because the tensor lies on
the CPU. `impl="torch"` always takes the plain version. There is no fallback
that hides a failed launch: a CUDA tensor the kernel does not take raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .decode_attention import decode_attention_plain, flash_decode_attention
from .prefill_attention import flash_prefill_attention, prefill_attention_plain

IMPLS = ("cuda", "torch")
KERNELS = {"decode_attention": flash_decode_attention,
           "prefill_attention": flash_prefill_attention}


def _use_kernel(x: torch.Tensor, impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "torch" or x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


def prefill_attention(q, k, v, *, window: int = 0, impl: str = "cuda"):
    """q: (B, S, H, D); k, v: (B, S, Hkv, D) — causal (optionally
    sliding-window) attention."""
    if _use_kernel(q, impl):
        return flash_prefill_attention(q, k, v, window=window)
    return prefill_attention_plain(q, k, v, window=window)


def decode_attention(q, k, v, lengths=None, *, impl: str = "cuda",
                     max_len: Optional[int] = None, k_new=None, v_new=None):
    """q: (B, H, D); k, v: (B, S, Hkv, D); lengths: (B,). Flash-decode GQA,
    optionally with the fresh token as a second branch (k_new, v_new:
    (B, Hkv, D)). `max_len` bounds the live lengths: the cache is trimmed to
    it, rounded up to a multiple of 128, before either version reads it."""
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
        return flash_decode_attention(q, k, v, lengths, k_new, v_new)
    return decode_attention_plain(q, k, v, lengths, k_new, v_new)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
