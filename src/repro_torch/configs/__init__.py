"""Architecture config registry of the port. Only the paper's served model
(qwen3-0.6b) is ported so far; `get_config(arch)` returns its full published
config and `get_reduced(arch)` the family-preserving smoke-test reduction.
Every other architecture the JAX package knows raises `KeyError`."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig, reduced_config

_MODULES = {
    "qwen3-0.6b": "qwen3_0p6b",
}

# architectures of the reference package that this port does not serve yet
NOT_PORTED = ("gemma3-12b", "stablelm-12b", "nemotron-4-15b", "olmo-1b",
              "internvl2-26b", "deepseek-v2-lite-16b", "llama4-scout-17b-a16e",
              "rwkv6-3b", "whisper-small", "recurrentgemma-9b")

ALL_ARCHS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        if arch in NOT_PORTED:
            raise KeyError(f"arch {arch!r} is not ported to repro_torch yet; "
                           f"ported: {sorted(_MODULES)}")
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return reduced_config(get_config(arch))


__all__ = ["get_config", "get_reduced", "ALL_ARCHS", "NOT_PORTED"]
