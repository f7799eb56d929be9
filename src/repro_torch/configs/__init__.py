"""Architecture config registry of the port: the paper's served model
(qwen3-0.6b), the reference's dense family (olmo-1b, stablelm-12b,
nemotron-4-15b, gemma3-12b), rwkv6-3b, recurrentgemma-9b, the two MoE
models (deepseek-v2-lite-16b with MLA, llama4-scout-17b-a16e), the vision
frontend (internvl2-26b) and the encoder-decoder (whisper-small): every
architecture the JAX package knows. `get_config(arch)` returns the full
published config and `get_reduced(arch)` the family-preserving smoke-test
reduction. `NOT_PORTED` names what the registry would refuse as not ported
yet; it is empty. `ASSIGNED` is the reference's list of the architectures
its dry run covers (all but the paper's own qwen3-0.6b), and `SHAPES` its
four input-shape sets (`shapes.py`, a copy of the reference's file)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig, reduced_config

_MODULES = {
    "qwen3-0.6b": "qwen3_0p6b",
    "olmo-1b": "olmo_1b",
    "stablelm-12b": "stablelm_12b",
    "nemotron-4-15b": "nemotron4_15b",
    "gemma3-12b": "gemma3_12b",
    "rwkv6-3b": "rwkv6_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "internvl2-26b": "internvl2_26b",
    "whisper-small": "whisper_small",
}

# architectures of the reference package that this port does not serve yet
NOT_PORTED: tuple = ()

# the reference's order (its `_MODULES` order), which `dryrun --all` walks
ASSIGNED: List[str] = [
    "gemma3-12b", "stablelm-12b", "nemotron-4-15b", "olmo-1b",
    "internvl2-26b", "deepseek-v2-lite-16b", "llama4-scout-17b-a16e",
    "rwkv6-3b", "whisper-small", "recurrentgemma-9b"]
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


from .shapes import SHAPES, ShapeSpec, get_shape  # noqa: E402

__all__ = ["get_config", "get_reduced", "ASSIGNED", "ALL_ARCHS",
           "NOT_PORTED", "SHAPES", "ShapeSpec", "get_shape"]
