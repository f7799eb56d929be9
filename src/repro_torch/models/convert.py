"""Weights between the JAX package's params pytree and the port's modules.

The reference draws each leaf from a key folded with Python's salted
`hash(path)`, so its weights differ from process to process: a test that
compares the two packages converts the reference's params in the same
process. The tree is nested dicts of numpy arrays in the reference's layout
— {"embed": {"w"}, "final_norm": {"scale"}, "unembed": {} (tied) or {"w"}
(untied), "groups": {"p0": {"ln1", "ln2", "attn", "mlp"}}} for global GQA,
{"ln1", "ln2", "tmix", "cmix"} for RWKV6, with the layers stacked on a
leading axis — and the leaves keep their shapes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import ModelConfig
from .transformer import LM


def _block_leaves(block) -> Dict[str, Dict[str, torch.Tensor]]:
    """One block's parameters under the reference's names: its submodules
    (ln1, ln2 and the kind's mixer and FFN) and their leaves."""
    return {sub: dict(mod.named_parameters())
            for sub, mod in block.named_children()}


@torch.no_grad()
def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> LM:
    """Build the port's LM on `device` (default "cuda") from a params tree of
    numpy arrays, unstacking the leading layer axis into one Block per
    layer. Every leaf must match the module's shape; dtypes follow cfg."""
    lm = LM(cfg, resolve_device(device))

    def put(dst: torch.Tensor, src, where: str):
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{where}: shape {arr.shape} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))

    put(lm.embed.w, tree["embed"]["w"], "embed.w")
    put(lm.final_norm.scale, tree["final_norm"]["scale"], "final_norm.scale")
    if not cfg.tie_embeddings:
        put(lm.unembed.w, tree["unembed"]["w"], "unembed.w")
    node = tree["groups"]["p0"]
    for i, block in enumerate(lm.blocks):
        for sub, leaves in _block_leaves(block).items():
            for n, dst in leaves.items():
                put(dst, np.asarray(node[sub][n])[i], f"{sub}.{n}[{i}]")
    return lm


@torch.no_grad()
def params_to_numpy(lm: LM) -> Dict[str, Any]:
    """The reverse of `params_from_numpy`: the reference's tree, as float32
    numpy arrays, with the layers restacked under "groups"/"p0"."""
    np_ = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    per = [_block_leaves(b) for b in lm.blocks]
    return {
        "embed": {"w": np_(lm.embed.w)},
        "final_norm": {"scale": np_(lm.final_norm.scale)},
        "unembed": {n: np_(t) for n, t in lm.unembed.named_parameters()},
        "groups": {"p0": {sub: {n: np.stack([np_(b[sub][n]) for b in per])
                                for n in per[0][sub]} for sub in per[0]}},
    }
