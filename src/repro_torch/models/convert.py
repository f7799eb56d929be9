"""Weights between the JAX package's params pytree and the port's modules.

The reference draws each leaf from a key folded with Python's salted
`hash(path)`, so its weights differ from process to process: a test that
compares the two packages converts the reference's params in the same
process. The tree is nested dicts of numpy arrays in the reference's layout
— {"embed": {"w"}, "final_norm": {"scale"}, "unembed": {} (tied) or {"w"}
(untied), "groups": {"p{j}": block}, "rem": {"p{j}": block}} with a block
{"ln1", "ln2", "attn", "mlp"} for GQA attention, {"ln1", "ln2", "tmix",
"cmix"} for RWKV6 and {"ln1", "ln2", "rglru", "mlp"} for RG-LRU; "groups"
blocks have the pattern's repetitions stacked on a leading axis, "rem"
blocks do not (`transformer.layer_places`) — and the leaves keep their
shapes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import ModelConfig
from .transformer import LM, layer_places


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
    for (sec, key, g), block in zip(layer_places(cfg), lm.blocks):
        node = tree[sec][key]
        for sub, leaves in _block_leaves(block).items():
            for n, dst in leaves.items():
                src = np.asarray(node[sub][n])
                put(dst, src if g is None else src[g],
                    f"{sec}.{key}.{sub}.{n}" + ("" if g is None else f"[{g}]"))
    return lm


@torch.no_grad()
def params_to_numpy(lm: LM) -> Dict[str, Any]:
    """The reverse of `params_from_numpy`: the reference's tree, as float32
    numpy arrays, with the layers restacked under "groups"/"p{j}" and the
    remainder under "rem"/"p{j}"."""
    np_ = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    by_key: Dict[tuple, list] = {}
    for (sec, key, _), b in zip(layer_places(lm.cfg), lm.blocks):
        by_key.setdefault((sec, key), []).append(
            {sub: {n: np_(t) for n, t in leaves.items()}
             for sub, leaves in _block_leaves(b).items()})
    tree: Dict[str, Any] = {
        "embed": {"w": np_(lm.embed.w)},
        "final_norm": {"scale": np_(lm.final_norm.scale)},
        "unembed": {n: np_(t) for n, t in lm.unembed.named_parameters()},
    }
    for (sec, key), per in by_key.items():
        tree.setdefault(sec, {})[key] = (
            {sub: {n: np.stack([b[sub][n] for b in per]) for n in per[0][sub]}
             for sub in per[0]} if sec == "groups" else per[0])
    return tree
