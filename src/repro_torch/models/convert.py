"""Weights between the JAX package's params pytree and the port's modules.

The reference draws each leaf from a key folded with Python's salted
`hash(path)`, so its weights differ from process to process: a test that
compares the two packages converts the reference's params in the same
process. The tree is nested dicts of numpy arrays in the reference's layout
— {"embed": {"w"}, "final_norm": {"scale"} ({} for nonparametric_ln),
"unembed": {} (tied) or {"w"} (untied), "groups": {"p{j}": block}, "rem":
{"p{j}": block}} with a block
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
    (ln1, ln2 and the kind's mixer and FFN) and their leaves — {} for a
    norm without parameters (nonparametric_ln)."""
    return {sub: dict(mod.named_parameters())
            for sub, mod in block.named_children()}


def _same_names(dst: Dict, src: Dict, where: str) -> None:
    """Raise unless the module's leaves and the tree's carry the same names
    (a norm without a scale, an MLP without wg: absent on both sides)."""
    if set(dst) != set(src):
        only_t = sorted(set(src) - set(dst))
        only_m = sorted(set(dst) - set(src))
        raise ValueError(f"{where}: leaves differ — in the params tree only "
                         f"{only_t}, in the module only {only_m}")


def _top_leaves(lm: LM) -> Dict[str, Dict[str, torch.Tensor]]:
    """embed, final_norm and unembed's parameters under the reference's
    names ({} for a tied unembedding or a parameter-free norm)."""
    return {sub: dict(getattr(lm, sub).named_parameters())
            for sub in ("embed", "final_norm", "unembed")}


@torch.no_grad()
def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> LM:
    """Build the port's LM on `device` (default "cuda") from a params tree of
    numpy arrays, unstacking the leading layer axis into one Block per
    layer. Every leaf must match the module's shape, and the two must hold
    the same leaves (a leaf on one side only raises, naming it); dtypes
    follow cfg."""
    lm = LM(cfg, resolve_device(device))

    def put(dst: torch.Tensor, src, where: str):
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{where}: shape {arr.shape} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))

    for sub, leaves in _top_leaves(lm).items():
        _same_names(leaves, tree.get(sub, {}), sub)
        for n, dst in leaves.items():
            put(dst, tree[sub][n], f"{sub}.{n}")
    for (sec, key, g), block in zip(layer_places(cfg), lm.blocks):
        node = tree[sec][key]
        where = f"{sec}.{key}"
        blocks = _block_leaves(block)
        _same_names(blocks, node, where)
        for sub, leaves in blocks.items():
            _same_names(leaves, node[sub], f"{where}.{sub}")
            for n, dst in leaves.items():
                src = np.asarray(node[sub][n])
                put(dst, src if g is None else src[g],
                    f"{where}.{sub}.{n}" + ("" if g is None else f"[{g}]"))
    return lm


@torch.no_grad()
def params_to_numpy(lm: LM) -> Dict[str, Any]:
    """The reverse of `params_from_numpy`: the reference's tree, as float32
    numpy arrays, with the layers restacked under "groups"/"p{j}" and the
    remainder under "rem"/"p{j}"; a module without a leaf (a
    parameter-free norm, an MLP without wg) gives none."""
    np_ = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    by_key: Dict[tuple, list] = {}
    for (sec, key, _), b in zip(layer_places(lm.cfg), lm.blocks):
        by_key.setdefault((sec, key), []).append(
            {sub: {n: np_(t) for n, t in leaves.items()}
             for sub, leaves in _block_leaves(b).items()})
    tree: Dict[str, Any] = {
        sub: {n: np_(t) for n, t in leaves.items()}
        for sub, leaves in _top_leaves(lm).items()}
    for (sec, key), per in by_key.items():
        tree.setdefault(sec, {})[key] = (
            {sub: {n: np.stack([b[sub][n] for b in per]) for n in per[0][sub]}
             for sub in per[0]} if sec == "groups" else per[0])
    return tree
