"""Weights between the JAX package's params pytree and the port's modules.

The reference draws each leaf from a key folded with Python's salted
`hash(path)`, so its weights differ from process to process: a test that
compares the two packages converts the reference's params in the same
process. The tree is nested dicts of numpy arrays in the reference's layout
— {"embed": {"w"}, "final_norm": {"scale"} ({} for nonparametric_ln),
"unembed": {} (tied) or {"w"} (untied), "groups": {"p{j}": block}, "rem":
{"p{j}": block}} with a block
{"ln1", "ln2", "attn", "mlp"} for GQA or MLA attention ("moe" in place of
"mlp" in a MoE config: "router", the stacked experts and a nested "shared"
MLP), {"ln1", "ln2", "tmix", "cmix"} for RWKV6 and {"ln1", "ln2", "rglru",
"mlp"} for RG-LRU; "groups" blocks have the pattern's repetitions stacked
on a leading axis, "rem" blocks do not (`transformer.layer_places`) — and
the leaves keep their shapes. An encoder-decoder's tree is {"embed",
"encoder": encoder blocks {"ln1", "attn", "ln2", "mlp"}, "enc_norm",
"decoder": decoder blocks {"ln1", "attn", "lnx", "cross", "ln2", "mlp"},
"final_norm", "unembed"}, each stack with the layer on a leading axis; the
frontends' stubs hold no weights. Each leaf takes its module's dtype (a
MoE's router stays float32 in a bf16 model).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import ModelConfig
from .model import build_model
from .transformer import layer_places


def _leaves_of(mod) -> Dict[str, Any]:
    """A module's parameters under the reference's names, nested as its
    submodules are: a block's ln1, ln2 and the kind's mixer and FFN, a
    MoE's "shared" MLP — {} for a norm without parameters
    (nonparametric_ln)."""
    tree: Dict[str, Any] = dict(mod.named_parameters(recurse=False))
    tree.update({sub: _leaves_of(child)
                 for sub, child in mod.named_children()})
    return tree


def _same_names(dst: Dict, src: Dict, where: str) -> None:
    """Raise unless the module's leaves and the tree's carry the same names
    (a norm without a scale, an MLP without wg: absent on both sides)."""
    if set(dst) != set(src):
        only_t = sorted(set(src) - set(dst))
        only_m = sorted(set(dst) - set(src))
        raise ValueError(f"{where}: leaves differ — in the params tree only "
                         f"{only_t}, in the module only {only_m}")


def _top_names(cfg: ModelConfig):
    """The tree's entries that are not a stack of layers."""
    return (("embed", "enc_norm", "final_norm", "unembed")
            if cfg.is_encoder_decoder else ("embed", "final_norm", "unembed"))


def _top_leaves(lm) -> Dict[str, Dict[str, torch.Tensor]]:
    """embed, final_norm and unembed's parameters (and an encoder-decoder's
    enc_norm) under the reference's names ({} for a tied unembedding or a
    parameter-free norm)."""
    return {sub: _leaves_of(getattr(lm, sub)) for sub in _top_names(lm.cfg)}


def _names_of(mod, prefix: str) -> Dict[str, Any]:
    """`_leaves_of`'s tree with each leaf's full parameter name in the
    port's module (prefix + dotted path) in place of the tensor."""
    tree: Dict[str, Any] = {n: prefix + n for n, _ in
                            mod.named_parameters(recurse=False)}
    tree.update({sub: _names_of(child, f"{prefix}{sub}.")
                 for sub, child in mod.named_children()})
    return tree


def reference_leaves(lm) -> List[Tuple[str, List[str], bool]]:
    """The reference's params tree as its flat leaves, in its flatten order
    (dict keys sorted at every level, an empty dict giving no leaf): for
    each leaf (its `jax.tree_util.keystr` string, such as
    "['groups']['p0']['attn']['wq']", the port's parameter names that make
    it, stacked). A stacked leaf ("groups" and an encoder-decoder's
    "encoder" and "decoder") is its names' tensors stacked on a new leading
    axis in layer order; an unstacked one has one name."""
    prefix = "blocks" if not lm.cfg.is_encoder_decoder else None
    tree: Dict[str, Any] = {sub: _names_of(getattr(lm, sub), f"{sub}.")
                            for sub in _top_names(lm.cfg)}
    stacked: Dict[Tuple[str, Optional[str]], list] = {}
    for i, ((sec, key, _), block) in enumerate(_stacks(lm)):
        at = (f"{prefix}.{i}." if prefix else
              f"{sec}.{len(stacked.get((sec, key), []))}.")
        stacked.setdefault((sec, key), []).append(_names_of(block, at))

    def merge(per):
        return {n: merge([b[n] for b in per]) if isinstance(v, dict)
                else [b[n] for b in per] for n, v in per[0].items()}

    for (sec, key), per in stacked.items():
        node = merge(per) if sec != "rem" else per[0]
        if key is None:
            tree[sec] = node
        else:
            tree.setdefault(sec, {})[key] = node
    out: List[Tuple[str, List[str], bool]] = []

    def walk(node, path: str, stack: bool):
        for n in sorted(node):
            at = f"{path}[{n!r}]"
            if isinstance(node[n], dict):
                walk(node[n], at, stack)
            else:
                names = node[n] if isinstance(node[n], list) else [node[n]]
                out.append((at, names, stack))

    for top in sorted(tree):
        stack = top in ("groups", "encoder", "decoder")
        walk({top: tree[top]}, "", stack)
    return out


def _stacks(lm):
    """(the tree's place of each layer, its block): ((sec, key, g), block)
    for a decoder-only LM (`transformer.layer_places`), ((stack, None, i),
    block) for an encoder-decoder's "encoder" and "decoder"."""
    if lm.cfg.is_encoder_decoder:
        return [((sec, None, i), b) for sec in ("encoder", "decoder")
                for i, b in enumerate(getattr(lm, sec))]
    return list(zip(layer_places(lm.cfg), lm.blocks))


@torch.no_grad()
def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None):
    """Build the port's model (`Model.module`) on `device` (default
    "cuda") from a params tree of numpy arrays, unstacking the leading
    layer axis into one block per layer. Every leaf must match the module's
    shape, and the two must hold the same leaves (a leaf on one side only
    raises, naming it); dtypes follow cfg."""
    lm = build_model(cfg).module(resolve_device(device))

    def load(dst: Dict[str, Any], src: Dict[str, Any], where: str,
             g: Optional[int]):
        _same_names(dst, src, where)
        for n, t in dst.items():
            at = f"{where}.{n}" if where else n
            if isinstance(t, dict):
                load(t, src[n], at, g)
                continue
            arr = np.asarray(src[n])
            if g is not None:
                arr, at = arr[g], f"{at}[{g}]"
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{at}: shape {arr.shape} != "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))

    load(_top_leaves(lm), {sub: tree.get(sub, {}) for sub in
                           _top_names(cfg)}, "", None)
    for (sec, key, g), block in _stacks(lm):
        node = tree[sec] if key is None else tree[sec][key]
        load(_leaves_of(block), node, sec if key is None else
             f"{sec}.{key}", g)
    return lm


@torch.no_grad()
def params_to_numpy(lm) -> Dict[str, Any]:
    """The reverse of `params_from_numpy`: the reference's tree, as float32
    numpy arrays, with the layers restacked under "groups"/"p{j}" and the
    remainder under "rem"/"p{j}"; a module without a leaf (a
    parameter-free norm, an MLP without wg) gives none."""
    def to_np(node):
        return {n: to_np(t) if isinstance(t, dict)
                else t.detach().float().cpu().numpy()
                for n, t in node.items()}

    def stack(per):
        return {n: stack([b[n] for b in per]) if isinstance(v, dict)
                else np.stack([b[n] for b in per])
                for n, v in per[0].items()}

    by_key: Dict[tuple, list] = {}
    for (sec, key, _), b in _stacks(lm):
        by_key.setdefault((sec, key), []).append(to_np(_leaves_of(b)))
    tree: Dict[str, Any] = to_np(_top_leaves(lm))
    for (sec, key), per in by_key.items():
        if key is None:  # an encoder-decoder's stack
            tree[sec] = stack(per)
            continue
        tree.setdefault(sec, {})[key] = (stack(per) if sec == "groups"
                                         else per[0])
    return tree
