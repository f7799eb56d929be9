"""DTensor placements for every parameter, cache and batch leaf: the
reference's PartitionSpec assignment (`repro/models/sharding.py`) on torch's
`DeviceMesh`.

Strategy (the reference's):
  * Weights: Megatron-style TP on the `model` axis — Q heads, d_ff, vocab and
    experts are the sharded dimensions; GQA K/V projections stay replicated.
  * Batch/token dims: sharded over (`pod`, `data`) — `dp_axes`.
  * Decode KV caches: batch over the data axes, KV *length* over `model`
    (context-parallel decode).

A spec here is the reference's: one entry per tensor dim, None, an axis name
or a tuple of axis names (major to minor). `to_placements` turns it into
one `Placement` per mesh dim: a tensor dim on an axis is `Shard(dim)` on
that mesh dim. DTensor splits over the mesh dims in their order, so a dim on
("pod", "data") is split over pod first, then over data — JAX's
major-to-minor order, as long as the tuple lists the axes in the mesh's
order (anything else raises).

The port keeps one module per layer, where the reference stacks each
pattern position's layers on a leading axis (its "groups", and an
encoder-decoder's "encoder" and "decoder"). A parameter's placement is the
reference's spec for its stacked leaf with that group axis dropped. In
"fsdp" mode the reference shards the largest dim divisible by 16 of the
STACKED leaf, which can be the group axis itself; the port has no such axis
and applies the same rule to the layer's own shape, so those leaves
(ROADMAP queue 3) hold the same bytes a device on another dim. The slot
cache keeps the stacked layout (`Model.init_cache`), so cache specs are the
reference's as they are, leading None included.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .config import ModelConfig
from .convert import reference_leaves

TP = "model"
Spec = Tuple[Any, ...]


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """Returns (dp_axes, tp_axis) from a mesh's dim names."""
    dp = tuple(n for n in mesh.mesh_dim_names if n != TP)
    return dp, TP


# the reference's name sets, verbatim
_LAST_DIM_TP = {"wq", "wi", "wg", "w_uq", "w_in", "w_gate", "wr"}
_FIRST_DIM_TP = {"wo", "w_out"}
_REPLICATED = {"wk", "wv", "w_dq", "w_dkv", "wA", "wB", "router", "conv_k",
               "conv_b", "w_a", "w_i", "b_a", "b_i", "lam", "w0", "bonus_u",
               "scale", "q_scale", "k_scale", "ln_y", "bias",
               "mu_r", "mu_k", "mu_v", "mu_g", "mu_w"}
_EXPERT_TP = {"wi", "wg", "wo"}


def leaf_spec(name: str, parent: str, rank: int, grouped: bool) -> Spec:
    """The reference's `_leaf_spec` for a leaf `parent`.`name` of `rank`
    dims (a stacked leaf's rank counts its group axis, `grouped`)."""
    lead = (None,) if grouped else ()

    def spec(*tail):
        full = (*lead, *tail)
        full = full + (None,) * (rank - len(full))
        return tuple(full[:rank])

    if parent == "moe" and name in _EXPERT_TP:
        return spec(TP, None, None)  # (E, D, F) — expert-parallel
    if parent == "embed" and name == "w":
        return (TP, None)  # vocab-sharded (never grouped)
    if parent == "unembed" and name == "w":
        return (None, TP)
    if name in ("w_uk", "w_uv"):  # (rank, H, hd): shard heads
        return spec(None, TP, None)
    # RWKV6's channel-mix wk/wv are in _REPLICATED, tested before the cmix
    # rules below, which therefore never fire (reference sharding.py:66 and
    # :73-76; ROADMAP queue 3, F21). Mirrored, not designed out.
    if name in _REPLICATED or parent in ("ln1", "ln2", "lnx", "final_norm",
                                         "enc_norm", "norm"):
        return spec()
    if name in _LAST_DIM_TP:
        return spec(*([None] * (rank - len(lead) - 1)), TP)
    if name in _FIRST_DIM_TP:
        return spec(TP)
    if parent == "cmix" and name in ("wk",):
        return spec(None, TP)
    if parent == "cmix" and name in ("wv",):
        return spec(TP, None)
    return spec()


def fsdp_spec(shape: Sequence[int]) -> Spec:
    """The reference's "fsdp" rule: the largest dim divisible by 16 (the
    model axis's size; the first on a tie) on `model`, else replicated."""
    best, best_dim = -1, None
    for i, d in enumerate(shape):
        if d % 16 == 0 and d > best:
            best, best_dim = d, i
    spec = [None] * len(shape)
    if best_dim is not None:
        spec[best_dim] = TP
    return tuple(spec)


def param_specs(cfg: ModelConfig, module, mode: str = "tp"
                ) -> Dict[str, Spec]:
    """{parameter name: spec over the parameter's own dims}. "tp": the
    reference's Megatron layout with the group axis dropped; "fsdp": ZeRO-3,
    `fsdp_spec` of each parameter's shape (see the module docstring)."""
    if mode not in ("tp", "fsdp"):
        raise ValueError(f"sharding mode {mode!r} not in ('tp', 'fsdp')")
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    out: Dict[str, Spec] = {}
    for _, names, stacked in reference_leaves(module):
        for n in names:
            if mode == "fsdp":
                out[n] = fsdp_spec(shapes[n])
                continue
            parts = n.split(".")
            rank = len(shapes[n]) + int(stacked)
            spec = leaf_spec(parts[-1], parts[-2] if len(parts) > 1 else "",
                             rank, stacked)
            out[n] = spec[1:] if stacked else spec
    return out


def to_placements(mesh, spec: Spec) -> tuple:
    """One Placement per mesh dim for a reference spec (see the module
    docstring)."""
    names = list(mesh.mesh_dim_names)
    pl: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for m in order:
            pl[m] = Shard(dim)
    return tuple(pl)


def param_placements(cfg: ModelConfig, module, mesh, mode: str = "tp"
                     ) -> Dict[str, tuple]:
    """{parameter name: placements on `mesh`}."""
    return {n: to_placements(mesh, s)
            for n, s in param_specs(cfg, module, mode).items()}


def _walk(tree, fn, path=()):
    return {k: _walk(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def cache_specs(cfg: ModelConfig, caches, dp_axes) -> Dict[str, Any]:
    """The reference's `cache_pspecs` over the port's cache tree (the same
    tree): growing entries batch -> dp, length -> TP (a cross-attention
    cache's fixed length stays whole); recurrent states batch -> dp."""
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def one(names, leaf):
        name = names[-1]
        rank = leaf.dim()
        grouped = names[0] in ("groups",) or (
            names[0] in ("self", "cross") and rank == 5)
        lead = (None,) if grouped else ()
        if name in ("k", "v", "ckv", "krope"):
            ln = None if "cross" in names else TP
            return (*lead, dp, ln) + (None,) * (rank - len(lead) - 2)
        return (*lead, dp) + (None,) * (rank - len(lead) - 1)

    return _walk(caches, one)


def long_ctx_specs(caches, dp_axes) -> Dict[str, Any]:
    """The reference's `_long_ctx_spec` (batch = 1 cells): every data axis
    and the model axis on the KV length, recurrent states replicated."""
    def one(names, leaf):
        name = names[-1]
        rank = leaf.dim()
        grouped = rank >= 4 and names[0] in ("groups", "self", "cross")
        lead = (None,) if grouped else ()
        if name in ("k", "v", "ckv", "krope"):
            return (*lead, None, (*dp_axes, TP)) + (None,) * (
                rank - len(lead) - 2)
        return (*lead,) + (None,) * (rank - len(lead))

    return _walk(caches, one)


def cache_placements(cfg: ModelConfig, mesh, caches, batch: int
                     ) -> Dict[str, Any]:
    """Placements of a cache tree of `batch` sequences on `mesh`:
    `long_ctx_specs` for batch 1 (the reference's `sharded_caches`), else
    `cache_specs`."""
    dp, _ = mesh_axes(mesh)
    specs = (long_ctx_specs(caches, dp) if batch == 1
             else cache_specs(cfg, caches, dp))
    return _walk(specs, lambda _, s: to_placements(mesh, s))


def data_spec(dp_axes, rank: int) -> Spec:
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return (dp,) + (None,) * (rank - 1)


def data_placements(mesh, rank: int) -> tuple:
    """A batch tensor's placements: its leading (batch) dim on the dp
    axes."""
    dp, _ = mesh_axes(mesh)
    return to_placements(mesh, data_spec(dp, rank))


def local_shape(shape, mesh, placements) -> Tuple[int, ...]:
    """Rank 0's shard of a tensor of `shape`: each sharded dim cut to its
    ceil share per mesh dim (torch.chunk's split, which rank 0 always gets
    whole; XLA pads an uneven split to the same size)."""
    out = list(shape)
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(m)
            out[pl.dim] = -(-out[pl.dim] // n)
    return tuple(out)


def shard_like(t: torch.Tensor, mesh, placements) -> DTensor:
    """A DTensor of `t`'s global shape whose local tensor is rank 0's shard,
    taken from `t` where `t` holds data (slices, no collective), or a new
    meta tensor of the shard's shape when `t` is on the meta device."""
    shape = local_shape(t.shape, mesh, placements)
    if t.device.type == "meta":
        local = torch.empty(shape, dtype=t.dtype, device="meta")
    else:
        local = t[tuple(slice(0, s) for s in shape)].contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape,
                              stride=contiguous_stride(t.shape))


def contiguous_stride(shape):
    """A contiguous tensor's strides for `shape`."""
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def distribute_params(module, mesh, placements: Dict[str, tuple]):
    """Replace each parameter of `module` by a DTensor parameter with
    `placements[name]`, its local tensor rank 0's shard of the parameter
    (`shard_like`). Returns the module."""
    for name, p in list(module.named_parameters()):
        owner, attr = (module.get_submodule(name.rsplit(".", 1)[0])
                       if "." in name else module), name.rsplit(".", 1)[-1]
        d = shard_like(p.detach(), mesh, placements[name])
        setattr(owner, attr, torch.nn.Parameter(d, requires_grad=False))
    return module


__all__ = ["TP", "mesh_axes", "leaf_spec", "fsdp_spec", "param_specs",
           "to_placements", "param_placements", "cache_specs",
           "long_ctx_specs", "cache_placements", "data_spec",
           "data_placements", "local_shape", "shard_like",
           "contiguous_stride", "distribute_params"]
