"""Checkpoints in the reference's on-disk format (`repro/train/checkpoint.py`),
so that one checkpoint loads in both packages.

Layout: <dir>/step_<n>/
    manifest.json   — {"step", "keys": [{"tree", "key", "file", "shape",
                      "dtype"}], "extra"}
    params_#####.npy, opt_#####.npy — one file per leaf

The leaves are the reference's trees, flattened in its order (dict keys
sorted at every level): the params in its stacked layout
(`convert.reference_leaves`: every "groups" leaf, and an encoder-decoder's
"encoder" and "decoder" leaves, holds its layers on a leading axis), and
the optimizer state as {"mu": params-like, "nu": params-like, "step"}. A
leaf's "key" is its `jax.tree_util.keystr` string, such as
"['groups']['p0']['attn']['wq']" or "['mu']['embed']['w']", written here
without JAX. Writes are atomic (a tmp dir, then a rename), and
`latest_step` skips a directory without its manifest, so a crash mid-write
cannot corrupt a restore.

bfloat16 (F19, ROADMAP queue 3): numpy has no bfloat16. The reference's
`np.save` writes a bf16 leaf as raw 2-byte '<V2' records with manifest
dtype "bfloat16", and its own restore then fails (`astype` from void). The
port writes the same bytes (a '<V2' header over the bf16 bit patterns) and
restores them by reinterpreting the bytes through int16 as
`torch.bfloat16`, so a checkpoint written by either package restores in
the port bit-exactly. Other dtypes are numpy's own and restore by a cast
to the target's dtype, as in the reference.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import reference_leaves

BF16 = "bfloat16"


def _leaves(params, opt_state):
    """[(tree, key, tensors, stacked)]: the params' leaves, then the
    state's — ['mu'][...], ['nu'][...], ['step'] — each in the reference's
    flatten order, `tensors` the port's per-layer pieces of a stacked
    leaf."""
    ps = dict(params.named_parameters())
    layout = reference_leaves(params)
    out = [("params", key, [ps[n] for n in names], stacked)
           for key, names, stacked in layout]
    out += [("opt", f"[{sec!r}]{key}", [opt_state[sec][n] for n in names],
             stacked)
            for sec in ("mu", "nu") for key, names, stacked in layout]
    out.append(("opt", "['step']", [opt_state["step"]], False))
    return out


def _save_npy(path: Path, t: torch.Tensor) -> Tuple[List[int], str]:
    """Write one leaf; returns (shape, manifest dtype)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": tuple(t.shape)})
            f.write(t.view(torch.int16).numpy().tobytes())
        return list(t.shape), BF16
    arr = t.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write (the module `params`, the AdamW state) as step `step`."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "keys": [], "extra": extra or {}}
    count = {"params": 0, "opt": 0}
    with torch.no_grad():
        for tree, key, ts, stacked in _leaves(params, opt_state):
            fname = f"{tree}_{count[tree]:05d}.npy"
            count[tree] += 1
            leaf = torch.stack(ts) if stacked else ts[0]
            shape, dtype = _save_npy(tmp / fname, leaf)
            manifest["keys"].append({"tree": tree, "key": key, "file": fname,
                                     "shape": shape, "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return str(final)


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = []
    for p in d.iterdir():
        if p.name.startswith("step_") and (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _load(path: Path, ent: Dict[str, Any]) -> torch.Tensor:
    """One leaf as a CPU tensor in its saved dtype (bf16 by its bytes)."""
    arr = np.asarray(np.load(path), order="C")
    if ent["dtype"] == BF16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{ent['key']}: a bfloat16 leaf of "
                             f"{arr.dtype.itemsize}-byte records")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _shard_of(full: torch.Tensor, mesh, placements, dtype):
    """This rank's shard of `full` under `placements` on `mesh`, as a
    DTensor: sliced locally (no collective), on the mesh's device."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        full.shape, mesh, placements)
    local = full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    return DTensor.from_local(local.to(dev, dtype).contiguous(), mesh,
                              placements, run_check=False, shape=full.shape,
                              stride=full.contiguous().stride())


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, step: int, params_like, opt_like,
                       shardings: Optional[Dict[str, Tuple[Any, Any]]] = None):
    """Restore step `step` into the structure of (params_like, opt_like):
    the module's parameters are overwritten in place (each cast to its own
    dtype, its shape checked), and the state is built on the module's
    device in opt_like's dtypes (opt_like may be `adamw_state_skeleton`'s
    meta tensors). Returns (params_like, the state, the manifest's
    "extra"). A missing leaf raises KeyError, a shape mismatch
    ValueError.

    `shardings` {parameter name: (mesh, placements)} is the elastic
    resharding path (the reference's `shardings`): each named parameter
    becomes a DTensor parameter holding this rank's shard of the saved
    array, sliced out of it with no collective, and its AdamW moments are
    placed like it."""
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_tree: Dict[str, Dict[str, Dict[str, Any]]] = {"params": {}, "opt": {}}
    for ent in manifest["keys"]:
        by_tree[ent["tree"]][ent["key"]] = ent
    shardings = shardings or {}

    def fetch(tree, key, targets, stacked):
        if key not in by_tree[tree]:
            raise KeyError(f"checkpoint missing leaf {key}")
        ent = by_tree[tree][key]
        saved = _load(d / ent["file"], ent)
        want = ((len(targets),) if stacked else ()) + tuple(targets[0].shape)
        if tuple(saved.shape) != want:
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(saved.shape)} vs target {want}")
        return list(saved) if stacked else [saved]

    ps = dict(params_like.named_parameters())
    layout = reference_leaves(params_like)
    for key, names, stacked in layout:
        for n, saved in zip(names, fetch("params", key,
                                         [ps[n] for n in names], stacked)):
            if n not in shardings:
                ps[n].copy_(saved.to(ps[n].dtype))
                continue
            owner = (params_like.get_submodule(n.rsplit(".", 1)[0])
                     if "." in n else params_like)
            setattr(owner, n.rsplit(".", 1)[-1], torch.nn.Parameter(
                _shard_of(saved, *shardings[n], ps[n].dtype),
                requires_grad=False))
    dev = params_like.embed.w.device  # a DTensor's is its shard's
    opt: Dict[str, Any] = {}
    for sec in ("mu", "nu"):
        got: Dict[str, torch.Tensor] = {}
        for key, names, stacked in layout:
            likes = [opt_like[sec][n] for n in names]
            for n, like, saved in zip(names, likes, fetch(
                    "opt", f"[{sec!r}]{key}", likes, stacked)):
                got[n] = (_shard_of(saved, *shardings[n], like.dtype)
                          if n in shardings
                          else saved.to(ps[n].device, like.dtype))
        opt[sec] = {n: got[n] for n in ps}
    opt["step"] = fetch("opt", "['step']", [opt_like["step"]], False)[0].to(
        dev, opt_like["step"].dtype)
    return params_like, opt, manifest["extra"]


__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint"]
