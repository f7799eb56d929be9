"""Stand-ins for every model input of every (architecture x shape) cell,
placed on a mesh, and the program builders the dry run runs (reference
`repro/launch/specs.py`).

Programs per shape kind:
  train_*    -> train_step(params, opt_state, batch)
  prefill_*  -> prefill_step(params, tokens[, frontend_embeds])
  decode_* / long_* -> serve_step(params, token, caches, position)
                       (one new token against a KV cache of seq_len)

A builder returns `(fn, args)`. The arguments are DTensors whose local
tensors are rank 0's shards (`sharding.shard_like`): meta tensors on
`device="meta"`, which hold no memory, or seeded values on the card. The
parameters are the model's module with DTensor parameters placed by
`param_placements`, the AdamW state is placed like its parameters, the
caches by `cache_placements` and the batch on the dp axes.

`fn` runs the port's model on those DTensors: torch ops in global shapes,
DTensor propagating each op's sharding and issuing the collectives. It runs
under `implicit_replication()` (the model makes plain tensors — RoPE
tables, masks, the chunked loss's constants — which are the same on every
rank) and under `ShardingRules`, the explicit redistributions for the ops
DTensor cannot place as GSPMD does (each rule says why). Any other op that
DTensor has no strategy for raises: there is no fallback.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard
from torch.distributed.tensor._ops._view_ops import (Flatten, InputDim,
                                                     Singleton, Split,
                                                     view_groups)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import get_config, get_shape
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_params
from repro_torch.models.sharding import (cache_placements,
                                         contiguous_stride, data_placements,
                                         distribute_params, mesh_axes,
                                         param_placements, shard_like,
                                         to_placements)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step


def cell_supported(arch: str, shape_name: str) -> Tuple[bool, str]:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention architecture; long_500k "
                       "requires sub-quadratic attention (DESIGN.md §4)")
    if shape.seq_len > cfg.max_seq:
        return False, f"skipped: seq_len {shape.seq_len} > max_seq {cfg.max_seq}"
    return True, "ok"


# --------------------------------------------------------------------------- #
# Explicit redistributions
# --------------------------------------------------------------------------- #
def _replicate_dims(t: DTensor, mesh_dims) -> DTensor:
    pl = [Replicate() if m in mesh_dims else p
          for m, p in enumerate(t.placements)]
    return t.redistribute(t.device_mesh, pl)


def _view_shape(t: DTensor, shape) -> tuple:
    """A view's target shape with its -1 resolved."""
    shape = tuple(int(n) for n in shape)
    if -1 in shape:
        known = math.prod(n for n in shape if n != -1)
        shape = tuple(t.numel() // known if n == -1 else n for n in shape)
    return shape


def _uneven_split_dims(t: DTensor, shape) -> set:
    """Mesh dims on which a view of `t` to `shape` splits a sharded tensor
    dim into a leading piece their size does not divide."""
    shape = _view_shape(t, shape)
    bad = set()
    for cmd in view_groups(tuple(t.shape), shape):
        if not (isinstance(cmd, Split) and cmd.split_id == 0
                and isinstance(cmd.input_dim, InputDim)):
            continue
        for m, pl in enumerate(t.placements):
            if (isinstance(pl, Shard) and pl.dim == cmd.input_dim.input_dim
                    and cmd.group_shape[0] % t.device_mesh.size(m)):
                bad.add(m)
    return bad


def _strided_view(t: DTensor, shape, alias: bool = False):
    """`t` viewed as `shape` where the view merges adjacent dims of which
    the first may be sharded on one mesh dim and a later one is sharded on
    a later mesh dim (batch on the data axis, heads on the model axis), or
    splits such a merged dim back: the local tensor is reshaped, and the
    later mesh dim becomes (or stops being) a strided shard of the merged
    dim (`split_factor`: the local rows before the sharded dim). None for
    any other view, and for an aliasing view (`alias`) of a local tensor
    that cannot be viewed so."""
    shape = _view_shape(t, shape)
    mesh, pls = t.device_mesh, t.placements
    cmds = view_groups(tuple(t.shape), shape)
    if any(not isinstance(c, (InputDim, Flatten, Split, Singleton))
           for c in cmds):
        return None
    sharded = {m: p for m, p in enumerate(pls)
               if isinstance(p, (Shard, _StridedShard))}
    local = list(t.to_local().shape)
    out, new_local, strided = list(pls), [], False
    for o, c in enumerate(cmds):
        if isinstance(c, Singleton):
            new_local.append(1)
        elif isinstance(c, InputDim):
            for m, p in sharded.items():
                if p.dim == c.input_dim:
                    if isinstance(p, _StridedShard):
                        return None
                    out[m] = Shard(o)
            new_local.append(local[c.input_dim])
        elif isinstance(c, Flatten):
            if not all(isinstance(i, InputDim) for i in c.input_dims):
                return None
            dims = [i.input_dim for i in c.input_dims]
            on = {m: p for m, p in sharded.items() if p.dim in dims}
            if any(isinstance(p, _StridedShard) for p in on.values()):
                return None
            lead = [m for m, p in on.items() if p.dim == dims[0]]
            inner = [m for m, p in on.items() if p.dim != dims[0]]
            if not inner:
                if on:  # the leading dim alone: DTensor's own rule
                    return None
                new_local.append(math.prod(local[d] for d in dims))
                continue
            if len(inner) != 1 or any(m > inner[0] for m in lead):
                return None
            b = inner[0]
            k = dims.index(on[b].dim)
            if any(t.shape[dims[0]] % mesh.size(m) for m in lead) or \
                    t.shape[dims[k]] % mesh.size(b):
                return None
            for m in lead:
                out[m] = Shard(o)
            out[b] = _StridedShard(o, split_factor=math.prod(
                local[d] for d in dims[:k]))
            strided = True
            new_local.append(math.prod(local[d] for d in dims))
        else:  # Split of one input dim into c.group_shape
            if not isinstance(c.input_dim, InputDim):
                return None
            d, g = c.input_dim.input_dim, c.group_shape
            on = {m: p for m, p in sharded.items() if p.dim == d}
            st = [m for m, p in on.items() if isinstance(p, _StridedShard)]
            if not st:
                return None
            b = st[0]
            lead = [m for m in on if m != b]
            if len(st) != 1 or any(m > b or g[0] % mesh.size(m)
                                   for m in lead):
                return None
            g_loc = [g[0] // math.prod(mesh.size(m) for m in lead),
                     *g[1:]]
            j = next((j for j in range(1, len(g))
                      if math.prod(g_loc[:j]) == on[b].split_factor), None)
            if j is None or g[j] % mesh.size(b):
                return None
            i = c.split_id
            if i == 0:
                for m in lead:
                    out[m] = Shard(o)
            if i == j:
                out[b] = Shard(o)
                g_loc[j] = g[j] // mesh.size(b)
            new_local.append(g_loc[i])
            strided = True
    if not strided:
        return None
    local = t.to_local()
    if alias:  # aten.view: the local view must exist as well
        try:
            local = local.view(new_local)
        except RuntimeError:
            return None
    else:
        local = local.reshape(new_local)
    return DTensor.from_local(local, mesh,
                              tuple(out), run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _unstride(t):
    """`t` with each strided shard gathered (replicated on its mesh dim),
    by hand: an all-gather over the mesh dim, then each piece's rows put
    back in their global order. Anything else comes back as it is."""
    if not (isinstance(t, DTensor) and any(
            isinstance(p, _StridedShard) for p in t.placements)):
        return t
    from torch.distributed import _functional_collectives as funcol
    mesh, pls = t.device_mesh, list(t.placements)
    local = t.to_local()
    for m, p in enumerate(pls):
        if not isinstance(p, _StridedShard):
            continue
        n, sf, d = mesh.size(m), p.split_factor, p.dim
        x = local.movedim(d, 0)
        rows, rest = x.shape[0], x.shape[1:]
        got = funcol.all_gather_tensor(x.contiguous(), 0, (mesh, m))
        got = got.reshape(n, sf, rows // sf, *rest).transpose(0, 1)
        local = got.reshape(n * rows, *rest).movedim(0, d)
        pls[m] = Replicate()
    shape = t.shape
    return DTensor.from_local(local.contiguous(), mesh, tuple(pls),
                              run_check=False, shape=shape,
                              stride=contiguous_stride(tuple(shape)))


def _sharded_on(t: DTensor, dim: int) -> set:
    dim = dim % t.dim()
    return {m for m, pl in enumerate(t.placements)
            if isinstance(pl, Shard) and pl.dim == dim}


def _cuts(func, args) -> bool:
    """Whether an aten slice/select/narrow drops rows of its dim."""
    if func is aten.select.int:
        return True
    t, dim = args[0], args[1] if len(args) > 1 else 0
    size = t.shape[dim]
    if func is aten.narrow.default:
        return args[3] < size
    start = args[2] if len(args) > 2 and args[2] is not None else 0
    end = args[3] if len(args) > 3 and args[3] is not None else size
    step = args[4] if len(args) > 4 else 1
    start = start + size if start < 0 else start
    end = min(end + size if end < 0 else end, size)
    return not (start == 0 and end >= size and step == 1)


aten = torch.ops.aten
_VIEWS = (aten.view.default, aten._unsafe_view.default)
_SLICES = (aten.slice.Tensor, aten.select.int, aten.narrow.default)
_INDEX_PUTS = (aten.index_put_.default, aten.index_put.default)
_MASKED = (aten.embedding.default, aten.gather.default)


def _on_dim0(p) -> bool:
    return isinstance(p, (Shard, _StridedShard)) and p.dim == 0


def _batch_placements(a: DTensor, b: DTensor):
    """For a batched product of `a` (N, M, K) and `b` (N, K, P): the
    placements both operands take when every mesh dim shards at most the
    batch dim N (Shard(0) or a strided shard of it) — where the two shard
    it differently, the strided shard (heads on the model axis) — else
    None."""
    out = []
    for pa, pb in zip(a.placements, b.placements):
        for p in (pa, pb):
            if not (p.is_replicate() or _on_dim0(p)):
                return None
        if _on_dim0(pa) and _on_dim0(pb) and pa != pb:
            strided = [p for p in (pa, pb) if isinstance(p, _StridedShard)]
            if len(strided) != 1:
                return None
            out.append(strided[0])
        else:
            out.append(pa if _on_dim0(pa) else pb)
    return tuple(out)


def _to_batch_shards(t: DTensor, pls) -> torch.Tensor:
    """The local tensor of `t` redistributed to `pls`, which shard dim 0
    where `t` is replicated or shards it otherwise: a mesh dim sharded
    otherwise is gathered first (DTensor's redistribute), then rank's rows
    are cut out of the replicated local tensor in place (DTensor's own
    strided split builds every rank's piece with `cat`, and torch 2.11
    cannot redistribute to a strided shard)."""
    mesh = t.device_mesh
    other = {m for m, (have, want) in enumerate(zip(t.placements, pls))
             if have != want and not have.is_replicate()}
    if other:
        t = _replicate_dims(t, other)
    local = t.to_local()
    for m, (have, want) in enumerate(zip(t.placements, pls)):
        if have == want:
            continue
        n, r = mesh.size(m), mesh.get_local_rank(m)
        rows, rest = local.shape[0], local.shape[1:]
        sf = want.split_factor if isinstance(want, _StridedShard) else 1
        if rows % (sf * n):  # uneven: DTensor's split
            return t.redistribute(mesh, pls).to_local()
        local = local.reshape(sf, n, rows // (sf * n), *rest)[:, r].reshape(
            -1, *rest)
    return local


class ShardingRules(TorchDispatchMode):
    """The redistributions a GSPMD compiler makes by itself and DTensor's
    propagation does not, made explicit before the op (a dispatch mode, so
    the rules hold in the backward and in remat's recomputation too):

    1. A view that splits a sharded dim into pieces the mesh dim does not
       divide (GQA's (B, H·D) -> (B, Hkv, G, D) with Hkv = 8 heads on a
       16-way model axis; RWKV6's 40 heads, whisper's 12). GSPMD shards
       such a split over both pieces; DTensor cannot place one mesh dim on
       two tensor dims and raises. The mesh dim is gathered first
       (DTensor's own non-strict `reshape` does the same).
    2. Slicing a sharded dim (`t[:, a:b]` of a key or value whose sequence
       DTensor sharded, inside the attention's chunk loops). DTensor
       all-gathers the whole tensor at every slice; GSPMD hoists that
       gather out of the loop. The tensor is gathered once and the gathered
       copy is kept while the tensor lives.
    3. `embedding` or `gather` along a sharded dim (the vocab-sharded
       embedding table; the loss's target logit on vocab-sharded logits):
       DTensor leaves a masked partial sum whose mask buffer the next ops
       do not carry (torch 2.11 loses it across the embedding's scale,
       torch 2.13 raises in `MaskBuffer.apply_mask` after an index), so
       the result is reduced at once: the vocab-parallel embedding's
       all-reduce.
    4. An indexed write into a plain tensor with DTensor operands (the MoE's
       slot table): DTensor cannot write into a tensor that is not one, so
       the operands are gathered and the write runs on the plain tensor,
       which is the same on every rank.
    5. A batched product (`bmm`, which every einsum becomes) whose batch
       dim flattens a data-sharded batch and model-sharded heads: DTensor
       marks the model axis as a strided shard that its `bmm` strategy does
       not take, and gathers the heads, so every device would compute all
       of them. When the operands shard only the batch dim and agree (a
       replicated operand is cut to the same shard, locally), the product
       runs on the local shards, as the batch dim's split lets it.
    6. The views around that product: merging a data-sharded batch dim with
       the model-sharded heads dim after it (a strided shard, as torch 2.13
       places it; torch 2.11 refuses the merge) and splitting the merged dim
       back run on the local tensor, so both torch versions place them
       alike.
    7. Any other op that meets a strided shard gathers it first, by hand
       (`_unstride`): torch 2.11's redistribute cannot read one.

    It also counts `flops_global`: the FLOPs of every matmul-family op in
    the program's global shapes (torch's flop registry), which is what the
    whole mesh computes, replicated work once.
    """

    def __init__(self):
        super().__init__()
        self._gathered = WeakIdKeyDictionary()
        self.flops_global = 0

    def _gather_once(self, t: DTensor, mesh_dims: set) -> DTensor:
        key = frozenset(mesh_dims)
        got = self._gathered.get(t, {}).get(key)
        if got is None:
            got = _replicate_dims(t, mesh_dims)
            self._gathered.setdefault(t, {})[key] = got
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops_global += count(*args, **kwargs, out_val=None)
        if func not in _VIEWS and func is not aten.bmm.default:
            args, kwargs = tree_map(_unstride, (args, kwargs))
        if func in _VIEWS and isinstance(args[0], DTensor):
            bad = _uneven_split_dims(args[0], args[1])
            if bad:
                args = (_replicate_dims(_unstride(args[0]), bad),) + tuple(
                    args[1:])
            else:
                out = _strided_view(args[0], args[1],
                                    alias=func is aten.view.default)
                if out is not None:
                    return out
        elif func in _SLICES and isinstance(args[0], DTensor):
            dim = args[1] if len(args) > 1 else 0
            bad = _sharded_on(args[0], dim)
            if bad and _cuts(func, args):
                args = (self._gather_once(args[0], bad),) + tuple(args[1:])
        elif (func is aten.bmm.default and isinstance(args[0], DTensor)
              and isinstance(args[1], DTensor)):
            a, b = args
            pls = _batch_placements(a, b)
            if pls is not None:
                mesh = a.device_mesh
                la, lb = _to_batch_shards(a, pls), _to_batch_shards(b, pls)
                shape = (a.shape[0], a.shape[1], b.shape[2])
                return DTensor.from_local(
                    func(la, lb), mesh, pls, run_check=False,
                    shape=torch.Size(shape), stride=(shape[1] * shape[2],
                                                     shape[2], 1))
        elif func in _MASKED and isinstance(args[0], DTensor):
            out = func(*args, **kwargs)
            partial = {m for m, pl in enumerate(out.placements)
                       if pl.is_partial()}
            return _replicate_dims(out, partial) if partial else out
        elif func in _INDEX_PUTS and not isinstance(args[0], DTensor):
            full = lambda a: a.full_tensor() if isinstance(  # noqa: E731
                a, DTensor) else a
            args = (args[0], [None if i is None else full(i)
                              for i in args[1]], full(args[2])) + tuple(
                args[3:])
        args, kwargs = tree_map(_unstride, (args, kwargs))
        return func(*args, **kwargs)


class Program:
    """A program body run on DTensor arguments: each call runs under
    `implicit_replication()` (the model makes plain tensors — RoPE tables,
    masks, the chunked loss's constants — which are the same on every rank)
    and a fresh `ShardingRules`, kept as `rules` (its `flops_global`)."""

    def __init__(self, fn):
        self.fn = fn
        self.rules = None

    def __call__(self, *args):
        self.rules = ShardingRules()
        with implicit_replication(), self.rules:
            return self.fn(*args)


# --------------------------------------------------------------------------- #
# Stand-ins
# --------------------------------------------------------------------------- #
def _standin(shape, dtype, mesh, placements, device, fill=None):
    """A DTensor of global `shape` whose local tensor is rank 0's shard:
    meta, or on `device` filled by `fill(local)` (zeros by default)."""
    d = shard_like(torch.empty(shape, dtype=dtype, device="meta"), mesh,
                   placements)
    if device == "meta":
        return d
    local = torch.zeros(d.to_local().shape, dtype=dtype, device=device)
    if fill is not None:
        fill(local)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=d.shape, stride=d.stride())


def _tokens(vocab: int, seed: int):
    def fill(local):
        gen = torch.Generator(device=local.device)
        gen.manual_seed(seed)
        local.copy_(torch.randint(0, vocab, local.shape, generator=gen,
                                  device=local.device))
    return fill


def _normal(seed: int):
    def fill(local):
        gen = torch.Generator(device=local.device)
        gen.manual_seed(seed)
        local.copy_(torch.randn(local.shape, generator=gen,
                                dtype=torch.float32, device=local.device))
    return fill


def batch_specs(cfg: ModelConfig, mesh, batch: int, seq: int,
                with_labels: bool, device: str = "meta", seed: int = 0
                ) -> Dict[str, Any]:
    tok = _standin((batch, seq), torch.int32, mesh, data_placements(mesh, 2),
                   device, _tokens(cfg.vocab_size, seed))
    out = {"tokens": tok}
    if with_labels:
        out["labels"] = tok
    if cfg.frontend != "none":
        fl = cfg.frontend_len or cfg.encoder_seq
        out["frontend_embeds"] = _standin(
            (batch, fl, cfg.d_model), cfg.torch_dtype, mesh,
            data_placements(mesh, 3), device, _normal(seed + 1))
    return out


def sharded_params(cfg: ModelConfig, mesh, model=None,
                   sharding_mode: str = "tp", device: str = "meta",
                   seed: int = 0):
    """The model's module with DTensor parameters: built on the meta
    device, placed, and on a card given rank 0's shards of the seeded
    weights (`init_params` over the DTensors: each leaf drawn whole, then
    sliced to its shard)."""
    model = model or build_model(cfg)
    module = model.module("meta")
    distribute_params(module, mesh, param_placements(cfg, module, mesh,
                                                     mode=sharding_mode))
    if device == "meta":
        return module
    for name, p in list(module.named_parameters()):
        owner = module.get_submodule(name.rsplit(".", 1)[0])
        local = torch.empty(p.to_local().shape, dtype=p.dtype, device=device)
        d = DTensor.from_local(local, mesh, p.placements, run_check=False,
                               shape=p.shape, stride=p.stride())
        setattr(owner, name.rsplit(".", 1)[-1],
                torch.nn.Parameter(d, requires_grad=False))
    with implicit_replication():
        init_params(module, seed)
    return module


def sharded_caches(cfg: ModelConfig, mesh, batch: int, ctx: int, model=None,
                   device: str = "meta"):
    """The slot cache of `batch` sequences of `ctx` tokens (zeros on a
    card), placed by `cache_placements`."""
    model = model or build_model(cfg)
    tree = model.init_cache(batch, ctx, device="meta")
    pls = cache_placements(cfg, mesh, tree, batch)

    def place(node, pl):
        return {k: place(v, pl[k]) if isinstance(v, dict) else
                _standin(v.shape, v.dtype, mesh, pl[k], device)
                for k, v in node.items()}
    return place(tree, pls)


def opt_state(params, mesh, device: str = "meta"):
    """AdamW's state {"mu", "nu": fp32 like each parameter, placed like it;
    "step": a replicated int32 scalar}, zeros on a card."""
    def moments():
        return {n: _standin(p.shape, torch.float32, mesh, p.placements,
                            device)
                for n, p in params.named_parameters()}
    step = _standin((), torch.int32, mesh, to_placements(mesh, ()), device)
    return {"mu": moments(), "nu": moments(), "step": step}


# --------------------------------------------------------------------------- #
# Program builders
# --------------------------------------------------------------------------- #
def build_train_program(arch: str, mesh, *, grad_accum: int = 1,
                        compress_grads: bool = False, remat: bool = True,
                        loss_chunk: int = 512, sharding_mode: str = "tp",
                        cfg=None, device: str = "meta"):
    cfg = cfg or get_config(arch)
    model = build_model(cfg)
    shape = get_shape("train_4k")
    step_fn = make_train_step(model, AdamWConfig(), remat=remat,
                              grad_accum=grad_accum,
                              compress_grads=compress_grads,
                              loss_chunk=loss_chunk)
    params = sharded_params(cfg, mesh, model, sharding_mode=sharding_mode,
                            device=device)
    opt = opt_state(params, mesh, device)
    batch = batch_specs(cfg, mesh, shape.global_batch, shape.seq_len, True,
                        device)
    return Program(step_fn), (params, opt, batch)


def build_prefill_program(arch: str, mesh, shape_name: str = "prefill_32k",
                          cfg=None, device: str = "meta"):
    cfg = cfg or get_config(arch)
    model = build_model(cfg)
    shape = get_shape(shape_name)
    batch = batch_specs(cfg, mesh, shape.global_batch, shape.seq_len, False,
                        device)
    params = sharded_params(cfg, mesh, model, device=device)

    if cfg.frontend != "none":
        def prefill_step(params, tokens, frontend_embeds):
            return model.prefill(params, tokens,
                                 frontend_embeds=frontend_embeds,
                                 attention_impl="torch")
        args = (params, batch["tokens"], batch["frontend_embeds"])
    else:
        def prefill_step(params, tokens):
            return model.prefill(params, tokens, attention_impl="torch")
        args = (params, batch["tokens"])
    return Program(prefill_step), args


def build_decode_program(arch: str, mesh, shape_name: str, cfg=None,
                         device: str = "meta"):
    cfg = cfg or get_config(arch)
    model = build_model(cfg)
    shape = get_shape(shape_name)
    dp, _ = mesh_axes(mesh)
    B, ctx = shape.global_batch, shape.seq_len

    def serve_step(params, token, caches, position):
        return model.decode_step(params, token, caches, position,
                                 attention_impl="torch")

    tok_spec = (dp if len(dp) > 1 else dp[0],) if B > 1 else (None,)
    token = _standin((B,), torch.int32, mesh, to_placements(mesh, tok_spec),
                     device, _tokens(cfg.vocab_size, 2))
    # a plain scalar, the same on every rank (the reference's replicated
    # position): the model writes masks in place with it, and DTensor
    # cannot write a DTensor into a plain tensor
    position = (torch.empty((), dtype=torch.int32, device="meta")
                if device == "meta" else
                torch.tensor(ctx - 1, dtype=torch.int32, device=device))
    args = (sharded_params(cfg, mesh, model, device=device), token,
            sharded_caches(cfg, mesh, B, ctx, model, device=device),
            position)
    return Program(serve_step), args


def build_cell(arch: str, shape_name: str, mesh, cfg=None,
               device: str = "meta", **kw):
    kind = get_shape(shape_name).kind
    if kind == "train":
        return build_train_program(arch, mesh, cfg=cfg, device=device, **kw)
    if kind == "prefill":
        return build_prefill_program(arch, mesh, shape_name, cfg=cfg,
                                     device=device)
    return build_decode_program(arch, mesh, shape_name, cfg=cfg,
                                device=device)


def probe_config(arch: str, k: int):
    """Depth probe: k pattern repetitions (k groups). The reference measures
    per-group cost this way because XLA counts a loop body once; the port
    runs every layer and keeps the probes for the reference's records
    (`launch.dryrun`)."""
    cfg = get_config(arch)
    n = len(cfg.block_pattern) * k
    kw = {"n_layers": n, "unroll_layers": True, "attn_block_full": True,
          "flash_vjp": False}
    if cfg.is_encoder_decoder:
        kw["n_encoder_layers"] = n
    return cfg.scaled(**kw)


__all__ = ["cell_supported", "ShardingRules", "Program",
           "batch_specs", "sharded_params", "sharded_caches", "opt_state",
           "build_train_program", "build_prefill_program",
           "build_decode_program", "build_cell", "probe_config"]
