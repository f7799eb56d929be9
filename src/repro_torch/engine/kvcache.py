"""Slot-based KV cache for the port's serving engine.

Each replica owns preallocated slot-major cache tensors: slot s is a
contiguous max_ctx region per layer. Conversations pin a slot for their
lifetime (exactly ConServe's binding), lengths are tracked host-side, and
reads beyond a slot's live length are masked via kv_lens.

Every write here is IN PLACE into the preallocated tensors — the port's
counterpart of the JAX package's buffer donation. A consequence callers
must respect: a view taken of `caches` (`slice_slot_prefix`,
`export_slot_full`) sees later writes, while `export_slot` returns a copy
that may travel after the slot is released.

The tree is the model's (`models.transformer`): leaves under "groups" carry
the pattern's repetitions on a leading axis, (G, n_slots, ...), leaves under
"rem" do not, (n_slots, ...); an encoder-decoder's "self" and "cross"
leaves (`models.encdec`) carry the decoder layer there, (L, n_slots, ...).
Every function here takes a "rem" leaf through a (1, n_slots, ...) view of
it, so one code path serves all. Two kinds of
leaves sit side by side, as in the reference: growing ones (`GROWING_KEYS`:
attention K/V and MLA's latent and rope key, one row per token, (…,
n_slots, max_ctx, ...), where "..." is (Hkv, hd) or MLA's (rank,)) and FIXED
states (RWKV6's "s", "shift", "cshift"; RG-LRU's "h", "conv"; (…, n_slots,
...), the same size whatever the context). A decode step appends to a
growing leaf at the slot's length and replaces a fixed state; a prefill
writes growing rows at an offset and replaces a fixed state.

An encoder-decoder's "cross" leaves (the encoder's K/V, (L, n_slots,
encoder_seq, Hkv, hd)) are fixed too, and only a fresh prefill writes
them: it replaces them, as `import_slot` does; decode and append never
fold into them (`fold_decode_step` skips them, and an append's result
holds none); `export_slot` copies them whole and `nbytes_of` counts them.
The reference's fold maps over a tree with "cross" against decode updates
without it and raises (ROADMAP queue 3, F13). A slot's length counts the
decoder's positions only — the frames are in "cross" (F14) — so the
server's `written` length is decoder tokens for an encoder-decoder.

A local-attention layer's K/V is only `min(max_ctx, window)` long, and the
reference writes a slot's rows at its length past that end without a word
(ROADMAP queue 3, F5). The port refuses such a cache: `SlotKVCache` raises
when a model with a local layer asks for max_ctx > window, so every row it
writes has its own position.

Two index rules of the JAX package do not carry over to torch, and both are
made explicit here for growing leaves: JAX drops a scatter that falls
outside the array (torch raises or writes out of bounds), and
`dynamic_update_slice` clamps a start that would run off the buffer (a torch
slice silently writes less). So `fold_decode_step` clamps the row it touches
and writes back the old row for slots that are not live, and `fold_prefill`
refuses a write that does not fit.

A quantized cache (`kv_cache_dtype="int8"`) holds every growing attention
row as `quantize_kv` gives it. A decode step's rows come quantized from the
model; a prefill's come in the model's dtype, and the prefill folds
(`fold_prefill`, `fold_prefill_at`, hence `write_prefill`) quantize them
on the way in, given the model's config. Rows that are already int8 — a
pooled prefix, an imported package, a saved slot put back — are copied
like for like. The reference's folds cast the prefill's float rows to int8
without the scale or rounding (ROADMAP queue 3, F23). `nbytes_of` counts
the bytes as they are, so an int8 transfer is half a bf16 one.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.attention import quantize_kv
from repro_torch.models.config import ATTN_LOCAL, ModelConfig
from repro_torch.models.model import GROWING_KEYS, Model


def leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                             torch.Tensor]]:
    """(path, tensor) of every leaf of a nested-dict cache tree, in a fixed
    (insertion) order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v


def map_leaves(fn: Callable[[Tuple[str, ...], torch.Tensor], torch.Tensor],
               tree, path: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """The tree with every leaf replaced by fn(path, leaf)."""
    return {k: (map_leaves(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in tree.items()}


def leaf_at(tree, path: Tuple[str, ...]) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


def grouped(path: Tuple[str, ...], t: torch.Tensor) -> torch.Tensor:
    """A leaf with the repetition (or layer) axis in front: itself under
    "groups", "self" and "cross", a (1, ...) view of a "rem" leaf (writes
    through it land in the leaf)."""
    return t.unsqueeze(0) if path[0] == "rem" else t


def _slot_axis(path: Tuple[str, ...]) -> int:
    """The slot axis of a leaf as the tree holds it."""
    return 0 if path[0] == "rem" else 1


def growing(path: Tuple[str, ...]) -> bool:
    """One row per token: attention K/V and MLA's latent and rope key,
    but not an encoder-decoder's "cross" rows."""
    return path[-1] in GROWING_KEYS and path[0] != "cross"


def cross(path: Tuple[str, ...]) -> bool:
    """An encoder-decoder's encoder K/V: written by a fresh prefill only."""
    return path[0] == "cross"


def stored(path: Tuple[str, ...], leaf: torch.Tensor, new: torch.Tensor,
           cfg: Optional[ModelConfig]) -> torch.Tensor:
    """`new` rows as `leaf` holds them: float rows bound for a quantized
    (integer) growing leaf go through `quantize_kv` (F23); anything else
    is cast, a like-for-like copy included."""
    if growing(path) and new.dtype != leaf.dtype and \
            not leaf.dtype.is_floating_point:
        if cfg is None:
            raise ValueError(f"{'/'.join(path)}: folding {new.dtype} rows "
                             f"into a {leaf.dtype} cache needs the model's "
                             "config to quantize them")
        return quantize_kv(new, cfg)
    return new.to(leaf.dtype)


def _slot_mask(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """(n_slots,) -> broadcastable against a (G, n_slots, ...) leaf."""
    return mask.reshape((1, -1) + (1,) * (ndim - 2))


@torch.no_grad()
def fold_decode_step(caches, updates, lens: torch.Tensor,
                     mask: torch.Tensor) -> None:
    """Fold one decode step's updates into `caches`, in place: a growing
    leaf takes the new token's row at each slot's current length, a fixed
    state is replaced.

    ``mask`` is the per-step LIVE mask (the ragged scan passes
    ``emit & (step < remaining)``): a slot that is not live keeps its row
    byte-identical — every write is a select against the old bytes. For a
    growing leaf its row index is also clamped into the buffer, so a slot
    filled to exactly max_ctx — which the replica's overflow guard allows —
    never indexes past the end. A live slot always has room (the guard in
    `ReplicaEngine._remaining_vector`).

    lens (n_slots,) int and mask (n_slots,) bool are device tensors; no host
    sync happens here. An encoder-decoder's "cross" leaves are no update
    and stay as they are (F13). A quantized leaf takes rows the model
    already quantized, never floats."""
    ar = torch.arange(mask.shape[0], device=mask.device)
    for path, leaf in leaves(caches):
        if cross(path):
            continue
        leaf = grouped(path, leaf)
        up = grouped(path, leaf_at(updates, path))
        if not growing(path):
            leaf.copy_(torch.where(_slot_mask(mask, leaf.dim()),
                                   up.to(leaf.dtype), leaf))
            continue
        if not leaf.dtype.is_floating_point and up.dtype != leaf.dtype:
            raise ValueError(f"{'/'.join(path)}: a decode step's {up.dtype} "
                             f"rows for a {leaf.dtype} cache: the model "
                             "quantizes them (`quantize_kv`)")
        pos = lens.clamp(max=leaf.shape[2] - 1).long()
        old = leaf[:, ar, pos]  # (G, B, Hkv, hd); MLA's (G, B, rank)
        leaf[:, ar, pos] = torch.where(_slot_mask(mask, old.dim()),
                                       up[:, :, 0].to(leaf.dtype), old)


def slice_slot_prefix(caches, slot: int, ctx: int):
    """Views of ONE slot's cache: growing leaves trimmed to the `ctx`
    bucket, (G, 1, ctx, ...) under "groups" and (1, ctx, ...) under "rem",
    fixed states as the slot's row. Positions at/beyond the slot's live
    length hold stale bytes; callers mask them via kv_lens. Views see later
    in-place writes."""
    def take(path, leaf):
        ax = _slot_axis(path)
        idx = (slice(None),) * ax + (slice(slot, slot + 1),)
        return leaf[idx + ((slice(None, ctx),) if growing(path) else ())]
    return map_leaves(take, caches)


def gather_slot_prefix(caches, slot: torch.Tensor, ctx: int):
    """`slice_slot_prefix` with the slot as a device tensor ((1,) int): the
    same rows, gathered by index into new tensors — a copy, as the
    reference's `dynamic_slice` is one, so a CUDA graph can read any slot
    (`engine.programs`). Later writes to the cache do not show in it."""
    slot = slot.long()

    def take(path, leaf):
        ax = _slot_axis(path)
        if growing(path):
            leaf = leaf.narrow(ax + 1, 0, min(ctx, leaf.shape[ax + 1]))
        return leaf.index_select(ax, slot)
    return map_leaves(take, caches)


@torch.no_grad()
def fold_prefill_at(caches, new_caches, slot: torch.Tensor,
                    offset: torch.Tensor,
                    cfg: Optional[ModelConfig] = None) -> None:
    """`fold_prefill` with the slot and the offset as device tensors ((1,)
    int): the same bytes written, by `index_copy_` / `index_put_` on the
    slot axis, so a CUDA graph can write any slot at any offset and the host
    reads nothing. It cannot refuse a region that runs off the buffer
    without a host read, so the caller checks that before (the replica's
    `_check_prefill_room` and `_prefill_pad`). An append's result holds no
    "cross" leaves, and they are left as they are. `cfg` quantizes float
    rows for a quantized cache (`stored`)."""
    slot = slot.long()
    for path, leaf in leaves(caches):
        if cross(path) and "cross" not in new_caches:
            continue
        leaf = grouped(path, leaf)
        new = stored(path, leaf, grouped(path, leaf_at(new_caches, path)),
                     cfg)
        if not growing(path):
            leaf.index_copy_(1, slot, new)
            continue
        rows = offset.long() + torch.arange(new.shape[2], device=leaf.device)
        leaf[:, slot[:, None], rows[None, :]] = new


@torch.no_grad()
def fold_prefill(caches, new_caches, slot: int, offset: int,
                 cfg: Optional[ModelConfig] = None) -> None:
    """Write a (batch=1) prefill result into slot `slot`, in place: growing
    rows at [offset, offset+S), fixed states replacing the slot's row. The
    written region may extend past the slot's live length (bucketed token
    padding); reads are masked via kv_lens. A region that would run off the
    buffer raises — it is never clamped or cut (the replica's
    `_check_prefill_room` and `_prefill_pad` keep the serve path inside).
    An append's result holds no "cross" leaves, and they are left as they
    are. `cfg` quantizes float rows for a quantized cache (`stored`)."""
    for path, leaf in leaves(caches):
        if cross(path) and "cross" not in new_caches:
            continue
        leaf = grouped(path, leaf)
        new = stored(path, leaf, grouped(path, leaf_at(new_caches, path)),
                     cfg)
        if not growing(path):
            leaf[:, slot:slot + 1] = new
            continue
        S, L = new.shape[2], leaf.shape[2]
        if offset < 0 or offset + S > L:
            raise RuntimeError(
                f"fold_prefill: rows [{offset}, {offset + S}) of slot {slot} "
                f"do not fit a buffer of {L} positions")
        leaf[:, slot:slot + 1, offset:offset + S] = new


class SlotKVCache:
    """Owns the cache tree (batch dim = n_slots) plus per-slot lengths."""

    def __init__(self, model: Model, n_slots: int, max_ctx: int,
                 replica_id: Optional[int] = None, device=None):
        self.model = model
        self.cfg = model.cfg
        self.n_slots = n_slots
        self.max_ctx = max_ctx
        self.replica_id = replica_id  # diagnostics only (acquire() error)
        window = self.cfg.window
        if ATTN_LOCAL in self.cfg.layer_kinds() and window and \
                max_ctx > window:
            who = "?" if replica_id is None else replica_id
            raise ValueError(
                f"replica {who}: max_ctx {max_ctx} > window {window} of "
                f"{self.cfg.name}'s local-attention layers: their cache is "
                f"{window} rows long, and a slot would write rows past its "
                f"end (F5); use max_ctx <= {window}")
        self.caches = model.init_cache(n_slots, max_ctx, device=device)
        self.device = next(t for _, t in leaves(self.caches)).device
        self.lengths = np.zeros(n_slots, np.int32)
        self.active = np.zeros(n_slots, bool)

    # ----- slot management -----------------------------------------------------
    def acquire(self) -> int:
        free = np.flatnonzero(~self.active)
        if len(free) == 0:
            # Unreachable from the serve path: EngineServer admits every
            # slot-holding stage through the per-node admission queue and
            # only acquires after _can_admit saw a free slot. Kept loud for
            # direct misuse of the cache API.
            who = "?" if self.replica_id is None else self.replica_id
            raise RuntimeError(
                f"no free KV slots on replica {who}: "
                f"{int(self.active.sum())}/{self.n_slots} slots active, "
                f"{self.active_kv_tokens} live KV tokens; serve-path callers "
                f"must wait in the node's admission queue instead of "
                f"acquiring directly")
        s = int(free[0])
        self.active[s] = True
        self.lengths[s] = 0
        return s

    def release(self, slot: int):
        self.active[slot] = False
        self.lengths[slot] = 0

    def invalidate_all(self):
        """Replica failure: every slot's contents are gone at once. Host
        bookkeeping zeroes so the observables mirror the dead cache; the
        device tensors stay allocated — stale bytes on a dead replica are
        unreachable, and a revived replica re-prefills before any read."""
        self.active[:] = False
        self.lengths[:] = 0

    @property
    def active_kv_tokens(self) -> int:
        return int(self.lengths[self.active].sum())

    def kv_lens(self) -> torch.Tensor:
        return torch.as_tensor(self.lengths, device=self.device)

    # ----- writes ----------------------------------------------------------------
    def write_prefill(self, slot: int, new_caches, length: int):
        """Install a (batch=1) prefill result into `slot` in place at
        [current length, ...). `length` = the slot's total live length
        afterwards."""
        prev = int(self.lengths[slot])
        fold_prefill(self.caches, new_caches, slot, prev, self.cfg)
        self.lengths[slot] = length

    def append_step(self, updates, emitted_mask: np.ndarray):
        """REFERENCE PATH: fold one decode step's updates in, with the live
        mask coming from the host. emitted_mask marks slots that actually
        decoded (others keep their rows and states)."""
        fold_decode_step(self.caches, updates, self.kv_lens(),
                         torch.as_tensor(emitted_mask, device=self.device))
        self.lengths[emitted_mask] += 1

    # ----- transfer --------------------------------------------------------------
    def export_slot(self, slot: int) -> Dict[str, Any]:
        """A COPY of one slot's live cache — growing rows up to its length,
        fixed states whole — for KV transfer between replicas: it stays
        valid after the slot is released and reused."""
        length = int(self.lengths[slot])
        rows = slice_slot_prefix(self.caches, slot, length)
        return {"caches": map_leaves(lambda _, t: t.clone(), rows),
                "length": length}

    def import_slot(self, slot: int, package: Dict[str, Any]):
        """Install a transferred package as the slot's whole live cache, from
        position 0, whatever the slot held before. A remote turn returns the
        grown KV to the decoder's occupied slot; the JAX package's
        `import_slot` writes it at the slot's current length instead (F11),
        which misplaces every row the remote turn returns."""
        fold_prefill(self.caches, package["caches"], slot, 0, self.cfg)
        self.lengths[slot] = package["length"]

    def export_slot_full(self, slot: int):
        """Full-buffer prefix VIEW of a slot (growing leaves right-padded
        beyond the live length; callers mask with kv_lens +
        prefix_start=0)."""
        return slice_slot_prefix(self.caches, slot, self.max_ctx)

    def nbytes_of(self, package) -> int:
        return sum(t.numel() * t.element_size()
                   for _, t in leaves(package["caches"]))


# ----- prefix KV pool ---------------------------------------------------------
def prefix_hash(tokens: Sequence[int]) -> str:
    """Content hash of a token prefix — the pool key. Hashing the TOKENS
    (not a trace-level preamble id) means two conversations share pooled
    rows iff their prefix bytes are actually identical. Byte-identical to
    the JAX package's key: blake2b-128 over the int32 tokens."""
    arr = np.asarray(tokens, np.int32)
    return hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest()
