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

Two index rules of the JAX package do not carry over to torch, and both are
made explicit here: JAX drops a scatter that falls outside the array (torch
raises or writes out of bounds), and `dynamic_update_slice` clamps a start
that would run off the buffer (a torch slice silently writes less). So
`fold_decode_step` clamps the row it touches and writes back the old row for
slots that are not live, and `fold_prefill` refuses a write that does not
fit.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.model import Model

def leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                             torch.Tensor]]:
    """(path, tensor) of every leaf of a nested-dict cache tree, in a fixed
    (insertion) order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v


def kv_tree(kv: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """{"k", "v"} leaves -> the cache tree {"groups": {"p0": {...}}}."""
    return {"groups": {"p0": kv}}


def kv_leaves(tree) -> Dict[str, torch.Tensor]:
    """The cache tree's {"k", "v"} leaves, each (n_layers, batch, L, Hkv,
    hd): every ported layer is a global-attention layer of the one-kind
    pattern, stacked under "groups"/"p0"."""
    return tree["groups"]["p0"]


@torch.no_grad()
def fold_decode_step(caches, updates, lens: torch.Tensor,
                     mask: torch.Tensor) -> None:
    """Fold one decode step's K/V into `caches`, in place, at each slot's
    current length.

    ``mask`` is the per-step LIVE mask (the ragged scan passes
    ``emit & (step < remaining)``): a slot that is not live keeps its row
    byte-identical. Its row index is clamped into the buffer and its old
    bytes are written back, so a slot filled to exactly max_ctx — which the
    replica's overflow guard allows — never indexes past the end. A live
    slot always has room (the guard in `ReplicaEngine._remaining_vector`).

    lens (n_slots,) int and mask (n_slots,) bool are device tensors; no host
    sync happens here."""
    ar = torch.arange(mask.shape[0], device=mask.device)
    ups = kv_leaves(updates)
    for name, leaf in kv_leaves(caches).items():
        pos = lens.clamp(max=leaf.shape[2] - 1).long()
        old = leaf[:, ar, pos]  # (G, B, Hkv, hd)
        leaf[:, ar, pos] = torch.where(mask[None, :, None, None],
                                       ups[name][:, :, 0].to(leaf.dtype), old)


def slice_slot_prefix(caches, slot: int, ctx: int):
    """Views of ONE slot's cache rows trimmed to the `ctx` bucket:
    (G, 1, ctx, Hkv, hd). Positions at/beyond the slot's live length hold
    stale bytes; callers mask them via kv_lens. Views see later in-place
    writes."""
    return kv_tree({n: leaf[:, slot:slot + 1, :ctx]
                    for n, leaf in kv_leaves(caches).items()})


@torch.no_grad()
def fold_prefill(caches, new_caches, slot: int, offset: int) -> None:
    """Write a (batch=1) prefill result into slot `slot`, in place, at rows
    [offset, offset+S). The written region may extend past the slot's live
    length (bucketed token padding); reads are masked via kv_lens. A region
    that would run off the buffer raises — it is never clamped or cut (the
    replica's `_check_prefill_room` and `_prefill_pad` keep the serve path
    inside)."""
    new = kv_leaves(new_caches)
    for name, leaf in kv_leaves(caches).items():
        S, L = new[name].shape[2], leaf.shape[2]
        if offset < 0 or offset + S > L:
            raise RuntimeError(
                f"fold_prefill: rows [{offset}, {offset + S}) of slot {slot} "
                f"do not fit a buffer of {L} positions")
        leaf[:, slot:slot + 1, offset:offset + S] = new[name].to(leaf.dtype)


class SlotKVCache:
    """Owns the cache tree (batch dim = n_slots) plus per-slot lengths."""

    def __init__(self, model: Model, n_slots: int, max_ctx: int,
                 replica_id: Optional[int] = None, device=None):
        self.model = model
        self.cfg = model.cfg
        self.n_slots = n_slots
        self.max_ctx = max_ctx
        self.replica_id = replica_id  # diagnostics only (acquire() error)
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
        fold_prefill(self.caches, new_caches, slot, prev)
        self.lengths[slot] = length

    def append_step(self, updates, emitted_mask: np.ndarray):
        """REFERENCE PATH: fold one decode step's K/V in, with the live mask
        coming from the host. emitted_mask marks slots that actually decoded
        (others keep their rows)."""
        fold_decode_step(self.caches, updates, self.kv_lens(),
                         torch.as_tensor(emitted_mask, device=self.device))
        self.lengths[emitted_mask] += 1

    # ----- transfer --------------------------------------------------------------
    def export_slot(self, slot: int) -> Dict[str, Any]:
        """A COPY of one slot's live cache (for KV transfer between
        replicas): it stays valid after the slot is released and reused."""
        length = int(self.lengths[slot])
        return {"caches": kv_tree({n: leaf[:, slot:slot + 1, :length].clone()
                                   for n, leaf in kv_leaves(
                                       self.caches).items()}),
                "length": length}

    def import_slot(self, slot: int, package: Dict[str, Any]):
        self.write_prefill(slot, package["caches"], package["length"])

    def export_slot_full(self, slot: int):
        """Full-buffer prefix VIEW of a slot (right-padded beyond the live
        length; callers mask with kv_lens + prefix_start=0)."""
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
