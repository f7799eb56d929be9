"""A model replica: weights + slot KV cache + the prefill and decode paths,
with bucketed prefill lengths and greedy sampling on the device.

The surface is the JAX package's `ReplicaEngine`, the one `EngineServer`
touches. PyTorch runs eagerly, so where the reference compiles one donated
program per bucket the port runs the same steps as torch ops that write the
slot cache IN PLACE (see `kvcache`):

* Turn-1 prefill (`prefill_conversation`) pads the tokens to a length
  bucket (or to the exact length when the bucket would not fit the slot),
  runs the forward, gathers the logits at the last live position, takes the
  greedy argmax on the device and folds the new K/V into the slot.
  A declared shared preamble always splits the prefill at its boundary and
  may be served from the node's prefix pool.
* Append-prefill (`append_prefill`) reads the slot's own prefix as a view
  trimmed to its ctx bucket and masks the padding with kv_lens.
* The decode chunk (`decode_steps`) is a Python loop over a RAGGED chunk:
  slot s is live only while step < remaining[s]. The sampled token is fed
  back on the device and the host syncs once per chunk.

A model with recurrent layers (RWKV6, RG-LRU) never pads a prefill or an
append to a bucket: every position it consumes moves its state, so padding
would corrupt it. It runs at the exact length in both prefill modes.

With `attention_impl="cuda"` (the default) fresh global prefill attention
runs in the hand-written kernel K2, global decode attention in K1, the RWKV6
prefill's WKV recurrence in K3 and the RG-LRU prefill's recurrence in K4; a
CPU replica uses the kernels' plain versions (the tensors lie on the CPU).
Local (sliding-window) attention is torch ops under both impls, as in the
reference. "torch" keeps the online-softmax paths of `models.attention`,
the chunked `wkv6_chunked` and the log-depth `rglru_scan_logdepth`.
`prefill_mode="reference"` and `decode_step_all_reference` replay the
reference paths (full-buffer prefix view, host-side sampling, one step per
call) as the parity oracles.

Timing: every measured dt ends in `torch.cuda.synchronize()` on a CUDA
replica. Building the CUDA kernels is charged to `compile_s` of the replica
that triggered it, never to a dt.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.runtime import PrefixKVPool
from repro_torch.kernels import _build
from repro_torch.models import build_model
from repro_torch.models.config import RGLRU, RWKV6, ModelConfig

from .kvcache import (SlotKVCache, fold_decode_step, fold_prefill, grouped,
                      growing, map_leaves, prefix_hash, slice_slot_prefix)

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)

DECODE_CHUNKS = (1, 2, 4, 8, 16, 32)
CTX_BUCKET_MIN = 64


def bucket_len(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return -(-n // 4096) * 4096


def decode_chunk_bucket(n: int) -> int:
    """Smallest chunk bucket covering n steps: it sizes the trimmed ctx
    read of a chunk, as in the reference."""
    for b in DECODE_CHUNKS:
        if n <= b:
            return b
    return DECODE_CHUNKS[-1]


def decode_chunk_floor(n: int) -> int:
    """Largest chunk bucket <= n (floor 1): the chunk size
    EngineServer._iterate dispatches."""
    f = 1
    for b in DECODE_CHUNKS:
        if b <= n:
            f = b
    return f


def ctx_bucket(n: int, max_ctx: int) -> int:
    """Power-of-two live-context bucket for the trimmed decode read."""
    b = CTX_BUCKET_MIN
    while b < n:
        b *= 2
    return min(b, max_ctx)


class ReplicaEngine:
    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 8,
                 max_ctx: int = 2048, replica_id: int = 0, role: str = "decode",
                 attention_impl: str = "cuda", prefill_mode: str = "jit",
                 prefix_pool_tokens: int = 0):
        """params: the `LM` module (from `Model.init` or
        `convert.params_from_numpy`); the replica runs on its device.
        attention_impl: "cuda" (default) sends fresh global prefill
        attention through K2, global decode attention through K1, the RWKV6
        WKV recurrence through K3 and the RG-LRU recurrence through K4
        (plain versions on a CPU replica); "torch" keeps the torch paths.
        A model with a local-attention layer needs max_ctx <= its window
        (`SlotKVCache` refuses a longer one).
        prefill_mode: "jit" (the name the server uses for the fast path)
        reads an append prefix as a view trimmed to its ctx bucket and
        samples on the device; "reference" replays the eager oracle
        (full-buffer prefix view, host-side sampling). Both give the same
        tokens and caches (byte-identical in the CPU tests).
        prefix_pool_tokens: live-token budget for the node-level prefix KV
        pool (0 = no pool). A turn-1 prefill with `prefix_len` > 0 ALWAYS
        splits at that boundary; the pool only changes where the prefix
        rows come from."""
        if prefill_mode not in ("jit", "reference"):
            raise ValueError(f"prefill_mode {prefill_mode!r} not in "
                             "('jit', 'reference')")
        if attention_impl not in ("cuda", "torch"):
            raise ValueError(f"attention_impl {attention_impl!r} not in "
                             "('cuda', 'torch')")
        self.cfg = cfg
        self.model = build_model(cfg)
        self.params = params
        self.device = params.device
        self.kv = SlotKVCache(self.model, n_slots, max_ctx,
                              replica_id=replica_id, device=self.device)
        self.replica_id = replica_id
        self.role = role
        self.attention_impl = attention_impl
        # recurrent prefill consumes every position: padding would corrupt
        # the state, so such a model prefills at the exact length
        self.exact_prefill = any(k in (RWKV6, RGLRU)
                                 for k in cfg.block_pattern)
        self.prefill_mode = prefill_mode
        self.compute_s = 0.0  # accumulated measured compute time
        self.compile_s = 0.0  # kernel build time (OUT of dt)
        self.decode_s = 0.0   # decode-only share of compute_s
        self.prefill_s = 0.0  # prefill-only share of compute_s
        self.n_prefill_tokens = 0
        self.n_decode_tokens = 0
        self.prefix_pool = (PrefixKVPool(prefix_pool_tokens)
                            if prefix_pool_tokens > 0 else None)
        self.n_pooled_prefix_tokens = 0

    # ----- device helpers ---------------------------------------------------------
    def _kernels_ready(self):
        """Build the CUDA kernels before the first timed call on a CUDA
        replica; the seconds go to compile_s, never into a dt."""
        if self.attention_impl == "cuda" and self.device.type == "cuda":
            self.compile_s += _build.ensure_built()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int32), device=self.device)

    # ----- sampling -------------------------------------------------------------
    def sample(self, logits) -> np.ndarray:
        """Greedy over the true vocab (mask table padding), on the host."""
        logits = logits[..., : self.cfg.vocab_size].float().cpu().numpy()
        return np.argmax(logits, axis=-1).astype(np.int32)

    def _argmax(self, logits) -> torch.Tensor:
        return logits[..., : self.cfg.vocab_size].argmax(dim=-1).to(
            torch.int32)

    # ----- prefill ----------------------------------------------------------------
    def _check_prefill_room(self, slot: int, need: int):
        """A write past the buffer would fail part-way while host lengths
        advance — refuse loudly, naming the slot, in BOTH prefill modes
        (mirrors the decode_steps overflow guard)."""
        prev = int(self.kv.lengths[slot])
        if prev + need > self.kv.max_ctx:
            raise RuntimeError(
                f"prefill overflow on replica {self.replica_id}: slot {slot} "
                f"at length {prev} cannot take {need} more tokens "
                f"(max_ctx={self.kv.max_ctx})")

    def _prefill_pad(self, true_len: int, room: int) -> int:
        """Padded token length for a prefill whose slot has `room` positions
        left: the length bucket, or the exact length when the padded write
        would not fit the slot (the write is never clamped) or the model is
        recurrent (`exact_prefill`)."""
        if self.exact_prefill:
            return true_len
        pad = bucket_len(true_len)
        return pad if pad <= room else true_len

    def _padded(self, tokens, pad_to: int) -> torch.Tensor:
        toks = np.zeros(pad_to, np.int32)
        toks[:len(tokens)] = tokens
        return self._tokens(toks)[None]

    def _account_prefill(self, t0: float, n_tokens: int) -> float:
        self._sync()
        dt = time.perf_counter() - t0
        self.compute_s += dt
        self.prefill_s += dt
        self.n_prefill_tokens += n_tokens
        return dt

    def prefill_conversation(self, slot: int, tokens: np.ndarray,
                             frontend_embeds=None, prefix_len: int = 0
                             ) -> Tuple[np.int32, float]:
        """Turn-1 prefill into `slot`. Returns (next_token, measured_s).

        `prefix_len` > 0 declares tokens[:prefix_len] a SHARED PREAMBLE and
        ALWAYS splits the prefill at that boundary — turn-1 class on the
        preamble, append class on the delta — pool or no pool, so per-turn
        token streams are byte-identical pool-on vs pool-off."""
        if frontend_embeds is not None:
            raise NotImplementedError("frontend embeds are not ported to "
                                      "repro_torch yet")
        true_len = len(tokens)
        if prefix_len:
            if not 0 < prefix_len < true_len:
                raise ValueError(
                    f"prefill_conversation: prefix_len {prefix_len} must be "
                    f"in (0, {true_len}) — the turn needs a non-empty delta "
                    f"after the shared preamble")
            return self._prefill_split(slot, np.asarray(tokens, np.int32),
                                       int(prefix_len))
        self._check_prefill_room(slot, true_len)
        self._kernels_ready()
        if self.prefill_mode == "reference":
            return self._prefill_reference(slot, tokens)
        pad_to = self._prefill_pad(true_len, self.kv.max_ctx)
        t0 = time.perf_counter()
        logits, new = self.model.prefill(
            self.params, self._padded(tokens, pad_to),
            logits_at=true_len - 1, attention_impl=self.attention_impl)
        fold_prefill(self.kv.caches, new, slot, 0)
        tok = int(self._argmax(logits[0]))
        self.kv.lengths[slot] = true_len
        dt = self._account_prefill(t0, true_len)
        return np.int32(tok), dt

    def _prefill_split(self, slot: int, tokens: np.ndarray, prefix_len: int
                       ) -> Tuple[np.int32, float]:
        """Shared-preamble turn-1 prefill. Pool hit -> fold the pooled rows
        and append the delta; miss or no pool -> turn-1 class on the
        preamble, pool populate (when enabled), append class on the delta."""
        self._check_prefill_room(slot, len(tokens))
        prefix = tokens[:prefix_len]
        delta = tokens[prefix_len:]
        pool = self.prefix_pool
        key = prefix_hash(prefix) if pool is not None else None
        if pool is not None and pool.contains(key):
            return self._prefill_from_pool(slot, key, delta, prefix_len)
        tok_p, dt = self.prefill_conversation(slot, prefix)
        del tok_p  # the preamble's sampled token is never emitted
        if pool is not None:
            t0 = time.perf_counter()
            ctx = ctx_bucket(prefix_len, self.kv.max_ctx)
            rows = self._materialize_prefix(slot, prefix_len, ctx)
            pool.put(key, rows, prefix_len, ctx)
            self._sync()
            export_dt = time.perf_counter() - t0
            self.compute_s += export_dt
            self.prefill_s += export_dt
            dt += export_dt
        tok, dt_a = self.append_prefill(slot, delta)
        return tok, dt + dt_a

    def _materialize_prefix(self, slot: int, length: int, ctx: int):
        """Copy a slot's first `length` cache rows out at ctx bucket `ctx`,
        zero-masked beyond `length`, and its fixed states unmasked — the
        immutable pooled representation. Runs before the delta append
        writes into the slot (the states would otherwise hold the whole
        context, not the preamble's)."""
        rows = slice_slot_prefix(self.kv.caches, slot, ctx)
        live = torch.arange(ctx, device=self.device) < length

        def copy(path, leaf):
            if not growing(path):
                return leaf.clone()
            g = grouped(path, leaf)
            m = live.reshape((1, 1, ctx) + (1,) * (g.dim() - 3))
            return torch.where(m, g, torch.zeros_like(g)).reshape(leaf.shape)
        return map_leaves(copy, rows)

    def _prefill_from_pool(self, slot: int, key: str, delta: np.ndarray,
                           prefix_len: int) -> Tuple[np.int32, float]:
        """Pool-hit turn-1: fold the pooled preamble rows into the slot and
        run the delta forward against them — zero preamble FLOPs. The entry
        is pinned across the read; `get` records the observed hit."""
        pool = self.prefix_pool
        e = pool.get(key)
        pool.pin(key)
        try:
            self._kernels_ready()
            t0 = time.perf_counter()
            fold_prefill(self.kv.caches, e.caches, slot, 0)
            self.kv.lengths[slot] = prefix_len
            if self.prefill_mode == "reference":
                fold_dt = self._account_prefill(t0, 0)
                tok, dt = self._append_reference(slot, delta)
                self.n_pooled_prefix_tokens += prefix_len
                return tok, fold_dt + dt
            tok = self._append_fast(slot, delta, prefix_len, e.ctx)
            dt = self._account_prefill(t0, len(delta))
            self.n_pooled_prefix_tokens += prefix_len
            return np.int32(tok), dt
        finally:
            pool.unpin(key)

    def _prefill_reference(self, slot: int, tokens: np.ndarray
                           ) -> Tuple[np.int32, float]:
        """REFERENCE PATH: eager forward + `write_prefill` + host-side
        sampling. The parity oracle and benchmark baseline."""
        t0 = time.perf_counter()
        true_len = len(tokens)
        pad_to = self._prefill_pad(true_len, self.kv.max_ctx)
        logits, caches = self.model.prefill(
            self.params, self._padded(tokens, pad_to),
            logits_at=true_len - 1 if pad_to != true_len else None,
            attention_impl=self.attention_impl)
        self.kv.write_prefill(slot, caches, true_len)
        tok = self.sample(logits)[0]
        dt = self._account_prefill(t0, true_len)
        return tok, dt

    def _append_fast(self, slot: int, tokens: np.ndarray, prev: int,
                     ctx: int) -> int:
        """The append forward of the fast path: prefix = the slot's own rows
        trimmed to `ctx` (a view), padding masked via kv_lens, new K/V
        written in place at `prev`, argmax on the device."""
        true_len = len(tokens)
        pad_to = self._prefill_pad(true_len, self.kv.max_ctx - prev)
        prefix = slice_slot_prefix(self.kv.caches, slot, ctx)
        lens = torch.tensor([prev], dtype=torch.int32, device=self.device)
        logits, new = self.model.prefill(
            self.params, self._padded(tokens, pad_to), caches=prefix,
            start_pos=prev, kv_lens=lens, prefix_start=0,
            logits_at=true_len - 1, attention_impl=self.attention_impl)
        fold_prefill(self.kv.caches, new, slot, prev)
        tok = int(self._argmax(logits[0]))
        self.kv.lengths[slot] = prev + true_len
        return tok

    def append_prefill(self, slot: int, tokens: np.ndarray
                       ) -> Tuple[np.int32, float]:
        """Turn-2+ prefill against the slot's cached prefix (local, prefix
        cache hit — the ConServe fast path). Returns (next_token,
        measured_s)."""
        true_len = len(tokens)
        self._check_prefill_room(slot, true_len)
        self._kernels_ready()
        if self.prefill_mode == "reference":
            return self._append_reference(slot, tokens)
        prev = int(self.kv.lengths[slot])
        ctx = ctx_bucket(max(prev, 1), self.kv.max_ctx)
        t0 = time.perf_counter()
        tok = self._append_fast(slot, tokens, prev, ctx)
        dt = self._account_prefill(t0, true_len)
        return np.int32(tok), dt

    def _append_reference(self, slot: int, tokens: np.ndarray
                          ) -> Tuple[np.int32, float]:
        """REFERENCE PATH: eager forward over the full-buffer prefix view
        (`export_slot_full`) + `write_prefill` + host-side sampling."""
        t0 = time.perf_counter()
        true_len = len(tokens)
        prev = int(self.kv.lengths[slot])
        pad_to = self._prefill_pad(true_len, self.kv.max_ctx - prev)
        prefix = self.kv.export_slot_full(slot)
        lens = torch.tensor([prev], dtype=torch.int32, device=self.device)
        logits, caches = self.model.prefill(
            self.params, self._padded(tokens, pad_to), caches=prefix,
            start_pos=prev, kv_lens=lens, prefix_start=0,
            logits_at=true_len - 1 if pad_to != true_len else None,
            attention_impl=self.attention_impl)
        self.kv.write_prefill(slot, caches, prev + true_len)
        tok = self.sample(logits)[0]
        dt = self._account_prefill(t0, true_len)
        return tok, dt

    # ----- decode -----------------------------------------------------------------
    def _remaining_vector(self, emit_mask: np.ndarray,
                          remaining) -> np.ndarray:
        """Normalize `remaining` (scalar or per-slot vector) into a
        validated per-slot int32 vector, enforcing the per-slot overflow
        guard (raises naming the offending slot, not the batch max)."""
        if np.ndim(remaining) == 0:
            n = int(max(1, min(int(remaining), DECODE_CHUNKS[-1])))
            rem = np.where(emit_mask, n, 0).astype(np.int32)
        else:
            rem = np.asarray(remaining, np.int32).copy()
            if rem.shape != emit_mask.shape:
                raise ValueError(
                    f"decode_steps: remaining shape {rem.shape} != "
                    f"emit_mask shape {emit_mask.shape}")
            rem[~emit_mask] = 0
            bad = emit_mask & (rem <= 0)
            if bad.any():
                raise ValueError(
                    "decode_steps: emitting slot(s) "
                    f"{np.flatnonzero(bad).tolist()} have non-positive "
                    "remaining")
            big = emit_mask & (rem > DECODE_CHUNKS[-1])
            if big.any():
                # the contract is 'slot s consumes EXACTLY remaining[s]
                # tokens' — silently clamping would desync the caller's
                # bookkeeping from kv.lengths, so refuse instead
                s = int(np.flatnonzero(big)[0])
                raise ValueError(
                    f"decode_steps: slot {s} remaining {int(rem[s])} "
                    f"exceeds the largest chunk {DECODE_CHUNKS[-1]}; chunk "
                    f"the call")
        over = emit_mask & (self.kv.lengths + rem > self.kv.max_ctx)
        if over.any():
            s = int(np.flatnonzero(over)[0])
            raise RuntimeError(
                f"decode_steps overflow: slot {s} at length "
                f"{int(self.kv.lengths[s])} cannot take {int(rem[s])} more "
                f"tokens (max_ctx={self.kv.max_ctx})")
        return rem

    @torch.no_grad()
    def decode_steps(self, next_tokens: np.ndarray, emit_mask: np.ndarray,
                     remaining) -> Tuple[np.ndarray, float]:
        """Run one RAGGED decode chunk across ALL slots (inactive slots
        compute in lockstep but are masked out).

        `remaining` is a scalar (every emitting slot consumes exactly that
        many tokens, clamped into [1, DECODE_CHUNKS[-1]]) or a per-slot
        vector (slot s consumes exactly remaining[s] tokens, then freezes:
        its KV stops folding, its length stops advancing, its fed-back token
        freezes). Returns (sampled (max(remaining), n_slots) int32 in step
        order — rows >= remaining[s] are dead for slot s — and measured
        seconds).

        SPLIT-CHUNK CONTRACT: callable back-to-back on the same cache with
        slots joining between calls; each lane reads only its own slot's
        row and length, so any partition of a turn into chunk cuts gives
        byte-identical per-slot tokens and cache state."""
        emit_mask = np.asarray(emit_mask, bool)
        rem = self._remaining_vector(emit_mask, remaining)
        n_max = max(1, int(rem.max()) if emit_mask.any() else 1)
        n_steps = decode_chunk_bucket(n_max)
        live_max = int(self.kv.lengths[emit_mask].max()) if emit_mask.any() \
            else 0
        ctx_limit = ctx_bucket(live_max + n_steps, self.kv.max_ctx)
        self._kernels_ready()
        vocab = self.cfg.vocab_size
        t0 = time.perf_counter()
        dev = self.device
        tokens = torch.as_tensor(np.asarray(next_tokens, np.int32), device=dev)
        lens = torch.as_tensor(self.kv.lengths, device=dev)
        emit = torch.as_tensor(emit_mask, device=dev)
        rem_t = torch.as_tensor(rem, device=dev)
        seq = []
        for i in range(n_max):
            logits, updates = self.model.decode_step(
                self.params, tokens, self.kv.caches, lens, kv_lens=lens,
                ctx_limit=ctx_limit, attention_impl=self.attention_impl)
            sampled = logits[:, :vocab].argmax(dim=-1).to(torch.int32)
            live = emit & (rem_t > i)
            fold_decode_step(self.kv.caches, updates, lens, live)
            lens = lens + live.to(lens.dtype)
            tokens = torch.where(live, sampled, tokens)
            seq.append(sampled)
        out = torch.stack(seq).cpu().numpy()  # the one host sync per chunk
        self.kv.lengths += np.where(emit_mask, rem, 0).astype(np.int32)
        self._sync()
        dt = time.perf_counter() - t0
        self.compute_s += dt
        self.decode_s += dt
        self.n_decode_tokens += int(rem[emit_mask].sum())
        return out, dt

    def decode_step_all(self, next_tokens: np.ndarray,
                        emit_mask: np.ndarray) -> Tuple[np.ndarray, float]:
        """One decode iteration across ALL slots via the chunk path.
        Returns (sampled (n_slots,), measured_s)."""
        seq, dt = self.decode_steps(next_tokens, emit_mask, 1)
        return seq[0], dt

    @torch.no_grad()
    def decode_step_all_reference(self, next_tokens: np.ndarray,
                                  emit_mask: np.ndarray
                                  ) -> Tuple[np.ndarray, float]:
        """REFERENCE PATH: one step over the full (untrimmed) cache, host
        sync + host-side argmax, cache append via `append_step`. Kept as
        the parity oracle and benchmark baseline."""
        emit_mask = np.asarray(emit_mask, bool)
        self._kernels_ready()
        t0 = time.perf_counter()
        lens = self.kv.kv_lens()
        logits, updates = self.model.decode_step(
            self.params, self._tokens(next_tokens), self.kv.caches,
            lens, kv_lens=lens,
            attention_impl=self.attention_impl)
        sampled = self.sample(logits)
        self.kv.append_step(updates, emit_mask)
        self._sync()
        dt = time.perf_counter() - t0
        self.compute_s += dt
        self.decode_s += dt
        self.n_decode_tokens += int(emit_mask.sum())
        return sampled, dt
