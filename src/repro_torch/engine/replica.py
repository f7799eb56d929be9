"""A model replica: weights + slot KV cache + the prefill and decode paths,
with bucketed prefill lengths and greedy sampling on the device.

The surface is the JAX package's `ReplicaEngine`, the one `EngineServer`
touches. Where the reference compiles one donated program per bucket, the
port builds one `programs.Program` per bucket key — static device buffers,
a body that writes the slot cache IN PLACE (see `kvcache`) and, on a CUDA
replica, the CUDA graph of that body, replayed on every later call:

* The decode chunk (`decode_steps`), keyed (n_steps, ctx_limit) as the
  reference's `_get_fused`: a RAGGED chunk, slot s live only while step <
  remaining[s]. The sampled token is fed back on the device and the host
  syncs once per chunk. The graph runs the bucket's n_steps, as the
  reference's scan does; an eager run stops after max(remaining) — frozen
  lanes change nothing, so the two leave the same tokens and caches.
* Turn-1 prefill (`prefill_conversation`), keyed (pad_to, n_front) as the
  reference's `_get_prefill`: the tokens padded to the length bucket after
  a vision model's n_front patch embeddings (copied into the program's
  static input buffer before each run), the logits gathered at the last
  live text position, the greedy argmax on the device and the new K/V —
  the frontend's positions first — folded into the slot by device index.
* Append-prefill (`append_prefill`), keyed (pad_to, ctx) (the reference's
  `_get_append`): the slot's own prefix gathered to its ctx bucket by
  device index, the padding masked with kv_lens.

A prefix-pool hit (`_prefill_from_pool`, the reference's `_get_shared`)
folds the pooled preamble rows into the slot in place and then runs the
delta through the append program its miss would run, keyed (pad_to, ctx)
with ctx the entry's bucket: the same graph on the same inputs.

Three cases run the same bodies eagerly, never through a program:
F2's exact-length prefill (the bucket would not fit the slot; the
reference compiles a one-off program there, and a graph used once costs
more than it saves); every prefill of a model with recurrent layers (RWKV6,
RG-LRU), which never pads — every position it consumes moves its state —
and every prefill of an encoder-decoder (padded to its bucket, with the
logits at the last live position), as the reference's `_prefill_jittable`
keeps them eager. A pool hit in these cases folds and then runs its append
eagerly, as its miss would. An encoder-decoder's decode chunk runs through
its program as any other.

`prefill_mode="reference"` and `decode_step_all_reference` replay the
reference paths (full-buffer prefix view, host-side sampling, one step
per call) as the parity oracles. Programs are built lazily, or ahead of
time by `warmup_decode`, `warmup_prefill` and `warmup=True`.

A frontend's embeddings take slot positions only where they enter the
decoder: a vision model's n_front patches occupy the slot's first rows,
so its length is n_front + true_len; an encoder-decoder's frames go to the
fixed "cross" rows, so its length is true_len (the reference counts the
frames too and then refuses every full-width prefill: ROADMAP queue 3,
F14), and its frames must number `cfg.encoder_seq` (F16).

With `attention_impl="cuda"` (the default) fresh global prefill attention
runs in the hand-written kernel K2, global decode attention in K1, the RWKV6
prefill's WKV recurrence in K3 and the RG-LRU prefill's recurrence in K4; a
CPU replica uses the kernels' plain versions (the tensors lie on the CPU).
Local (sliding-window) attention is torch ops under both impls, as in the
reference. "torch" keeps the online-softmax paths of `models.attention`,
the chunked `wkv6_chunked` and the log-depth `rglru_scan_logdepth`.

Timing: every measured dt ends in `torch.cuda.synchronize()` on a CUDA
replica. Building the CUDA kernels and building a program (its warm-up pass
and its capture) are charged to `compile_s` of the replica that triggered
them, never to a dt, and to the program's `build_s`.

Spans (`engine.trace`, with a ``span`` subscriber on the server's bus):
``replica.prefill``, ``replica.append`` and ``replica.decode`` cover a
call's timed interval, carrying its lengths (``len``, ``prev``; a chunk's
live ``lengths``, ``emit`` and ``rem``), with one child, the program's run:
``programs.replay`` (the address guard and the launch) or
``programs.eager``.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.runtime import PrefixKVPool
from repro_torch.kernels import _build
from repro_torch.models import build_model
from repro_torch.models.config import RGLRU, RWKV6, ModelConfig

from .kvcache import (SlotKVCache, fold_decode_step, fold_prefill,
                      fold_prefill_at, gather_slot_prefix, grouped, growing,
                      leaves, map_leaves, prefix_hash, slice_slot_prefix)
from .programs import Program, pool_bytes, side_stream, uncounted
from .trace import NO_TRACER

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
                 warmup: bool = False, attention_impl: str = "cuda",
                 prefill_mode: str = "jit", prefix_pool_tokens: int = 0,
                 cuda_graphs: bool = True):
        """params: the `LM` module (from `Model.init` or
        `convert.params_from_numpy`); the replica runs on its device.
        warmup: build every decode program this replica can reach
        (`warmup_decode`) and, for a padding family in "jit" mode, every
        prefill and append program (`warmup_prefill`), before serving.
        attention_impl: "cuda" (default) sends fresh global prefill
        attention through K2, global decode attention through K1, the RWKV6
        WKV recurrence through K3 and the RG-LRU recurrence through K4
        (plain versions on a CPU replica); "torch" keeps the torch paths.
        A model with a local-attention layer needs max_ctx <= its window
        (`SlotKVCache` refuses a longer one).
        prefill_mode: "jit" (the name the server uses for the fast path)
        runs a bucketed (append-)prefill through its program — the prefix
        gathered to its ctx bucket, the sampling on the device; "reference"
        replays the eager oracle (full-buffer prefix view, host-side
        sampling). Both give the same tokens and caches (byte-identical in
        the CPU tests).
        prefix_pool_tokens: live-token budget for the node-level prefix KV
        pool (0 = no pool). A turn-1 prefill with `prefix_len` > 0 ALWAYS
        splits at that boundary; the pool only changes where the prefix
        rows come from.
        cuda_graphs: on a CUDA replica, capture each program's body in a
        CUDA graph and replay it (the default); False runs the same bodies
        eagerly on the same buffers — the parity oracle and the baseline of
        the graphs' gain. A CPU replica never captures."""
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
        self.tracer = NO_TRACER  # the serving runtime's, once it has one
        self.attention_impl = attention_impl
        # recurrent prefill consumes every position: padding would corrupt
        # the state, so such a model prefills at the exact length, eagerly
        self.exact_prefill = any(k in (RWKV6, RGLRU)
                                 for k in cfg.block_pattern)
        self.prefill_mode = prefill_mode
        self.cuda_graphs = cuda_graphs
        self.compute_s = 0.0  # accumulated measured compute time
        self.compile_s = 0.0  # kernel and program build time (OUT of dt)
        self.decode_s = 0.0   # decode-only share of compute_s
        self.prefill_s = 0.0  # prefill-only share of compute_s
        self.n_prefill_tokens = 0
        self.n_decode_tokens = 0
        self.prefix_pool = (PrefixKVPool(prefix_pool_tokens)
                            if prefix_pool_tokens > 0 else None)
        self.n_pooled_prefix_tokens = 0
        # the programs, keyed as the reference keys its compiled ones:
        # decode (n_steps, ctx_limit), turn-1 pad_to, append (pad_to, ctx).
        # Per replica: a graph binds this replica's cache and weights, so
        # unlike the reference's process-wide prefill cache none is shared
        self._fused: Dict[Tuple[int, int], Program] = {}
        self._prefill: Dict[Tuple[int, int], Program] = {}
        self._append: Dict[Tuple[int, int], Program] = {}
        # a vision turn-1 program's static patch-embedding input, by its key
        self._frontend_in: Dict[Tuple, torch.Tensor] = {}
        self._pool = None      # one graph memory pool for all of them
        self._stream = None    # and one capture stream
        self._weights = None   # (name, Parameter), for the address guard
        if warmup:
            self.warmup_decode()
            if not self.exact_prefill and prefill_mode == "jit":
                self.warmup_prefill()

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

    # ----- programs -------------------------------------------------------------
    @property
    def _graphs(self) -> bool:
        return self.cuda_graphs and self.device.type == "cuda"

    def _bound(self):
        """(name, tensor) of every weight and cache leaf a program binds.
        The weights' list is walked once (a moved weight keeps its
        Parameter); the cache tree at every call (a leaf may be rebound)."""
        if self._weights is None:
            self._weights = [(f"weight {n}", p)
                             for n, p in self.params.named_parameters()]
        return self._weights + [(f"cache {'/'.join(path)}", t)
                                for path, t in leaves(self.kv.caches)]

    def _program(self, table: Dict, key, make: Callable[[], Program]
                 ) -> Program:
        """Fetch (or build) the program for one bucket key and, on a CUDA
        replica with graphs, capture it. Building and capturing go to
        `self.compile_s`, never into a measured dt."""
        prog = table.get(key)
        if prog is not None and (prog.graph is not None or not self._graphs):
            return prog
        self._kernels_ready()
        t0 = time.perf_counter()
        if prog is None:
            prog = table[key] = make()
        if self._graphs:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            prog.capture(self._bound(), self._pool, self._stream)
        dt = time.perf_counter() - t0
        self.compile_s += dt
        prog.build_s += dt
        return prog

    def _run(self, prog: Program, host: np.ndarray,
             steps: Optional[int] = None, sp=None) -> torch.Tensor:
        """One run of a program on `host` inputs: one copy in, then the
        graph's replay or the eager body (`steps` calls of it, by default
        the program's). Returns its output buffer; nothing is read back.
        A traced call's span `sp` brackets the replay or the eager run."""
        prog.load(host)
        if sp is not None:
            sp.begin("programs.replay" if self._graphs else "programs.eager")
        if self._graphs:
            prog.replay(self._bound())
        else:
            prog.run_eager(steps)
        if sp is not None:
            sp.end()
        return prog.out

    def programs(self) -> Dict[Tuple, Program]:
        """Every program built so far, keyed ("decode", n_steps, ctx),
        ("prefill", pad_to, n_front) or ("append", pad_to, ctx)."""
        return {**{("decode",) + k: p for k, p in self._fused.items()},
                **{("prefill",) + k: p for k, p in self._prefill.items()},
                **{("append",) + k: p for k, p in self._append.items()}}

    def graph_pool_bytes(self) -> int:
        """Device bytes held by this replica's graph memory pool."""
        return 0 if self._pool is None else pool_bytes(self._pool)

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

    @staticmethod
    def _prefill_host(slot: int, tokens, pad_to: int, prev: int
                      ) -> np.ndarray:
        """A prefill's inputs as one host vector: [slot, true_len, prev,
        the tokens right-padded with 0 to pad_to]."""
        host = np.zeros(3 + pad_to, np.int32)
        host[:3] = slot, len(tokens), prev
        host[3:3 + len(tokens)] = tokens
        return host

    @torch.no_grad()
    def _prefill_body(self, ins: torch.Tensor, tok: torch.Tensor,
                      ctx: Optional[int], fe=None) -> None:
        """A turn-1 prefill (ctx None) or an append against the slot's first
        ctx rows, on device inputs ins = [slot, true_len, prev, tokens] and
        a turn-1's frontend embeddings `fe`: the new K/V (or states) folded
        into the slot at prev by device index, and the greedy token at text
        position true_len - 1 written to tok. Nothing is read back to the
        host."""
        slot, true_len, prev = ins[0:1], ins[1:2], ins[2:3]
        kw = {}
        if ctx is not None:
            kw = dict(caches=gather_slot_prefix(self.kv.caches, slot, ctx),
                      start_pos=prev, kv_lens=prev, prefix_start=0)
        logits, new = self.model.prefill(
            self.params, ins[3:][None], logits_at=true_len - 1,
            frontend_embeds=fe, attention_impl=self.attention_impl, **kw)
        fold_prefill_at(self.kv.caches, new, slot, prev, self.cfg)
        tok.copy_(self._argmax(logits))

    def _make_prefill(self, pad_to: int, ctx: Optional[int],
                      n_front: int = 0) -> Program:
        """Buffers of a (append-)prefill program — a turn-1 program with
        n_front > 0 also holds its static (1, n_front, d_model) frontend
        input — and its warm-up pass: a full prefill into slot 0, whose
        cache is saved before and put back after, so the pass leaves every
        byte as it found it."""
        fe = None
        if n_front:
            fe = torch.zeros((1, n_front, self.cfg.d_model),
                             dtype=self.cfg.torch_dtype, device=self.device)
        prog = Program(("prefill", pad_to, n_front) if ctx is None
                       else ("append", pad_to, ctx), 3 + pad_to,
                       torch.zeros(1, dtype=torch.int32, device=self.device),
                       functools.partial(self._prefill_body, ctx=ctx, fe=fe))
        if fe is not None:
            self._frontend_in[prog.key] = fe
        zero = torch.zeros(1, dtype=torch.int32, device=self.device)
        with uncounted(), side_stream(self.device):
            saved = gather_slot_prefix(self.kv.caches, zero, self.kv.max_ctx)
            prog.load(self._prefill_host(0, np.zeros(pad_to, np.int32),
                                         pad_to, 0))
            prog.run_eager()
            fold_prefill_at(self.kv.caches, saved, zero, zero)  # slot 0, row 0
        return prog

    def _get_prefill(self, pad_to: int, n_front: int = 0) -> Program:
        """Fetch (or build and capture) the turn-1 program of one length
        bucket after n_front frontend positions (the reference's
        `_get_prefill`)."""
        return self._program(self._prefill, (pad_to, n_front),
                             lambda: self._make_prefill(pad_to, None,
                                                        n_front))

    def _get_append(self, pad_to: int, ctx: int) -> Program:
        """Fetch (or build and capture) the append program of one (length
        bucket, prefix ctx bucket) (the reference's `_get_append`)."""
        return self._program(self._append, (pad_to, ctx),
                             lambda: self._make_prefill(pad_to, ctx))

    @property
    def _eager_prefill(self) -> bool:
        """A recurrent model or an encoder-decoder: every prefill eager."""
        return self.exact_prefill or self.cfg.is_encoder_decoder

    def _prefill_program(self, true_len: int, pad_to: int,
                         ctx: Optional[int], n_front: int = 0
                         ) -> Optional[Program]:
        """The program a (append-)prefill runs through, or None where it
        runs eagerly: a recurrent model, an encoder-decoder, or F2's exact
        length (the bucket would not fit the slot)."""
        if self._eager_prefill or pad_to != bucket_len(true_len):
            return None
        return (self._get_prefill(pad_to, n_front) if ctx is None
                else self._get_append(pad_to, ctx))

    def _run_prefill(self, prog: Optional[Program], host: np.ndarray,
                     ctx: Optional[int], fe=None, sp=None) -> int:
        """The token of one (append-)prefill, `fe` a turn-1's frontend
        embeddings: through its program (fe copied into its static input),
        or the same body eagerly. The read of the token is the one host
        sync. `sp` as in `_run`."""
        if prog is not None:
            if fe is not None:
                self._frontend_in[prog.key].copy_(fe)
            return int(self._run(prog, host, sp=sp))
        tok = torch.zeros(1, dtype=torch.int32, device=self.device)
        ins = self._tokens(host)
        if sp is not None:
            sp.begin("programs.eager")
        self._prefill_body(ins, tok, ctx, fe=fe)
        if sp is not None:
            sp.end()
        return int(tok)

    def warmup_prefill(self, lengths=None, ctx_limits=None) -> float:
        """Build the turn-1 and append programs so a cold replica never
        charges a build to its first conversations' TTFT. `lengths`
        defaults to every PREFILL_BUCKET that fits max_ctx; turn-1 programs
        are built per length, append programs per reachable (length, ctx)
        pair, `ctx_limits` defaulting to every power-of-two ctx bucket a
        prefix could occupy (the reference's rule). A vision model's turn-1
        programs take `cfg.frontend_len` patch embeddings, what the server
        sends, and a length whose bucket would not fit beside them is left
        out (such a prefill runs at its exact length, eagerly). A prefix
        pool's hit runs through these append programs, so a pooled replica
        needs none beyond them (the reference also builds its `_get_shared`
        programs here). Returns the seconds spent (also accumulated in
        `self.compile_s`); 0.0 for a recurrent model or an encoder-decoder,
        whose prefills run eagerly."""
        if self._eager_prefill:
            return 0.0
        n_front = (self.cfg.frontend_len if self.cfg.frontend != "none"
                   else 0)
        if lengths is None:
            lengths = [b for b in PREFILL_BUCKETS if b <= self.kv.max_ctx]
        if ctx_limits is None:
            ctx_limits = self._ctx_buckets()
        before = self.compile_s
        for L in dict.fromkeys(bucket_len(int(x)) for x in lengths):
            if L > self.kv.max_ctx:
                continue  # such a prefill pads to its exact length, eagerly
            if n_front + L <= self.kv.max_ctx:
                self._get_prefill(L, n_front)
            for C in dict.fromkeys(ctx_bucket(int(c), self.kv.max_ctx)
                                   for c in ctx_limits):
                # skip (L, C) pairs no live slot could ever reach: the
                # smallest prefix length in ctx bucket C plus the append
                # must still fit the slot
                min_prev = 0 if C <= CTX_BUCKET_MIN else C // 2 + 1
                if min_prev + L <= self.kv.max_ctx:
                    self._get_append(L, C)
        return self.compile_s - before

    def _ctx_buckets(self):
        out = []
        b = CTX_BUCKET_MIN
        while b < self.kv.max_ctx:
            out.append(b)
            b *= 2
        return out + [self.kv.max_ctx]

    def prefill_conversation(self, slot: int, tokens: np.ndarray,
                             frontend_embeds=None, prefix_len: int = 0
                             ) -> Tuple[np.int32, float]:
        """Turn-1 prefill into `slot`. Returns (next_token, measured_s); a
        program's build is charged to `self.compile_s`, never to dt.

        `prefix_len` > 0 declares tokens[:prefix_len] a SHARED PREAMBLE and
        ALWAYS splits the prefill at that boundary — turn-1 class on the
        preamble, append class on the delta — pool or no pool, so per-turn
        token streams are byte-identical pool-on vs pool-off; it does not
        compose with frontend embeddings.

        `frontend_embeds` (1, F, d_model): a vision model's patch
        embeddings, which take the slot's first F rows (its length is then
        F + len(tokens)); an encoder-decoder's frames — exactly
        `cfg.encoder_seq` of them (F16) — which go to the "cross" rows and
        take no slot row (its length is len(tokens), F14)."""
        true_len = len(tokens)
        if prefix_len:
            if not 0 < prefix_len < true_len:
                raise ValueError(
                    f"prefill_conversation: prefix_len {prefix_len} must be "
                    f"in (0, {true_len}) — the turn needs a non-empty delta "
                    f"after the shared preamble")
            if frontend_embeds is not None:
                raise ValueError(
                    "prefill_conversation: shared-prefix split does not "
                    "compose with frontend embeds")
            return self._prefill_split(slot, np.asarray(tokens, np.int32),
                                       int(prefix_len))
        n_front = self._frontend_rows(frontend_embeds)
        self._check_prefill_room(slot, n_front + true_len)
        self._kernels_ready()
        if self.prefill_mode == "reference":
            return self._prefill_reference(slot, tokens, frontend_embeds,
                                           n_front)
        pad_to = self._prefill_pad(true_len, self.kv.max_ctx - n_front)
        prog = self._prefill_program(true_len, pad_to, None,
                                     n_front)  # OFF the clock
        host = self._prefill_host(slot, tokens, pad_to, 0)
        with self.tracer.host("replica.prefill", self.replica_id) as sp:
            t0 = time.perf_counter()
            tok = self._run_prefill(prog, host, None, frontend_embeds, sp)
            self.kv.lengths[slot] = n_front + true_len
            dt = self._account_prefill(t0, true_len)
            if sp is not None:
                sp.close(len=true_len, prev=0)
        return np.int32(tok), dt

    def _frontend_rows(self, fe) -> int:
        """The slot rows a turn-1's frontend embeddings take: a vision
        model's F patches; none for an encoder-decoder, whose frames go to
        the "cross" rows (F14) and must number cfg.encoder_seq (F16: the
        reference's reduced config sends 8 frames to a 16-row cross cache
        and attends to the 8 zero rows); none without a frontend."""
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            got = None if fe is None else fe.shape[1]
            if got != cfg.encoder_seq:
                raise ValueError(
                    f"{cfg.name}: a turn-1 prefill takes encoder_seq = "
                    f"{cfg.encoder_seq} frame embeddings, got {got}")
            return 0
        if cfg.frontend != "none" and fe is not None:
            return int(fe.shape[1])
        return 0

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
        """Pool-hit turn-1, the reference's `_get_shared` program: fold the
        pooled preamble rows into the slot at row 0 — in place, one copy a
        cache leaf — then run the delta against them — zero preamble FLOPs
        — through the append program the miss's own append runs, keyed
        (pad_to, e.ctx), so the two give the same bytes by construction
        (`warmup_prefill` builds it). Where the miss's append runs eagerly
        (`_prefill_program` is None), so does the hit's. The fold is
        enqueued on the current stream, the one a replay launches on. The
        entry stays pinned until the token's read, the one host sync, so no
        eviction frees rows a copy still reads; `get` records the observed
        hit."""
        pool = self.prefix_pool
        e = pool.get(key)
        pool.pin(key)
        try:
            self._kernels_ready()
            if self.prefill_mode == "reference":
                t0 = time.perf_counter()
                fold_prefill(self.kv.caches, e.caches, slot, 0, self.cfg)
                self.kv.lengths[slot] = prefix_len
                fold_dt = self._account_prefill(t0, 0)
                tok, dt = self._append_reference(slot, delta)
                self.n_pooled_prefix_tokens += prefix_len
                return tok, fold_dt + dt
            pad_to = self._prefill_pad(len(delta), self.kv.max_ctx - prefix_len)
            prog = self._prefill_program(len(delta), pad_to,
                                         e.ctx)  # OFF the clock
            host = self._prefill_host(slot, delta, pad_to, prefix_len)
            with self.tracer.host("replica.prefill", self.replica_id) as sp:
                t0 = time.perf_counter()
                fold_prefill(self.kv.caches, e.caches, slot, 0, self.cfg)
                tok = self._run_prefill(prog, host, e.ctx, sp=sp)
                self.kv.lengths[slot] = prefix_len + len(delta)
                dt = self._account_prefill(t0, len(delta))
                if sp is not None:
                    sp.close(len=len(delta), prev=prefix_len, pooled=True)
            self.n_pooled_prefix_tokens += prefix_len
            return np.int32(tok), dt
        finally:
            pool.unpin(key)

    def _prefill_reference(self, slot: int, tokens: np.ndarray,
                           frontend_embeds=None, n_front: int = 0
                           ) -> Tuple[np.int32, float]:
        """REFERENCE PATH: eager forward + `write_prefill` + host-side
        sampling. The parity oracle and benchmark baseline."""
        t0 = time.perf_counter()
        true_len = len(tokens)
        pad_to = self._prefill_pad(true_len, self.kv.max_ctx - n_front)
        logits, caches = self.model.prefill(
            self.params, self._padded(tokens, pad_to),
            logits_at=true_len - 1 if pad_to != true_len else None,
            frontend_embeds=frontend_embeds,
            attention_impl=self.attention_impl)
        self.kv.write_prefill(slot, caches, n_front + true_len)
        tok = self.sample(logits)[0]
        dt = self._account_prefill(t0, true_len)
        return tok, dt

    def append_prefill(self, slot: int, tokens: np.ndarray
                       ) -> Tuple[np.int32, float]:
        """Turn-2+ prefill against the slot's cached prefix (local, prefix
        cache hit — the ConServe fast path). Returns (next_token,
        measured_s); a program's build is charged to `self.compile_s`."""
        true_len = len(tokens)
        self._check_prefill_room(slot, true_len)
        self._kernels_ready()
        if self.prefill_mode == "reference":
            return self._append_reference(slot, tokens)
        prev = int(self.kv.lengths[slot])
        ctx = ctx_bucket(max(prev, 1), self.kv.max_ctx)
        pad_to = self._prefill_pad(true_len, self.kv.max_ctx - prev)
        prog = self._prefill_program(true_len, pad_to, ctx)  # OFF the clock
        host = self._prefill_host(slot, tokens, pad_to, prev)
        with self.tracer.host("replica.append", self.replica_id) as sp:
            t0 = time.perf_counter()
            tok = self._run_prefill(prog, host, ctx, sp=sp)
            self.kv.lengths[slot] = prev + true_len
            dt = self._account_prefill(t0, true_len)
            if sp is not None:
                sp.close(len=true_len, prev=prev)
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
    @torch.no_grad()
    def _decode_step(self, ins: torch.Tensor, seq: torch.Tensor,
                     ctx_limit: int) -> None:
        """One step of the ragged decode chunk on device inputs ins =
        [tokens | lens | emit | remaining] (n_slots each) + [step]. Lane s
        is live while emit[s] and step < remaining[s]; its sampled token is
        fed back, its length advances and its K/V row is folded in, while a
        frozen lane's token, length and cache stay byte-identical. tokens,
        lens and step advance in place; the sampled tokens go to seq[step].
        Nothing is read back to the host."""
        n = self.kv.n_slots
        tokens, lens, emit, rem = ins[:4 * n].view(4, n)
        step = ins[4 * n:]
        logits, updates = self.model.decode_step(
            self.params, tokens, self.kv.caches, lens, kv_lens=lens,
            ctx_limit=ctx_limit, attention_impl=self.attention_impl)
        sampled = self._argmax(logits)
        live = (emit != 0) & (rem > step)
        fold_decode_step(self.kv.caches, updates, lens, live)
        lens.add_(live.to(lens.dtype))
        tokens.copy_(torch.where(live, sampled, tokens))
        seq.index_copy_(0, step.long(), sampled[None])
        step.add_(1)

    def _make_decode(self, n_steps: int, ctx_limit: int) -> Program:
        """Buffers of a decode program, and its warm-up pass: one step with
        every lane frozen (the inputs are all 0), so `fold_decode_step`
        writes each slot's old bytes back and the cache is unchanged."""
        n = self.kv.n_slots
        prog = Program(("decode", n_steps, ctx_limit), 4 * n + 1,
                       torch.zeros((n_steps, n), dtype=torch.int32,
                                   device=self.device),
                       functools.partial(self._decode_step,
                                         ctx_limit=ctx_limit),
                       steps=n_steps)
        with uncounted(), side_stream(self.device):
            prog.run_eager(1)
        return prog

    def _get_fused(self, n_steps: int, ctx_limit: int) -> Program:
        """Fetch (or build and capture) the decode program of one (chunk,
        ctx) bucket (the reference's `_get_fused`). Build time goes to
        `self.compile_s`, never into a measured decode dt."""
        return self._program(self._fused, (n_steps, ctx_limit),
                             lambda: self._make_decode(n_steps, ctx_limit))

    def warmup_decode(self, chunks=None, ctx_limits=None) -> float:
        """Build decode programs so serving never hits a cold (chunk, ctx)
        bucket. Defaults cover every bucket reachable on this replica: all
        DECODE_CHUNKS × all power-of-two ctx buckets up to max_ctx. Returns
        the seconds spent (also accumulated in `self.compile_s`)."""
        if ctx_limits is None:
            ctx_limits = self._ctx_buckets()
        before = self.compile_s
        for c in (chunks if chunks is not None else DECODE_CHUNKS):
            for cl in dict.fromkeys(int(x) for x in ctx_limits):
                self._get_fused(decode_chunk_bucket(int(c)), cl)
        return self.compile_s - before

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

    def decode_steps(self, next_tokens: np.ndarray, emit_mask: np.ndarray,
                     remaining) -> Tuple[np.ndarray, float]:
        """Run one RAGGED decode chunk across ALL slots (inactive slots
        compute in lockstep but are masked out), through the program of
        its (n_steps, ctx_limit) bucket: on a CUDA replica one replay of
        its graph, which runs the bucket's n_steps; eagerly, max(remaining)
        steps. Frozen lanes change nothing, so the two agree byte for byte.

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
        prog = self._get_fused(n_steps, ctx_limit)  # OFF the clock
        host = np.concatenate([np.asarray(next_tokens, np.int32),
                               self.kv.lengths, emit_mask, rem, [0]])
        with self.tracer.host("replica.decode", self.replica_id) as sp:
            t0 = time.perf_counter()
            seq = self._run(prog, host, steps=n_max, sp=sp)
            out = seq[:n_max].cpu().numpy()  # the one host sync per chunk
            self.kv.lengths += np.where(emit_mask, rem, 0).astype(np.int32)
            self._sync()
            dt = time.perf_counter() - t0
            if sp is not None:
                n = self.kv.n_slots
                sp.close(lengths=host[n:2 * n].tolist(),
                         emit=emit_mask.tolist(), rem=rem.tolist())
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
