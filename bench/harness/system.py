"""The system under test, built from a configuration's file and a traffic
mix: the port's `EngineServer` under the mix's scheduler over one
`ReplicaEngine` per role of the deployment, all on one card and sharing
the weights the benchmark made. This module and `drive` are the only ones
that import the program, and they use its public surface only."""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

import torch

from . import traffic


def model_config(m: Dict, kv_cache_dtype: str = ""):
    """The port's `ModelConfig` from a configuration file's "model" block."""
    from repro_torch.models.config import ModelConfig
    kw = dict(m)
    kw["block_pattern"] = tuple(kw["block_pattern"])
    kw["kv_cache_dtype"] = kv_cache_dtype
    return ModelConfig(**kw)


def hand_over(cfg, weights: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """The program's model module with the benchmark's weights as its
    parameters (the same storage, nothing copied). Built on the meta
    device, so no second copy is ever allocated; refuses a module whose
    parameters are not exactly the benchmark's names and shapes."""
    from repro_torch.models import build_model
    lm = build_model(cfg).module(torch.device("meta"))
    want = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    have = {n: tuple(t.shape) for n, t in weights.items()}
    if want != have:
        raise ValueError(
            f"the program's parameters differ from the benchmark's: "
            f"missing {sorted(set(want) - set(have))[:5]}, extra "
            f"{sorted(set(have) - set(want))[:5]}, shapes "
            f"{[n for n in want if n in have and want[n] != have[n]][:5]}")
    for name, t in weights.items():
        mod_name, _, leaf = name.rpartition(".")
        setattr(lm.get_submodule(mod_name), leaf,
                torch.nn.Parameter(t, requires_grad=False))
    if any(b.is_meta for b in lm.buffers()):
        raise ValueError("the program's module keeps a buffer the "
                         "benchmark does not make")
    return lm


def build(conf: Dict, mix: Dict, lm, seed: int):
    """(server, replicas) for one run."""
    reps = replicas(conf, mix, lm)
    return server(conf, mix, reps, seed), reps


def replicas(conf: Dict, mix: Dict, lm) -> List:
    """One `ReplicaEngine` per role of the deployment, on `lm`."""
    from repro_torch.engine import ReplicaEngine
    cfg = model_config(conf["model"], mix["serving"]["kv_cache_dtype"])
    dep, eng = conf["deployment"], conf["engine"]
    return [ReplicaEngine(cfg, lm, n_slots=dep["n_slots"][role],
                          max_ctx=dep["max_ctx"], replica_id=i, role=role,
                          attention_impl=eng["attention_impl"],
                          cuda_graphs=eng["cuda_graphs"],
                          prefix_pool_tokens=mix["serving"][
                              "prefix_pool_tokens"])
            for i, role in enumerate(dep["roles"])]


def server(conf: Dict, mix: Dict, reps, seed: int):
    """The `EngineServer` over `reps` under the mix's scheduler, with the
    configuration's modeled constants passed explicitly."""
    from repro_torch.core import make_scheduler
    from repro_torch.engine import EngineServer
    eng = conf["engine"]
    return EngineServer(make_scheduler(mix["serving"]["scheduler"]), reps,
                        link_bw_bytes_s=eng["link_bw_bytes_s"], seed=seed,
                        max_decode_chunk=eng["max_decode_chunk"],
                        rotation=eng["rotation"],
                        rotation_min_chunk=eng["rotation_min_chunk"],
                        strict_accounting=eng["strict_accounting"])


def to_program(shapes: Sequence[traffic.Shape]) -> List:
    """The program's `Conversation`s for the benchmark's shapes."""
    from repro_torch.core.conversation import Conversation, Turn
    return [Conversation(cid=s.cid, arrival_s=s.arrival_s,
                         turns=[Turn(a, o, t) for a, o, t in s.turns],
                         preamble_id=s.preamble_id,
                         preamble_tokens=s.preamble_tokens)
            for s in shapes]


def warm_keys(shapes: Sequence[traffic.Shape], max_ctx: int,
              until_s: float = float("inf")) -> Dict:
    """The program keys the traffic reaches before the logical clock
    reaches `until_s`, from its shapes and with the program's own bucket
    functions: the turn-1 length of each conversation that arrives by
    then; each append's (length bucket, prefix ctx bucket) where its padded
    write fits the slot (else it runs eagerly, at its exact length) and
    the turn can start by then (its conversation's arrival plus the tool
    calls before it: the decode time between is left out, so the bound is
    early); every decode chunk at every ctx bucket from the shortest such
    first turn's to max_ctx."""
    from repro_torch.engine.replica import (DECODE_CHUNKS, bucket_len,
                                            ctx_bucket)
    shapes = [s for s in shapes if s.arrival_s < until_s]
    first = {bucket_len(s.turns[0][0]) for s in shapes}
    first = {L for L in first if L <= max_ctx}
    appends = set()
    for s in shapes:
        start = s.arrival_s
        for i in range(1, len(s.turns)):
            start += s.turns[i - 1][2]
            prev, L = s.context_after(i - 1), bucket_len(s.turns[i][0])
            if start < until_s and prev + L <= max_ctx:
                appends.add((L, ctx_bucket(max(prev, 1), max_ctx)))
    lo = ctx_bucket(min(s.turns[0][0] for s in shapes) + 1, max_ctx)
    ctx = sorted({ctx_bucket(c, max_ctx) for c in range(lo, max_ctx + 1, lo)}
                 | {max_ctx})
    return {"prefill": sorted(first, reverse=True),
            "append": sorted(appends, reverse=True),
            "decode": [(c, x) for c in sorted(DECODE_CHUNKS, reverse=True)
                       for x in sorted(ctx, reverse=True)]}


def warm(reps, shapes: Sequence[traffic.Shape], max_ctx: int,
         until_s: float = float("inf")) -> List:
    """Build (and capture) every program the traffic reaches, before it
    arrives: turn-1 programs on the prefiller, append and decode programs
    on the decoders, for what can happen before the logical clock reaches
    `until_s` (`warm_keys`); what comes later, in the drain, may still
    build there, off the logical clock and after the window. Largest first, one key at a time with the allocator's
    cache emptied before each: a replica's programs share one graph pool,
    which the largest sizes and the smaller ones then reuse, and a capture
    cannot take the blocks that eager warm-up passes left cached. Returns
    each key's seconds as (seconds, replica, kind, key)."""
    return warm_programs(reps, warm_keys(shapes, max_ctx, until_s))


def warm_programs(reps, keys: Dict) -> List:
    """`warm` for given keys (`warm_keys`' form, or a union of several)."""
    cuda = bool(reps) and reps[0].device.type == "cuda"
    took = []          # (seconds, replica, kind, key)
    for r in reps:
        todo = []
        if r.role in ("prefill", "mixed"):
            todo += [("prefill", L, lambda L=L: r.warmup_prefill(
                lengths=[L], ctx_limits=[])) for L in keys["prefill"]]
        if r.role in ("decode", "mixed"):
            todo += [("append", (L, C), lambda L=L, C=C: r.warmup_prefill(
                lengths=[L], ctx_limits=[C])) for L, C in keys["append"]]
            todo += [("decode", (c, x), lambda c=c, x=x: r.warmup_decode(
                chunks=[c], ctx_limits=[x])) for c, x in keys["decode"]]
        for kind, key, build in todo:
            if cuda:
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            build()
            took.append((time.perf_counter() - t0, r.replica_id, kind, key))
    if cuda:
        torch.cuda.empty_cache()
    return took
