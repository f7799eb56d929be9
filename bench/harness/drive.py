"""One run's phases over the system under test, and what the benchmark
records around them.

* `Client` is the benchmark as the clients: it receives every token the
  server streams (the event bus's "tokens" events), so the served tokens and
  their times are read as a client reads them, not from the program's
  records.
* `Feeder` offers the open-loop arrivals: each conversation is submitted
  at its arrival time on the server's logical clock (`call_at`), one after
  the other, until the feeder is closed.
* `Spans` (with --trace 1 only) wraps the replicas' calls — turn-1
  prefill, append, decode chunk, the slot export and import — in host-clock
  spans and profiler ranges of the benchmark's own.
* `serve` runs the set-up fill, the measured window and the drain. The
  window is an interval of the server's logical clock, so the
  conversations it measures are the same whatever the program's speed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import traffic

SPANNED = {"prefill": "prefill_conversation", "append": "append_prefill",
           "decode": "decode_steps"}


class Client:
    def __init__(self, srv):
        # (cid, turn) -> [(t, tokens, per_token_s)], in arrival order
        self.events: Dict[tuple, list] = {}
        self.counting = False
        self.counted = 0
        self.n_rewinds = 0
        srv.bus.subscribe(self._tokens, kinds=["tokens"])
        srv.bus.subscribe(self._rewind, kinds=["recovery"])

    def _tokens(self, ev):
        toks = list(ev.data["tokens"])
        self.events.setdefault((ev.cid, ev.turn_idx), []).append(
            (ev.t, toks, ev.data["per_token_s"]))
        if self.counting:
            self.counted += len(toks)

    def _rewind(self, ev):
        self.n_rewinds += 1
        self.events.pop((ev.cid, ev.turn_idx), None)

    def stream(self, cid: int, turn: int) -> List[int]:
        return [t for _, toks, _ in self.events.get((cid, turn), [])
                for t in toks]

    def finished(self, s: traffic.Shape) -> bool:
        last = len(s.turns) - 1
        return len(self.stream(s.cid, last)) >= s.turns[last][1] + 1

    def timeline(self, s: traffic.Shape) -> Dict:
        """The conversation as its client saw it, on the logical clock:
        each turn runnable (arrival, or the previous turn's last token plus
        its tool time), its first decoded token (the opening token is the
        prefill's) and its last token."""
        turns, runnable = [], s.arrival_s
        for i, (_, out, tool) in enumerate(s.turns):
            evs = self.events[(s.cid, i)]
            t_last, toks, per = evs[-1]
            last = t_last + (len(toks) - 1) * per
            turns.append({"arrival_s": runnable, "first_token_s": evs[1][0],
                          "last_token_s": last, "n_output_tokens": out})
            runnable = last + tool
        return {"arrival_s": s.arrival_s, "turns": turns}


class Feeder:
    def __init__(self, srv, convs):
        self.srv, self.convs = srv, convs
        self.i = 0
        self.open = True
        self._arm()

    def _arm(self):
        if self.i < len(self.convs):
            self.srv.call_at(self.convs[self.i].arrival_s, self._fire)

    def _fire(self):
        if not self.open:
            return
        self.srv.submit([self.convs[self.i]])
        self.i += 1
        self._arm()


@dataclasses.dataclass
class Span:
    name: str
    replica: int
    t0: float
    t1: float = 0.0
    dt: float = 0.0            # what the replica charged to its clock
    profiled: bool = False
    info: Dict = dataclasses.field(default_factory=dict)


class Spans:
    """The benchmark's spans around the replicas' calls. Each call's own
    arguments give what the counts need (a prefill's length, a chunk's live
    lengths and steps)."""

    def __init__(self, reps):
        self.spans: List[Span] = []
        self.recording = False
        self.profiling = False
        self.n_profiled: Dict[str, int] = {}   # profiled calls, by name
        self.on_prefill = None      # hook: called before a turn-1 prefill
        for r in reps:
            for name, meth in SPANNED.items():
                setattr(r, meth, self._wrap(r, name, getattr(r, meth)))
            for name in ("export_slot", "import_slot"):
                setattr(r.kv, name, self._wrap(r, name, getattr(r.kv, name)))

    def _wrap(self, rep, name, fn):
        def call(*args, **kw):
            if name == "prefill" and self.on_prefill is not None:
                self.on_prefill()
            if not self.recording:
                return fn(*args, **kw)
            sp = Span(name, rep.replica_id, 0.0, profiled=self.profiling)
            if name == "prefill":
                sp.info["len"] = len(args[1])
            elif name == "append":
                sp.info["len"] = len(args[1])
                sp.info["prev"] = int(rep.kv.lengths[args[0]])
            elif name == "decode":
                sp.info["lengths"] = rep.kv.lengths.copy()
                sp.info["emit"] = np.asarray(args[1], bool).copy()
                sp.info["rem"] = np.broadcast_to(
                    np.asarray(args[2]), sp.info["emit"].shape).copy()
            with torch.profiler.record_function(f"bench.{name}"):
                sp.t0 = time.perf_counter()
                out = fn(*args, **kw)
                sp.t1 = time.perf_counter()
            if name in SPANNED:
                sp.dt = float(out[1])
            self.spans.append(sp)
            if sp.profiled:
                self.n_profiled[name] = self.n_profiled.get(name, 0) + 1
            return out
        return call


@dataclasses.dataclass
class Window:
    setup_end: float = 0.0       # perf_counter at the window's start
    wall_s: float = 0.0          # wall seconds the logical window took
    logical: tuple = (0.0, 0.0)
    shapes: List[traffic.Shape] = dataclasses.field(default_factory=list)
    tokens: int = 0
    compute_s: float = 0.0       # what the replicas charged in the window
    captures: int = 0
    compile_s: float = 0.0
    transfer_bytes: float = 0.0
    n_transfers: int = 0
    profile_s: float = 0.0       # the profiled sub-window's wall
    drain_s: float = 0.0
    occupancy: Dict = dataclasses.field(default_factory=dict)
    unfinished: List[int] = dataclasses.field(default_factory=list)


def _counters(srv, reps):
    return (sum(r.compute_s for r in reps),
            sum(len(r.programs()) for r in reps),
            sum(r.compile_s for r in reps),
            float(srv.transfer_bytes), int(srv.n_transfers))


def _occupancy(srv) -> Dict:
    """Slots in use and admissions parked, per node, from the server's
    observables."""
    return {nid: [st.used_slots, st.queued_conversations]
            for nid, st in srv.states.items()}


def serve(srv, reps, shapes: List[traffic.Shape], fill_s: float,
          seconds: float, drain_until: float, client: Client,
          spans: Optional[Spans] = None, profiler=None,
          profile_after_s: float = 10.0, profile_s: float = 1.5,
          drain: bool = True, profile_max_s: float = 3.5,
          profile_decodes: int = 3) -> Window:
    """Fill (set-up) until the logical clock reaches fill_s; the window is
    the logical interval [fill_s, fill_s + seconds], with arrivals
    continuing; then stop the arrivals and (with `drain`) serve until the
    conversations that arrived in the window finish, or the wall clock
    reaches `drain_until`, which also ends a window that runs past it.

    The profiled sub-window starts at the first turn-1 prefill
    `profile_after_s` (wall) into the window. It lasts `profile_s`, and
    longer, up to `profile_max_s`, until it holds `profile_decodes` whole
    decode calls: a run of appends can fill a short one, and the decode
    readers would then find nothing, or one chunk, to read."""
    from . import system
    feeder = Feeder(srv, system.to_program(shapes))
    marks = []
    srv.call_at(fill_s, lambda: marks.append("start"))
    srv.call_at(fill_s + seconds, lambda: marks.append("end"))
    while not marks:
        if srv.run_pending(max_events=1) == 0:
            raise RuntimeError("the traffic ended before the fill did")
    w = Window()
    w.occupancy["start"] = _occupancy(srv)
    c0 = _counters(srv, reps)
    i0, t_l0 = feeder.i, srv.now_s
    prof_t0 = [None]
    if spans is not None:
        spans.recording = True
        if profiler is not None:
            def start_profile():
                if (prof_t0[0] is None and client.counting
                        and time.perf_counter() - w.setup_end
                        >= profile_after_s):
                    profiler.start()
                    spans.profiling = True
                    prof_t0[0] = time.perf_counter()
            spans.on_prefill = start_profile
    client.counting = True
    w.setup_end = t0 = time.perf_counter()
    while len(marks) < 2 and time.perf_counter() < drain_until:
        if srv.run_pending(max_events=1) == 0:
            raise RuntimeError("the traffic ended inside the window")
        if (prof_t0[0] is not None and spans.profiling
                and time.perf_counter() - prof_t0[0] >= profile_s
                and (spans.n_profiled.get("decode", 0) >= profile_decodes
                     or time.perf_counter() - prof_t0[0] >= profile_max_s)):
            w.profile_s = time.perf_counter() - prof_t0[0]
            profiler.stop()
            spans.profiling = False
    w.wall_s = time.perf_counter() - t0
    client.counting = False
    if spans is not None:
        if spans.profiling:
            w.profile_s = time.perf_counter() - prof_t0[0]
            profiler.stop()
            spans.profiling = False
        spans.recording = False
        spans.on_prefill = None
    feeder.open = False
    w.occupancy["end"] = _occupancy(srv)
    c1 = _counters(srv, reps)
    w.logical = (t_l0, srv.now_s)
    w.tokens = client.counted
    w.compute_s, w.captures, w.compile_s, w.transfer_bytes, w.n_transfers = (
        b - a for a, b in zip(c0, c1))
    by_cid = {s.cid: s for s in shapes}
    w.shapes = [by_cid[c.cid] for c in feeder.convs[i0:feeder.i]]
    t_d = time.perf_counter()
    waiting = [s for s in w.shapes if not client.finished(s)]
    while drain and waiting and time.perf_counter() < drain_until:
        if srv.run_pending(max_events=1) == 0:
            break
        if not client.finished(waiting[0]):
            continue
        waiting = [s for s in waiting if not client.finished(s)]
    w.drain_s = time.perf_counter() - t_d
    w.unfinished = [s.cid for s in waiting]
    return w
