"""The port's spans (`repro_torch.engine.trace`): the server's intervals on
its logical clock, the replica's on the host clock, all published as
``span`` events on the runtime's bus.

On a reduced qwen3-0.6b served under ConServe, AMPD (with remote turns)
and collocated: every turn's child spans tile runnable -> the start of the
chunk that first decodes it, every parent resolves and children share
their turn's conversation; with a decoder killed as a turn stages or
while it waits on a tool, and with failed transfers, each attempt of a
turn tiles its start -> its first chunk's start (or the failure); the
served streams do not depend on whether a ``span`` subscriber listens;
with no subscriber, or only a wildcard one, no span is built and no
profiler range is entered; a call that raises leaves no span context and
no profiler range open; under `torch.profiler` the ``conserve.*`` ranges
nest as the spans do; the host-clock spans of an append and a decode chunk
agree with timers around the calls; a program's `build_s` is what its
build charged to `compile_s`."""
import collections
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.chaos.triggers import FailWhen  # noqa: E402
from repro_torch.core import make_scheduler  # noqa: E402
from repro_torch.core.events import (EV_RECOVERY, EV_SPAN, EV_TOKENS,  # noqa: E402
                                     EventBus, ServeEvent)
from repro_torch.core.runtime import DECODING, TOOL_WAIT  # noqa: E402
from repro_torch.engine import EngineServer, ReplicaEngine  # noqa: E402
from repro_torch.engine import trace as trace_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.traces import TraceConfig, generate_trace  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

TRACE = dict(seed=5, first_input_median=40, first_input_sigma=0.3,
             first_input_max=60, append_median=10, append_sigma=0.3,
             append_max=20, output_median=5, output_sigma=0.5, output_max=8,
             mean_turns=3.0, max_turns=4, tool_mean_s=0.01)
ROLES = {"conserve": ("prefill", "decode", "decode"),
         "ampd": ("prefill", "decode", "decode"),
         "collocated": ("mixed", "mixed", "mixed")}
SCHED_KW = {"ampd": {"wrong_prediction_rate": 0.5, "seed": 0}}
SYSTEMS = sorted(ROLES)
# the spans that tile a turn, and the host-clock spans
TILES = {"server.admission", "server.wait_replica", "server.prefill",
         "server.append", "server.transfer", "server.wait_join"}
CALLS = {"replica.prefill", "replica.append", "replica.decode"}
HOST = CALLS | {"programs.replay", "programs.eager"}


@pytest.fixture(scope="module")
def qwen():
    cfg = get_reduced("qwen3-0.6b")
    return cfg, build_model(cfg).init(0, "cpu")


def _trace(n=6, rate=20.0):
    return generate_trace(n, rate, cfg=TraceConfig(**TRACE))


def _reps(qwen, system, warmup=False, n_slots=4):
    cfg, lm = qwen
    return [ReplicaEngine(cfg, lm, n_slots=n_slots, max_ctx=256,
                          replica_id=i, role=r, warmup=warmup)
            for i, r in enumerate(ROLES[system])]


def _server(qwen, system, warmup=False, n_slots=4):
    return EngineServer(make_scheduler(system, **SCHED_KW.get(system, {})),
                        _reps(qwen, system, warmup, n_slots),
                        record_tokens=True, strict_accounting=True)


class _FailWhen(FailWhen, EngineServer):
    """The port's engine with the structural kill trigger."""


def _serve_traced(srv):
    events = []
    srv.bus.subscribe(events.append, kinds=[EV_SPAN, EV_TOKENS, EV_RECOVERY])
    srv.serve(_trace())
    return [e for e in events if e.kind == EV_SPAN], events


def _names(spans):
    return collections.Counter(e.data["name"] for e in spans)


def _check_tiling(srv, spans, events):
    """Every turn's children tile each of its attempts: attempt 0 from the
    turn's runnable instant, attempt k from its k-th recovery, each to the
    start of the attempt's first chunk, or to the failure that ended it.
    Every parent resolves; a replica's spans share the conversation of the
    call that made them."""
    by_id = {e.data["span_id"]: e for e in spans}
    assert len(by_id) == len(spans), "span ids repeat"
    children = collections.defaultdict(list)
    for e in spans:
        p = e.data["parent"]
        assert p is None or p in by_id, f"{e.data['name']}: parent {p}"
        children[p].append(e)
    # per (cid, turn): the recoveries' instants, and the start of each
    # attempt's first chunk (per_token_s before its first decoded token)
    recovered = collections.defaultdict(list)
    first_chunk = {}
    for e in events:
        key = (e.cid, e.turn_idx)
        if e.kind == EV_RECOVERY:
            recovered[key].append(e.t)
        elif e.kind == EV_TOKENS and e.data["per_token_s"] > 0:
            first_chunk.setdefault(key + (len(recovered[key]),),
                                   e.t - e.data["per_token_s"])
    turns = [e for e in spans if e.data["name"] == "server.turn"]
    n_turns = sum(len(c.turns) for c in srv._convs.values())
    assert len(turns) == n_turns
    convs = {e.cid: e for e in spans
             if e.data["name"] == "server.conversation"}
    assert sorted(convs) == sorted(srv._convs)
    for turn in turns:
        cid, idx = turn.cid, turn.turn_idx
        assert turn.data["parent"] == convs[cid].data["span_id"]
        rec = next(r for r in srv.records[cid].turns if r.turn_idx == idx)
        runnable = srv._convs[cid].arrival_s if idx == 0 else rec.arrival_s
        assert turn.data["t0"] == pytest.approx(runnable, abs=1e-9)
        assert turn.t == pytest.approx(rec.last_token_s, abs=1e-9)
        kids = children[turn.data["span_id"]]
        assert kids and {e.data["name"] for e in kids} <= TILES
        assert all((e.cid, e.turn_idx) == (cid, idx) for e in kids)
        falls = recovered[(cid, idx)]
        attempts = collections.defaultdict(list)
        for e in kids:
            attempts[e.data["attempt"]].append(e)
        assert max(attempts) == len(falls)
        for a, group in attempts.items():
            group.sort(key=lambda e: (e.data["t0"], e.t))
            t = runnable if a == 0 else falls[a - 1]
            for e in group:
                assert e.data["t0"] == pytest.approx(t, abs=1e-9), (
                    f"cid {cid} turn {idx} attempt {a}: {e.data['name']} "
                    f"starts at {e.data['t0']}, the previous child ended "
                    f"at {t}")
                assert e.t >= e.data["t0"] - 1e-12
                t = e.t
            last = group[-1]
            if last.data.get("interrupted"):
                assert last.data["name"] == "server.wait_join"
                assert t == pytest.approx(max(last.data["t0"], falls[a]),
                                          abs=1e-9)
            else:
                assert t == pytest.approx(first_chunk[(cid, idx, a)],
                                          abs=1e-9)
        for e in kids:
            for h in children[e.data["span_id"]]:
                assert (h.cid, h.turn_idx) == (cid, idx)
                assert h.data["name"] in CALLS
                for p in children[h.data["span_id"]]:
                    assert p.data["name"] in HOST - CALLS
                    assert (p.cid, p.turn_idx) == (cid, idx)
    return _names(spans)


@pytest.mark.parametrize("system", SYSTEMS)
def test_turn_children_tile_runnable_to_first_chunk(qwen, system):
    srv = _server(qwen, system)
    spans, events = _serve_traced(srv)
    names = _check_tiling(srv, spans, events)
    assert all(e.data.get("attempt", 0) == 0 for e in spans)
    assert names["server.conversation"] == len(srv._convs)
    # a decode chunk serves several conversations: its span has no parent
    decodes = [e for e in spans if e.data["name"] == "replica.decode"]
    assert decodes and all(e.data["parent"] is None for e in decodes)
    if system != "collocated":
        kinds = collections.Counter(e.data["kind"] for e in spans
                                    if e.data["name"] == "server.admission")
        assert kinds["arrival"] == kinds["bind"] == len(srv._convs)
    if system == "ampd":
        remote = sum(r.n_remote_turns for r in srv.records.values())
        assert remote > 0
        assert names["server.transfer"] == len(srv._convs) + 2 * remote


def _victim(n_turns):
    """The first conversation of `_trace()` with at least `n_turns` turns."""
    return next(c.cid for c in _trace() if len(c.turns) >= n_turns)


@pytest.mark.parametrize("fault", ["kill_staged", "kill_in_tool_wait",
                                   "transfer"])
def test_each_attempt_tiles_under_failures(qwen, fault):
    """A decoder killed 1 ns after a later turn stages (before its first
    chunk), or while the victim waits on a tool (recovered when the tool
    returns), or two failed KV transfers: the streams equal the
    failure-free run's and each attempt of every turn tiles."""
    base = _server(qwen, "conserve")
    base.serve(_trace())
    if fault == "transfer":
        srv = _server(qwen, "conserve").inject_transfer_faults(2)
    else:
        stage = DECODING if fault == "kill_staged" else TOOL_WAIT
        srv = _FailWhen(make_scheduler("conserve"), _reps(qwen, "conserve"),
                        record_tokens=True, strict_accounting=True,
                        victim_cid=_victim(3), min_turn=1, stage=stage)
    spans, events = _serve_traced(srv)
    assert srv.sampled_tokens == base.sampled_tokens
    _check_tiling(srv, spans, events)
    if fault == "transfer":
        failed = [e for e in spans if e.data["name"] == "server.transfer"
                  and e.data.get("failed")]
        assert srv.n_transfer_retries == len(failed) == 2
        return
    assert srv.killed is not None and srv.n_recoveries >= 1
    cid, idx = srv.killed[:2]
    ev = [e for e in spans if (e.cid, e.turn_idx) == (cid, idx)
          and e.data["name"] in TILES]
    assert {e.data["attempt"] for e in ev} == (
        {0, 1} if fault == "kill_staged" else {1})
    kinds = [e.data["kind"] for e in ev
             if e.data["name"] == "server.admission"
             and e.data["attempt"] == 1]
    assert kinds[0] == "recovery"
    cut = [e for e in ev if e.data.get("interrupted")]
    assert len(cut) == (fault == "kill_staged")


@pytest.mark.parametrize("system", SYSTEMS)
def test_streams_do_not_depend_on_a_span_subscriber(qwen, system):
    out = []
    for traced in (False, True):
        srv = _server(qwen, system)
        seen = []
        if traced:
            srv.bus.subscribe(seen.append, kinds=[EV_SPAN])
        recs = srv.serve(_trace())
        assert bool(seen) == traced
        out.append(({k: [int(t) for t in v]
                     for k, v in srv.sampled_tokens.items()},
                    {r.cid: len(r.turns) for r in recs}))
    assert out[0] == out[1]


@pytest.mark.parametrize("subscriber", ["none", "wildcard"])
def test_nothing_is_built_without_a_span_subscriber(qwen, monkeypatch,
                                                    subscriber):
    built = collections.Counter()

    def counting(name, fn):
        def wrapped(*a, **kw):
            built[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in ("publish", "emit", "new_id"):
        monkeypatch.setattr(trace_mod.Tracer, name,
                            counting(name, getattr(trace_mod.Tracer, name)))
    for name in ("OpenSpan", "HostSpan"):
        monkeypatch.setattr(trace_mod, name,
                            counting(name, getattr(trace_mod, name)))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting("record_function",
                                 torch.profiler.record_function))
    srv = _server(qwen, "conserve")
    seen = []
    if subscriber == "wildcard":
        srv.bus.subscribe(seen.append)
    assert not srv.bus.wants(EV_SPAN)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        srv.serve(_trace(n=3))
    assert not built, dict(built)
    assert not [e for e in seen if e.kind == EV_SPAN]
    assert (subscriber == "wildcard") == bool(seen)
    assert not [e for e in prof.events() if e.name.startswith("conserve.")]


def test_span_kind_is_opt_in_by_name():
    bus = EventBus()
    got = {"all": [], "span": []}
    bus.subscribe(got["all"].append)
    assert not bus.wants(EV_SPAN) and bus.wants("tokens")
    bus.publish(ServeEvent(kind=EV_SPAN, t=0.0, data={"name": "x"}))
    bus.publish(ServeEvent(kind="tokens", t=0.0))
    assert [e.kind for e in got["all"]] == ["tokens"]
    bus.subscribe(got["span"].append, kinds=[EV_SPAN])
    assert bus.wants(EV_SPAN)
    bus.publish(ServeEvent(kind=EV_SPAN, t=1.0, data={"name": "y"}))
    assert [e.data["name"] for e in got["span"]] == ["y"]
    assert [e.kind for e in got["all"]] == ["tokens"]
    assert not hasattr(bus, "n_published")


def test_a_raising_call_leaves_no_span_open():
    """A replica call that raises inside its spans restores the tracer's
    context, closes its profiler ranges and publishes nothing."""
    bus = EventBus()
    got = []
    bus.subscribe(got.append, kinds=[EV_SPAN])
    tr = trace_mod.Tracer(bus)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError, match="replay failed"):
            with tr.call("server.append", None, 7, 1, 0):
                with tr.host("replica.append", 0) as sp:
                    sp.begin("programs.replay")
                    raise RuntimeError("replay failed")
        assert tr.ctx == trace_mod.NO_CONTEXT and not got
        with tr.host("replica.decode", 0) as sp:
            sp.close()
    assert [e.data["name"] for e in got] == ["replica.decode"]
    assert got[0].data["parent"] is None and got[0].cid is None
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name.startswith("conserve.")}
    assert set(ranges) == {"conserve.replica.append",
                           "conserve.programs.replay",
                           "conserve.replica.decode"}
    assert (ranges["conserve.programs.replay"].end
            <= ranges["conserve.replica.append"].end
            <= ranges["conserve.replica.decode"].start)


def test_profiler_ranges_nest_as_the_spans_do(qwen):
    srv = _server(qwen, "conserve")
    spans = []
    srv.bus.subscribe(spans.append, kinds=[EV_SPAN])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        srv.serve(_trace(n=3))
    by_id = {e.data["span_id"]: e for e in spans}
    # each host-clock span's parent, among the host-clock spans (None: a
    # server span, which opens no range)
    want = collections.defaultdict(set)
    for e in spans:
        if e.data["name"] in HOST:
            p = by_id.get(e.data["parent"])
            want[e.data["name"]].add(
                p.data["name"] if p is not None and p.data["name"] in HOST
                else None)
    ranges = sorted(((e.name[len("conserve."):], e.time_range.start,
                      e.time_range.end) for e in prof.events()
                     if e.name.startswith("conserve.")),
                    key=lambda r: (r[1], -r[2]))
    assert (collections.Counter(n for n, _, _ in ranges)
            == collections.Counter(e.data["name"] for e in spans
                                   if e.data["name"] in HOST))
    stack = []
    for name, a, b in ranges:
        while stack and stack[-1][2] <= a:
            stack.pop()
        outer = stack[-1][0] if stack else None
        if stack:
            assert b <= stack[-1][2], f"{name} crosses {outer}"
        assert outer in want[name], (name, outer, want[name])
        stack.append((name, a, b))
    assert want["programs.eager"] == CALLS
    assert want["replica.decode"] == {None}


def test_host_spans_agree_with_timers_around_the_calls(qwen):
    """The benchmark's outside timers and the program's spans bracket the
    same calls: on warmed replicas, the mean append and the time a decode
    step agree within 5%."""
    srv = _server(qwen, "conserve", warmup=True)
    outside = collections.defaultdict(list)
    for r in srv.replicas.values():
        for meth, name in (("append_prefill", "append"),
                           ("decode_steps", "decode")):
            def timed(*a, _fn=getattr(r, meth), _name=name, **kw):
                t0 = time.perf_counter_ns()
                out = _fn(*a, **kw)
                outside[_name].append((time.perf_counter_ns() - t0,
                                       int(np.max(a[2])) if _name == "decode"
                                       else 1))
                return out
            setattr(r, meth, timed)
    spans = []
    srv.bus.subscribe(spans.append, kinds=[EV_SPAN])
    srv.serve(_trace(n=8, rate=40.0))
    for name in ("append", "decode"):
        inside = [(e.data["host_t1_ns"] - e.data["host_t0_ns"],
                   max(np.asarray(e.data["rem"])[e.data["emit"]])
                   if name == "decode" else 1)
                  for e in spans if e.data["name"] == f"replica.{name}"]
        assert len(inside) == len(outside[name]) > 0
        per = [sum(ns for ns, _ in x) / sum(k for _, k in x)
               for x in (inside, outside[name])]
        assert per[0] <= per[1]
        assert per[0] == pytest.approx(per[1], rel=0.05), (name, per)


def test_build_seconds_are_what_compile_s_charged(qwen):
    cfg, lm = qwen
    rep = ReplicaEngine(cfg, lm, n_slots=2, max_ctx=256, warmup=True)
    progs = rep.programs()
    assert progs and all(p.build_s > 0 for p in progs.values())
    assert sum(p.build_s for p in progs.values()) == pytest.approx(
        rep.compile_s, rel=1e-12)
    # a cold replica's builds in serving add to both alike
    srv = _server(qwen, "conserve")
    srv.serve(_trace(n=3))
    for r in srv.replicas.values():
        assert r.programs()
        assert sum(p.build_s for p in r.programs().values()) == pytest.approx(
            r.compile_s, rel=1e-12)
