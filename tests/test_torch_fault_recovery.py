"""The failure and lifecycle contract on the port's engine
(`repro_torch.engine.EngineServer`), mirroring tests/test_fault_recovery.py
and the engine half of tests/test_lifecycle.py on weights converted from
the JAX package's reduced qwen3-0.6b, with strict accounting on.

The bar is the reference's: every recovered per-(cid, turn) token stream
equals the failure-free run's byte for byte, whether a decoder dies
mid-turn, at a seeded time, while its prefix pool holds rows, or while a
conversation waits on a tool; a failed replica rejoins cold; and the loud
failure modes (no healthy decoder, a double failure, an exhausted transfer
budget, a tool past its deadline under "fail") raise.

The recovery bookkeeping is held against the JAX `EngineServer` itself:
with both engines on `FixedStepClock` (every measured step a fixed
logical cost) they place, kill and recover at the same logical moments,
so the streams, each record's recoveries, transfers and recovery
latencies, each replica's replayed prefill tokens and lifecycle, and the
whole `summarize` dict must be equal, for a mid-turn death, a death during
a tool wait, a seeded schedule, pool invalidation, a cold rejoin and a
seeded kill-rejoin-slowdown schedule."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import make_scheduler as jax_make_scheduler  # noqa: E402
from repro.core.conversation import Conversation as JaxConversation  # noqa: E402
from repro.core.conversation import Turn as JaxTurn  # noqa: E402
from repro.core.metrics import summarize as jax_summarize  # noqa: E402
from repro.engine import EngineServer as JaxServer  # noqa: E402
from repro.engine import ReplicaEngine as JaxReplica  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.chaos.triggers import FailWhen, FixedStepClock  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import make_scheduler  # noqa: E402
from repro_torch.core.conversation import Conversation, Turn  # noqa: E402
from repro_torch.core.metrics import summarize  # noqa: E402
from repro_torch.core.runtime import TOOL_WAIT  # noqa: E402
from repro_torch.core.signals import NODE_ACTIVE  # noqa: E402
from repro_torch.engine import EngineServer, ReplicaEngine  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def jax_qwen():
    cfg = jax_reduced("qwen3-0.6b")
    return cfg, jax_build(cfg).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def qwen(jax_qwen):
    cfg = get_reduced("qwen3-0.6b")
    return cfg, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_qwen[1]), cfg, "cpu")


def _trace(n=4, conv=Conversation, turn=Turn):
    return [conv(cid=i, arrival_s=i * 1e-6, turns=[
        turn(append_tokens=24 + 4 * i, output_tokens=10, tool_time_s=0.05),
        turn(append_tokens=10 + 2 * i, output_tokens=8, tool_time_s=0.0),
    ]) for i in range(n)]


def _reps(cfg, params, replica=ReplicaEngine):
    return [replica(cfg, params, n_slots=6, max_ctx=256,
                    replica_id=0, role="prefill"),
            replica(cfg, params, n_slots=3, max_ctx=256,
                    replica_id=1, role="decode"),
            replica(cfg, params, n_slots=3, max_ctx=256,
                    replica_id=2, role="decode")]


def _disagg(cfg, params, **kw):
    return EngineServer(make_scheduler("conserve"), _reps(cfg, params),
                        record_tokens=True, strict_accounting=True, **kw)


@pytest.fixture(scope="module")
def baseline(qwen):
    """Failure-free disaggregated run: the byte-identity reference."""
    srv = _disagg(*qwen)
    recs = srv.serve(_trace())
    assert len(recs) == 4 and not any(r.recovered for r in recs)
    span = max(t.last_token_s for r in recs for t in r.turns)
    return srv.sampled_tokens, span


class _FailWhen(FailWhen, EngineServer):
    """The port's engine with the structural kill trigger."""


def _fail_when(qwen, **kw):
    return _FailWhen(make_scheduler("conserve"), _reps(*qwen),
                     record_tokens=True, strict_accounting=True, **kw)


# --------------------------------------------------------------------------- #
# decoder death with a guaranteed victim
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("victim_turn", [0, 1])
def test_decoder_death_mid_turn_replays_byte_identical(qwen, baseline,
                                                       victim_turn):
    tokens, _ = baseline
    srv = _fail_when(qwen, victim_cid=1, min_turn=victim_turn)
    recs = srv.serve(_trace())
    assert len(recs) == 4
    assert srv.n_recoveries >= 1
    assert srv.records[1].recovered
    assert srv.sampled_tokens == tokens
    assert srv.records[1].recovery_latency_s
    assert all(l > 0 for r in recs for l in r.recovery_latency_s)
    assert sum(s.replayed_prefill_tokens
               for s in srv.states.values() if s.alive) > 0
    dead = next(s for s in srv.states.values() if not s.alive)
    assert dead.active_kv_tokens == 0 and dead.used_slots == 0
    srv.check_accounting()


def test_death_during_tool_wait_recovers_lazily(qwen, baseline):
    tokens, _ = baseline
    srv = _fail_when(qwen, victim_cid=2, min_turn=1, stage=TOOL_WAIT)
    recs = srv.serve(_trace())
    assert len(recs) == 4
    assert srv.records[2].recovered
    assert srv.sampled_tokens == tokens
    assert srv.records[2].recovery_latency_s
    srv.check_accounting()


def test_failure_free_run_records_no_recovery(qwen):
    srv = _disagg(*qwen)
    s = summarize(srv.serve(_trace()))
    assert s["n_recovered"] == 0 and s["n_tool_evictions"] == 0
    assert s["recovery_latency_mean_s"] == 0.0
    assert all(st.replayed_prefill_tokens == 0 for st in srv.states.values())


# --------------------------------------------------------------------------- #
# seeded failure schedules: the reference's draws
# --------------------------------------------------------------------------- #
_RNG = np.random.RandomState(20260807)
_SCHEDULES = [(int(_RNG.randint(1, 3)), float(_RNG.uniform(0.02, 0.98)))
              for _ in range(4)]


@pytest.mark.parametrize("victim,frac", _SCHEDULES,
                         ids=[f"n{v}@{f:.2f}" for v, f in _SCHEDULES])
def test_seeded_failure_schedule_is_byte_identical(qwen, baseline, victim,
                                                   frac):
    tokens, span = baseline
    srv = _disagg(*qwen)
    srv.fail_replica(victim, frac * span)
    recs = srv.serve(_trace())
    assert len(recs) == 4
    assert all(s.done for s in srv.sessions.values())
    assert srv.sampled_tokens == tokens
    srv.check_accounting()


def test_mixed_node_death_with_parked_arrivals(qwen):
    cfg, params = qwen

    def mixed_pair():
        return [ReplicaEngine(cfg, params, n_slots=2, max_ctx=256,
                              replica_id=i, role="mixed") for i in (0, 1)]

    trace = _trace(6)
    base = EngineServer(make_scheduler("conserve"), mixed_pair(),
                        record_tokens=True, strict_accounting=True)
    assert len(base.serve(trace)) == 6
    srv = _FailWhen(make_scheduler("conserve"), mixed_pair(),
                    victim_cid=0, min_turn=0, record_tokens=True,
                    strict_accounting=True)
    assert len(srv.serve(trace)) == 6
    assert srv.sampled_tokens == base.sampled_tokens
    assert srv.n_recoveries >= 1
    srv.check_accounting()


# --------------------------------------------------------------------------- #
# prefix pool: pooled rows die with the node's slot cache
# --------------------------------------------------------------------------- #
_PREAMBLE = 24


def _pooled_pair(cfg, params, replica=ReplicaEngine):
    return [replica(cfg, params, n_slots=3, max_ctx=256, replica_id=i,
                    role="mixed", prefix_pool_tokens=4 * _PREAMBLE)
            for i in (0, 1)]


def _preamble_trace(n=5, conv=Conversation, turn=Turn):
    return [conv(cid=i, arrival_s=0.3 * i, turns=[
        turn(append_tokens=_PREAMBLE + 12 + 2 * i, output_tokens=6,
             tool_time_s=0.05),
        turn(append_tokens=8, output_tokens=5, tool_time_s=0.0)],
        preamble_id=0, preamble_tokens=_PREAMBLE) for i in range(n)]


@pytest.fixture(scope="module")
def pooled_baseline(qwen):
    srv = EngineServer(make_scheduler("conserve"), _pooled_pair(*qwen),
                       record_tokens=True, strict_accounting=True)
    recs = srv.serve(_preamble_trace())
    assert len(recs) == 5
    assert sum(s.pooled_prefix_hits for s in srv.states.values()) > 0
    span = max(t.last_token_s for r in recs for t in r.turns)
    return srv.sampled_tokens, span


_POOL_RNG = np.random.RandomState(7_2026)
_POOL_SCHEDULES = [(int(_POOL_RNG.randint(0, 2)),
                    float(_POOL_RNG.uniform(0.05, 0.95)))
                   for _ in range(3)]


@pytest.mark.parametrize("victim,frac", _POOL_SCHEDULES,
                         ids=[f"n{v}@{f:.2f}" for v, f in _POOL_SCHEDULES])
def test_seeded_failure_invalidates_pool_and_replays_identical(
        qwen, pooled_baseline, victim, frac):
    tokens, span = pooled_baseline
    srv = EngineServer(make_scheduler("conserve"), _pooled_pair(*qwen),
                       record_tokens=True, strict_accounting=True)
    srv.fail_replica(victim, frac * span)
    recs = srv.serve(_preamble_trace())
    assert len(recs) == 5
    assert all(s.done for s in srv.sessions.values())
    assert srv.sampled_tokens == tokens
    dead = srv.states[victim]
    assert not dead.alive
    assert dead.pooled_prefix_tokens == 0 and dead.pooled_prefix_entries == 0
    assert srv.replicas[victim].prefix_pool.n_entries == 0
    assert srv.states[1 - victim].pooled_prefix_entries >= 1
    srv.check_accounting()


# --------------------------------------------------------------------------- #
# loud failure modes
# --------------------------------------------------------------------------- #
def test_no_healthy_decoder_raises(qwen):
    cfg, params = qwen
    reps = [ReplicaEngine(cfg, params, n_slots=4, max_ctx=256,
                          replica_id=0, role="prefill"),
            ReplicaEngine(cfg, params, n_slots=2, max_ctx=256,
                          replica_id=1, role="decode")]
    srv = EngineServer(make_scheduler("conserve"), reps)
    srv.fail_replica(1, 0.0)
    with pytest.raises(RuntimeError, match="no healthy decoder"):
        srv.serve(_trace(2))


def test_double_failure_of_same_replica_raises(qwen):
    srv = _disagg(*qwen)
    srv.fail_replica(1, 0.0).fail_replica(1, 1e-6)
    with pytest.raises(RuntimeError, match="failed twice"):
        srv.serve(_trace(2))


# --------------------------------------------------------------------------- #
# tool-deadline watchdog
# --------------------------------------------------------------------------- #
def test_tool_watchdog_evicts_and_replays_byte_identical(qwen):
    cfg, params = qwen
    trace = [Conversation(cid=0, arrival_s=0.0, turns=[
                 Turn(append_tokens=24, output_tokens=8, tool_time_s=5.0),
                 Turn(append_tokens=10, output_tokens=6, tool_time_s=0.0)]),
             Conversation(cid=1, arrival_s=1e-6, turns=[
                 Turn(append_tokens=20, output_tokens=8, tool_time_s=0.0)])]

    def one_slot(**kw):
        rep = ReplicaEngine(cfg, params, n_slots=1, max_ctx=256,
                            replica_id=0, role="mixed")
        return EngineServer(make_scheduler("conserve"), [rep],
                            record_tokens=True, strict_accounting=True, **kw)

    base = one_slot()
    assert len(base.serve(trace)) == 2
    srv = one_slot(tool_deadline_s=0.5, tool_timeout_action="evict")
    recs = srv.serve(trace)
    assert len(recs) == 2
    assert srv.n_tool_evictions == 1
    assert srv.records[0].n_tool_evictions == 1
    assert srv.records[0].recovered
    assert srv.sampled_tokens == base.sampled_tokens
    assert srv.sessions[1].queue_wait_s < 5.0
    s = summarize(recs)
    assert s["n_tool_evictions"] == 1 and s["n_recovered"] == 1
    srv.check_accounting()


def test_tool_watchdog_fail_action_raises(qwen):
    trace = [Conversation(cid=0, arrival_s=0.0, turns=[
        Turn(append_tokens=24, output_tokens=8, tool_time_s=5.0),
        Turn(append_tokens=10, output_tokens=6, tool_time_s=0.0)])]
    srv = _disagg(*qwen, tool_deadline_s=0.5, tool_timeout_action="fail")
    with pytest.raises(RuntimeError, match="exceeded the tool deadline"):
        srv.serve(trace)


# --------------------------------------------------------------------------- #
# injectable KV-transfer faults with bounded retry
# --------------------------------------------------------------------------- #
def test_transfer_fault_retries_to_success(qwen, baseline):
    tokens, _ = baseline
    srv = _disagg(*qwen)
    srv.inject_transfer_faults(1)
    recs = srv.serve(_trace())
    assert len(recs) == 4
    assert srv.n_transfer_retries == 1
    assert srv.sampled_tokens == tokens
    assert any("KV transfer" in line and "FAILED" in line
               for line in srv.log)
    srv.check_accounting()


def test_transfer_fault_budget_exhaustion_raises(qwen):
    srv = _disagg(*qwen, max_transfer_retries=2)
    srv.inject_transfer_faults(10)
    with pytest.raises(RuntimeError, match="consecutive attempts"):
        srv.serve(_trace(2))


# --------------------------------------------------------------------------- #
# lifecycle: a failed replica rejoins cold and serves again
# --------------------------------------------------------------------------- #
def test_engine_rejoin_is_cold_and_byte_identical(qwen, baseline):
    tokens, span = baseline
    srv = _disagg(*qwen)
    srv.fail_replica(1, 0.25 * span)
    srv.recover_replica(1, 0.55 * span)
    at_rejoin = {}
    orig = srv._rejoin_node

    def spy(node_id, t, reason):
        st = srv.states[node_id]
        at_rejoin.update(node_id=node_id, reason=reason, alive=st.alive,
                         lifecycle=st.lifecycle, kv=st.active_kv_tokens,
                         slots=st.used_slots, convs=st.active_conversations,
                         ema=st.observed_tbt_ema_s)
        return orig(node_id, t, reason=reason)

    srv._rejoin_node = spy
    assert len(srv.serve(_trace())) == 4
    assert srv.sampled_tokens == tokens
    assert at_rejoin == dict(node_id=1, reason="from_dead", alive=True,
                             lifecycle=NODE_ACTIVE, kv=0, slots=0, convs=0,
                             ema=0.0)
    st = srv.states[1]
    assert st.alive and st.lifecycle == NODE_ACTIVE
    assert any(n.node_id == 1 for n in srv.view.nodes())
    srv.check_accounting()


def test_engine_fail_recover_fail_cycle(qwen, baseline):
    tokens, span = baseline
    srv = _disagg(*qwen)
    srv.fail_replica(1, 0.2 * span).recover_replica(1, 0.4 * span)
    srv.fail_replica(1, 0.6 * span).recover_replica(1, 0.8 * span)
    assert len(srv.serve(_trace())) == 4
    assert srv.sampled_tokens == tokens
    assert srv.states[1].alive
    srv.check_accounting()


def test_engine_recover_alive_replica_raises(qwen):
    srv = _disagg(*qwen)
    srv.recover_replica(1, 0.0)
    with pytest.raises(RuntimeError, match="already alive"):
        srv.serve(_trace(2))


_LC_RNG = np.random.RandomState(20260808)
_LC_SCHEDULES = [(int(_LC_RNG.randint(1, 3)),
                  float(_LC_RNG.uniform(0.05, 0.5)),
                  float(_LC_RNG.uniform(0.05, 0.2)),
                  bool(_LC_RNG.randint(0, 2)))
                 for _ in range(4)]


@pytest.mark.parametrize(
    "victim,frac,rejoin_delta,slow", _LC_SCHEDULES,
    ids=[f"n{v}@{f:.2f}+{d:.2f}{'slow' if s else ''}"
         for v, f, d, s in _LC_SCHEDULES])
def test_seeded_lifecycle_schedule_is_byte_identical(qwen, baseline, victim,
                                                     frac, rejoin_delta,
                                                     slow):
    """Kill -> rejoin, with a slowdown on the other decoder after the
    rejoin on half the draws: completion, byte-identity, and the victim
    ACTIVE at the end."""
    tokens, span = baseline
    srv = _disagg(*qwen, quarantine_k=3.0, quarantine_window=2)
    t_kill = frac * span
    t_rejoin = t_kill + rejoin_delta * span
    srv.fail_replica(victim, t_kill).recover_replica(victim, t_rejoin)
    if slow:
        other = 3 - victim
        srv.inject_slowdown(other, 8.0, at_s=t_rejoin + 0.05 * span)
        srv.inject_slowdown(other, 1.0, at_s=t_rejoin + 0.35 * span)
    assert len(srv.serve(_trace())) == 4
    assert all(s.done for s in srv.sessions.values())
    assert srv.sampled_tokens == tokens
    st = srv.states[victim]
    assert st.alive and st.lifecycle == NODE_ACTIVE
    srv.check_accounting()


# --------------------------------------------------------------------------- #
# the recovery bookkeeping against the JAX engine, on a fixed step clock
# --------------------------------------------------------------------------- #
class _PortClocked(FailWhen, FixedStepClock, EngineServer):
    pass


class _JaxClocked(FailWhen, FixedStepClock, JaxServer):
    pass


_PORT = dict(server=_PortClocked, replica=ReplicaEngine,
             scheduler=make_scheduler, conv=Conversation, turn=Turn,
             summarize=summarize)
_JAX = dict(server=_JaxClocked, replica=JaxReplica,
            scheduler=jax_make_scheduler, conv=JaxConversation,
            turn=JaxTurn, summarize=jax_summarize)
_NEVER = dict(min_turn=10 ** 9)  # the trigger disarmed: a timed schedule
_LC_SLOW = next(s for s in _LC_SCHEDULES if s[3])

# name -> (pooled, trigger kwargs, server kwargs, timed faults as
# (kind, node, fraction of the clocked failure-free span))
_CASES = {
    "mid_turn": (False, dict(victim_cid=1, min_turn=1), {}, []),
    "tool_wait": (False, dict(victim_cid=2, min_turn=1, stage=TOOL_WAIT),
                  {}, []),
    "seeded": (False, _NEVER, {}, [("fail", *_SCHEDULES[0])]),
    # on the fixed clock every pooled conversation lands on node 0: the
    # draw that kills it
    "pool": (True, _NEVER, {}, [("fail", *_POOL_SCHEDULES[1])]),
    "cold_rejoin": (False, dict(victim_node=1, min_turn=1,
                                rejoin_after_s=0.05), {}, []),
    "lifecycle_slow": (
        False, _NEVER, dict(quarantine_k=3.0, quarantine_window=2),
        [("fail", _LC_SLOW[0], _LC_SLOW[1]),
         ("recover", _LC_SLOW[0], _LC_SLOW[1] + _LC_SLOW[2]),
         ("slow", 3 - _LC_SLOW[0], _LC_SLOW[1] + _LC_SLOW[2] + 0.05),
         ("unslow", 3 - _LC_SLOW[0], _LC_SLOW[1] + _LC_SLOW[2] + 0.35)]),
}


def _clocked(side, model, case, span=None):
    """Serve `case` on one engine ("port" or "jax") on the fixed step
    clock; `span` (the clocked failure-free run's last token time) places
    the timed faults."""
    pooled, trigger, server_kw, faults = _CASES[case]
    cfg, params = model
    reps = (_pooled_pair if pooled else _reps)(cfg, params, side["replica"])
    srv = side["server"](side["scheduler"]("conserve"), reps,
                         record_tokens=True, strict_accounting=True,
                         **trigger, **server_kw)
    for kind, node, frac in faults:
        if kind == "fail":
            srv.fail_replica(node, frac * span)
        elif kind == "recover":
            srv.recover_replica(node, frac * span)
        else:
            srv.inject_slowdown(node, 8.0 if kind == "slow" else 1.0,
                                at_s=frac * span)
    trace = (_preamble_trace if pooled else _trace)(
        conv=side["conv"], turn=side["turn"])
    recs = srv.serve(trace)
    srv.check_accounting()
    return srv, recs


def _bookkeeping(side, srv, recs):
    return dict(
        streams={k: [int(t) for t in v]
                 for k, v in srv.sampled_tokens.items()},
        records={r.cid: (r.recovered, r.n_kv_transfers, r.n_remote_turns,
                         r.n_tool_evictions, list(r.recovery_latency_s))
                 for r in recs},
        nodes={i: (s.alive, s.lifecycle, s.replayed_prefill_tokens,
                   s.pooled_prefix_entries)
               for i, s in srv.states.items()},
        n_recoveries=srv.n_recoveries, killed=srv.killed,
        at_rejoin=srv.at_rejoin, summary=side["summarize"](recs))


@pytest.fixture(scope="module")
def clocked_spans(qwen):
    """The port's clocked failure-free runs: their streams (the contract's
    reference) and spans, plain and pooled."""
    out = {}
    for pooled in (False, True):
        _CASES["_free"] = (pooled, _NEVER, {}, [])
        srv, recs = _clocked(_PORT, qwen, "_free")
        out[pooled] = ({k: [int(t) for t in v]
                        for k, v in srv.sampled_tokens.items()},
                       max(t.last_token_s for r in recs for t in r.turns))
    del _CASES["_free"]
    return out


@pytest.mark.parametrize("case", list(_CASES))
def test_recovery_bookkeeping_equals_jax_engine(qwen, jax_qwen,
                                                clocked_spans, case):
    """The port's recovery against the JAX engine's on the same trace,
    the same trigger and the same logical clock: equal streams (each equal
    to the failure-free run's), equal per-record recoveries, transfers and
    recovery latencies, equal per-replica replayed prefill tokens and
    lifecycles, and equal summaries."""
    tokens, span = clocked_spans[_CASES[case][0]]
    port = _bookkeeping(_PORT, *_clocked(_PORT, qwen, case, span))
    ref = _bookkeeping(_JAX, *_clocked(_JAX, jax_qwen, case, span))
    assert port["streams"] == tokens
    assert port["n_recoveries"] >= 1
    assert sum(n[2] for n in port["nodes"].values()) > 0
    if case == "pool":
        victim = _POOL_SCHEDULES[1][0]
        assert port["nodes"][victim][3] == 0
        assert port["nodes"][1 - victim][3] >= 1
    if case == "cold_rejoin":
        assert port["at_rejoin"] == dict(
            node_id=1, reason="from_dead", alive=True,
            lifecycle=NODE_ACTIVE, kv=0, slots=0, convs=0, ema=0.0)
    for key in port:
        assert port[key] == ref[key], key
