"""The paper's baselines, overload, the live gateway and the chaos harness on
the port's engine, on weights converted from the JAX package's reduced
qwen3-0.6b with strict accounting on.

Under collocated, full_disagg and AMPD (at a wrong-prediction rate that
makes remote turns happen) the port's per-(cid, turn) streams and each
record's KV transfers and remote turns equal the JAX `EngineServer`'s on
the same trace, with F11 repaired on the JAX replicas' caches: the JAX
package's `import_slot` writes the KV a remote turn returns at the
decoder slot's current length, not at 0, so its remote turns decode from
misplaced rows; the port's `import_slot` installs the package from 0, and
its baselines' streams equal ConServe's. The rest mirrors the reference's engine tests:
tests/test_runtime.py (overload completes, streams do not depend on
admission order, full_disagg's remote-turn accounting),
tests/test_gateway.py (live == offline, also under a replica failure; the
circuit breaker), tests/test_lifecycle.py (overload hints), and a small
engine chaos run held by `check_chaos_invariants`."""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import make_scheduler as jax_make_scheduler  # noqa: E402
from repro.engine import EngineServer as JaxServer  # noqa: E402
from repro.engine import ReplicaEngine as JaxReplica  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.traces import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.traces import generate_trace as jax_generate_trace  # noqa: E402
from repro_torch.chaos import (ChaosSchedule, apply_tool_timeouts,  # noqa: E402
                               arm_schedule, check_chaos_invariants,
                               generate_chaos_schedule, run_chaos)
from repro_torch.chaos.schedule import (FAULT_SLOWDOWN,  # noqa: E402
                                        FAULT_SLOWDOWN_END)
from repro_torch.chaos.triggers import FailWhen  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import make_scheduler  # noqa: E402
from repro_torch.engine import EngineServer, ReplicaEngine  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import (GatewayOverloaded, ServeGateway,  # noqa: E402
                               serve_scenario_live)
from repro_torch.traces import (TraceConfig, generate_trace,  # noqa: E402
                                make_scenario)
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


def _streams(srv):
    return {k: [int(t) for t in v] for k, v in srv.sampled_tokens.items()}


# --------------------------------------------------------------------------- #
# the baselines against the JAX engine
# --------------------------------------------------------------------------- #
BASELINE_TRACE = dict(seed=5, first_input_median=40, first_input_sigma=0.3,
                      first_input_max=60, append_median=10,
                      append_sigma=0.3, append_max=20, output_median=5,
                      output_sigma=0.5, output_max=8, mean_turns=3.0,
                      max_turns=4, tool_mean_s=0.01)
ROLES = {"conserve": ("prefill", "decode", "decode"),
         "collocated": ("mixed", "mixed", "mixed"),
         "full_disagg": ("prefill", "decode", "decode"),
         "ampd": ("prefill", "decode", "decode")}
SCHED_KW = {"collocated": {}, "full_disagg": {},
            "ampd": {"wrong_prediction_rate": 0.5, "seed": 0}}


def _spaced(trace):
    """One conversation at a time: AMPD draws its misprediction per
    `place_turn` call, and the engines' logical clocks are measured, so
    overlapping conversations could call it in a different order on the
    two engines. Spaced arrivals fix the order."""
    for i, c in enumerate(trace):
        c.arrival_s = 100.0 * i
    return trace


def _per_record(recs):
    return {r.cid: (r.n_kv_transfers, r.n_remote_turns) for r in recs}


def _repair_f11(kv):
    """The port's `import_slot` rule on one JAX replica's cache: install
    the package from position 0."""
    def import_slot(slot, package):
        kv.lengths[slot] = 0
        kv.write_prefill(slot, package["caches"], package["length"])
    kv.import_slot = import_slot


def _jax_serve(jax_qwen, system, repair=True, **sched_kw):
    jcfg, jp = jax_qwen
    jreps = [JaxReplica(jcfg, jp, n_slots=4, max_ctx=256, replica_id=i,
                        role=r) for i, r in enumerate(ROLES[system])]
    if repair:
        for r in jreps:
            _repair_f11(r.kv)
    jsrv = JaxServer(jax_make_scheduler(system, **sched_kw), jreps,
                     record_tokens=True, strict_accounting=True)
    jrecs = jsrv.serve(_spaced(jax_generate_trace(
        5, 3.0, cfg=JaxTraceConfig(**BASELINE_TRACE))))
    return jsrv, jrecs


def _serve(qwen, system, **sched_kw):
    cfg, params = qwen
    reps = [ReplicaEngine(cfg, params, n_slots=4, max_ctx=256, replica_id=i,
                          role=r) for i, r in enumerate(ROLES[system])]
    srv = EngineServer(make_scheduler(system, **sched_kw), reps,
                       record_tokens=True, strict_accounting=True)
    recs = srv.serve(_spaced(generate_trace(
        5, 3.0, cfg=TraceConfig(**BASELINE_TRACE))))
    return srv, recs


@pytest.fixture(scope="module")
def conserve_streams(qwen):
    return _streams(_serve(qwen, "conserve")[0])


@pytest.mark.parametrize("system", ["collocated", "full_disagg", "ampd"])
def test_baseline_equals_jax_engine_server(jax_qwen, qwen, conserve_streams,
                                           system):
    jsrv, jrecs = _jax_serve(jax_qwen, system, **SCHED_KW[system])
    srv, recs = _serve(qwen, system, **SCHED_KW[system])

    assert len(recs) == 5 and len(srv.sampled_tokens) > 5
    assert _streams(srv) == _streams(jsrv)
    assert _per_record(recs) == _per_record(jrecs)
    assert srv.n_transfers == jsrv.n_transfers
    # where a turn is prefilled decides when it runs, never what it computes
    assert _streams(srv) == conserve_streams
    remote = sum(r.n_remote_turns for r in recs)
    if system == "collocated":
        assert srv.n_transfers == 0 and remote == 0
    else:
        assert remote > 0
    srv.check_accounting()
    for st in srv.states.values():
        assert st.active_kv_tokens == 0 and st.used_slots == 0


def test_f11_reference_remote_turn_misplaces_the_returned_kv(jax_qwen, qwen,
                                                            conserve_streams):
    """F11 (ROADMAP queue 3): without the repair, the JAX engine's
    full_disagg streams leave ConServe's from the first remote turn on,
    while its turn-1 streams (no remote turn yet) agree; the port's agree
    throughout."""
    jsrv, _ = _jax_serve(jax_qwen, "full_disagg", repair=False)
    jax_streams = _streams(jsrv)
    assert set(jax_streams) == set(conserve_streams)
    later = [k for k in conserve_streams if k[1] >= 1]
    assert later
    assert all(jax_streams[k] == conserve_streams[k]
               for k in conserve_streams if k[1] == 0)
    assert any(jax_streams[k] != conserve_streams[k] for k in later)
    assert _streams(_serve(qwen, "full_disagg")[0]) == conserve_streams


def test_import_slot_replaces_an_occupied_slot(qwen):
    """A package imported into a slot that holds rows lands from position 0
    and sets the slot's length, as into a fresh slot."""
    cfg, params = qwen
    a = ReplicaEngine(cfg, params, n_slots=2, max_ctx=256)
    b = ReplicaEngine(cfg, params, n_slots=2, max_ctx=256)
    rs = np.random.RandomState(0)
    sa, sb = a.kv.acquire(), b.kv.acquire()
    a.prefill_conversation(sa, rs.randint(0, cfg.vocab_size, 40))
    b.prefill_conversation(sb, rs.randint(0, cfg.vocab_size, 30))
    pkg = a.kv.export_slot(sa)
    b.kv.import_slot(sb, pkg)
    assert int(b.kv.lengths[sb]) == 40
    got = b.kv.export_slot(sb)["caches"]
    for sec, tree in pkg["caches"].items():
        for key, node in tree.items():
            for name, leaf in node.items():
                assert torch.equal(got[sec][key][name], leaf)


# --------------------------------------------------------------------------- #
# overload: 2x more concurrent conversations than KV slots
# --------------------------------------------------------------------------- #
OVERLOAD_TRACE = dict(seed=11, first_input_median=30, first_input_sigma=0.3,
                      first_input_max=60, append_median=10,
                      append_sigma=0.3, append_max=20, output_median=6,
                      output_sigma=0.5, output_max=12, mean_turns=2.0,
                      max_turns=3, tool_mean_s=0.0)


def _serve_overload(qwen, n_convs, n_slots, mode="fused"):
    cfg, params = qwen
    rep = ReplicaEngine(cfg, params, n_slots=n_slots, max_ctx=256,
                        replica_id=0, role="mixed")
    srv = EngineServer(make_scheduler("conserve"), [rep], decode_mode=mode,
                       record_tokens=True, strict_accounting=True)
    recs = srv.serve(generate_trace(n_convs, 1e9,
                                    cfg=TraceConfig(**OVERLOAD_TRACE),
                                    arrival_process="saturation"))
    return srv, recs


def test_engine_overload_completes_with_backpressure(qwen):
    n_convs, n_slots = 6, 3
    srv, recs = _serve_overload(qwen, n_convs, n_slots)
    assert len(recs) == n_convs
    assert all(s.done for s in srv.sessions.values())
    assert srv.n_deferred_admissions >= n_convs - n_slots
    waits = srv.queue_waits()
    assert sum(w > 0 for w in waits.values()) >= n_convs - n_slots
    st = srv.states[0]
    assert st.queued_conversations == 0
    assert st.used_slots == 0 and st.active_kv_tokens == 0
    srv.check_accounting()


def test_engine_overload_streams_invariant_across_admission_orderings(qwen):
    tight, _ = _serve_overload(qwen, 6, 3)
    wide, _ = _serve_overload(qwen, 6, 8)
    ref, _ = _serve_overload(qwen, 6, 3, mode="reference")
    assert tight.sampled_tokens == wide.sampled_tokens
    assert tight.sampled_tokens == ref.sampled_tokens
    assert wide.n_deferred_admissions == 0
    assert tight.n_deferred_admissions > 0
    assert ref.n_deferred_admissions > 0
    assert tight.states[0].queued_conversations == 0


def test_engine_remote_turn_accounting_full_disagg(qwen):
    """Remote append-prefill turns keep the mirror exact on both nodes."""
    cfg, params = qwen
    reps = [ReplicaEngine(cfg, params, n_slots=8, max_ctx=512,
                          replica_id=0, role="prefill"),
            ReplicaEngine(cfg, params, n_slots=8, max_ctx=512, replica_id=1)]
    srv = EngineServer(make_scheduler("full_disagg"), reps,
                       strict_accounting=True)
    tc = TraceConfig(seed=6, first_input_median=40, first_input_sigma=0.3,
                     first_input_max=90, append_median=12, append_sigma=0.4,
                     append_max=30, output_median=6, output_sigma=0.5,
                     output_max=12, mean_turns=3.0, max_turns=4,
                     tool_mean_s=0.01)
    recs = srv.serve(generate_trace(5, 5.0, cfg=tc))
    assert len(recs) == 5
    assert any(r.n_remote_turns > 0 for r in recs)
    srv.check_accounting()
    for st in srv.states.values():
        assert st.active_kv_tokens == 0 and st.used_slots == 0


# --------------------------------------------------------------------------- #
# the live gateway
# --------------------------------------------------------------------------- #
def _engine(qwen, n_slots=8, roles=("prefill", "decode", "decode"),
            cls=EngineServer, **kw):
    cfg, params = qwen
    reps = [ReplicaEngine(cfg, params, n_slots=n_slots, max_ctx=1024,
                          replica_id=i, role=r)
            for i, r in enumerate(roles)]
    return cls(make_scheduler("conserve"), reps, record_tokens=True,
               strict_accounting=True, **kw)


def _fleet(seed=2, n=5):
    return make_scenario("shared_preamble_fleet", n, seed=seed,
                         scale="engine")


class _FailWhen(FailWhen, EngineServer):
    """The port's engine with the structural kill trigger, where the
    reference's test kills at a fixed time of its own engine's measured
    clock."""


def test_engine_gateway_streams_byte_identical(qwen):
    off = _engine(qwen)
    off.serve(_fleet())
    offline = {k: list(v) for k, v in off.sampled_tokens.items()}

    live = _engine(qwen)
    recs, gw, client = serve_scenario_live(live, _fleet())
    assert len(recs) == 5
    assert gw.streams == live.sampled_tokens
    assert gw.streams == offline
    assert client.collected == offline
    live.check_accounting()
    h = gw.health()
    assert h["runtime_state"] == "closed" and h["n_done"] == 5
    assert h["n_node_joins"] == 0 and h["n_node_quarantines"] == 0
    for st in h["nodes"].values():
        assert {"kv_headroom_tokens", "queued_conversations",
                "masked_forward_fraction", "lifecycle"} <= set(st)
        assert st["lifecycle"] == "ACTIVE"


def test_engine_gateway_identical_under_replica_failure(qwen):
    off = _engine(qwen)
    off.serve(_fleet())
    offline = {k: list(v) for k, v in off.sampled_tokens.items()}

    victim = next(c for c in _fleet() if c.n_turns >= 2).cid
    live = _engine(qwen, cls=_FailWhen, victim_cid=victim, min_turn=1)
    recs, gw, client = serve_scenario_live(live, _fleet())
    assert len(recs) == 5
    assert any(r.recovered for r in recs), "failure missed every conv"
    assert gw.streams == offline
    assert client.collected == offline
    assert sum(client.rewinds.values()) >= 1
    assert gw.events_seen["node_failure"] == 1
    assert gw.events_seen["recovery"] == live.n_recoveries >= 1
    live.check_accounting()


def _saturating_burst():
    burst = make_scenario("pareto_burst", 8, seed=9, scale="engine")
    for c in burst:
        c.arrival_s = 0.0
    extra = make_scenario("pareto_burst", 4, seed=11, scale="engine",
                          cid_offset=100)
    return burst, extra


def test_circuit_breaker_sheds_without_crashing(qwen):
    srv = _engine(qwen, n_slots=1, roles=("mixed", "mixed"))
    burst, extra = _saturating_burst()

    async def run():
        gw = ServeGateway(srv, shed_watermark=0, max_events_per_tick=8)
        gw.start()
        gw.submit(burst)
        shed = False
        for _ in range(400):
            await asyncio.sleep(0)
            try:
                gw.submit([extra[0]])
                extra.pop(0)
            except GatewayOverloaded as e:
                assert "watermark" in str(e) and "depths" in str(e)
                assert e.min_queue_depth is not None \
                    and e.min_queue_depth >= 1
                assert e.retry_after_s is not None and e.retry_after_s >= 0.0
                shed = True
                break
            if not extra:
                break
        return gw, await gw.drain(), shed

    gw, recs, shed = asyncio.run(run())
    assert shed and gw.n_shed >= 1
    assert len(recs) == gw.n_submitted
    srv.check_accounting()


def test_gateway_overload_reports_observed_hints(qwen):
    """tests/test_lifecycle.py's overload hints: the refusal carries the
    observed queue depth and a finite, non-negative backoff."""
    srv = _engine(qwen, n_slots=1, roles=("mixed", "mixed"))
    burst, extra = _saturating_burst()

    async def run():
        gw = ServeGateway(srv, shed_watermark=0, max_events_per_tick=8)
        gw.start()
        gw.submit(burst)
        err = None
        pending = list(extra)
        for _ in range(2000):
            await asyncio.sleep(0)
            if not pending:
                break
            try:
                gw.submit([pending[0]])
                pending.pop(0)
            except GatewayOverloaded as e:
                err = e
                break
        await gw.drain()
        return err

    err = asyncio.run(run())
    assert err is not None, "the burst never saturated every queue"
    assert err.min_queue_depth is not None and err.min_queue_depth >= 1
    assert err.retry_after_s is not None and 0.0 <= err.retry_after_s < 1e6


# --------------------------------------------------------------------------- #
# one small engine chaos run
# --------------------------------------------------------------------------- #
def test_engine_chaos_run_holds_the_contract(qwen):
    """Kill -> rejoin of a decoder, a transfer fault and a tool timeout on
    one seeded schedule, driven live: every conversation completes, every
    stream equals the fault-free run's, no placement lands on a dead node,
    and each fault left its trace. The schedule's slowdown is dropped: the
    quarantine it would trip depends on measured step times."""
    deadline = 0.12

    def mk(**kw):
        return _engine(qwen, max_decode_chunk=4, rotation_min_chunk=4, **kw)

    full = generate_chaos_schedule(
        20260807, [1, 2], kill_frac_range=(0.03, 0.05),
        rejoin_delay_frac_range=(0.04, 0.07),
        transfer_frac_range=(0.10, 0.30))
    schedule = ChaosSchedule(full.seed, tuple(
        e for e in full.events
        if e.kind not in (FAULT_SLOWDOWN, FAULT_SLOWDOWN_END)))
    first = apply_tool_timeouts(
        make_scenario("pareto_burst", 8, seed=2, scale="engine"),
        schedule, deadline)
    wave = make_scenario("pareto_burst", 3, seed=13, scale="engine",
                         cid_offset=9000)
    everyone = first + wave

    base = mk()
    base_recs = base.serve(everyone)
    span = max(t.last_token_s for r in base_recs for t in r.turns)
    baseline = {k: list(v) for k, v in base.sampled_tokens.items()}

    srv = mk(tool_deadline_s=deadline, tool_timeout_action="evict")
    arm_schedule(srv, schedule, span)
    res = run_chaos(srv, first, schedule, span, second_wave=wave,
                    stagger=len(first))
    ev = check_chaos_invariants(res.records, res.gateway, res.monitor,
                                schedule, everyone, baseline,
                                require_quarantine=False)
    srv.check_accounting()
    assert len(res.records) == len(everyone)
    assert ev["n_failures"] == 1 and ev["n_joins"] >= 1
    assert ev["n_transfer_retries"] >= 1
    assert not res.monitor.violations
