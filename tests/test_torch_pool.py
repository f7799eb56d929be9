"""The prefix pool's hit through the replica's programs (the counterpart of
the reference's `_get_shared`, src/repro/engine/replica.py).

A hit folds the pooled preamble rows into the slot and runs the delta
through the append program that the miss's own append runs, keyed
("append", pad_to, ctx) with ctx the entry's bucket. On the CPU a program
is its body run eagerly on its buffers, so these tests hold what the graph
stands on: which program a hit runs (and which hits stay eager, as in the
reference: F2's exact length, a recurrent model, `prefill_mode=
"reference"`), that a warmed pooled replica builds nothing on its first
hit, that pool on and off give the same tokens and live rows (replica
level) and the same served streams of `shared_preamble_fleet` on four
families, and that the port's pool-on streams equal the JAX engine's, whose
hits run its `_get_shared` programs. The graph's replay of the same
program is the `gpu` case `test_pool_hit_graph_equals_miss` of
tests/test_torch_gpu.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import make_scheduler as jax_make_scheduler  # noqa: E402
from repro.engine import EngineServer as JaxServer  # noqa: E402
from repro.engine import ReplicaEngine as JaxReplica  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.traces import make_scenario as jax_make_scenario  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import make_scheduler  # noqa: E402
from repro_torch.engine import EngineServer, ReplicaEngine  # noqa: E402
from repro_torch.engine.kvcache import growing, leaves  # noqa: E402
from repro_torch.engine.programs import Program  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.traces import make_scenario  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

# the reduced configs; gemma3-12b's local window widened to the served
# max_ctx (F5), deepseek-v2-lite-16b at its reduced cf = E/K (dropless)
ARCHS = {"qwen3-0.6b": {}, "gemma3-12b": {"window": 1024},
         "deepseek-v2-lite-16b": {}, "rwkv6-3b": {}}
PRE = 69  # preamble tokens: ctx bucket 128
DELTAS = (10, 23, 31, 7)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch, over in ARCHS.items():
        cfg = get_reduced(arch).scaled(**over)
        out[arch] = (cfg, build_model(cfg).init(0, "cpu"))
    return out


def _fleet(vocab, deltas=DELTAS):
    """One shared preamble and a delta each (the reference's
    benchmarks/prefix_reuse.py `_fleet`)."""
    rng = np.random.RandomState(7)
    pre = rng.randint(0, vocab, size=PRE).astype(np.int32)
    return [np.concatenate([pre, rng.randint(0, vocab, size=n)
                            .astype(np.int32)]) for n in deltas]


def _live_rows(eng, slot):
    """A slot's live cache: growing leaves' first `length` rows, fixed
    states whole."""
    n = int(eng.kv.lengths[slot])
    return [t[:, :, :n] if growing(path) else t
            for path, t in leaves(eng.kv.export_slot_full(slot))]


class _Spy:
    """The keys of the programs run, in order."""

    def __init__(self, monkeypatch):
        self.keys = []
        run = Program.run_eager

        def spy(prog, steps=None):
            self.keys.append(prog.key)
            return run(prog, steps)
        monkeypatch.setattr(Program, "run_eager", spy)


# --------------------------------------------------------------------------- #
# which program a hit runs
# --------------------------------------------------------------------------- #
HIT_CASES = {
    # (arch, engine kwargs, delta length, the program the hit runs)
    "bucketed": ("qwen3-0.6b", {}, 10, ("append", 32, 128)),
    # F2: the 64 bucket would not fit the 59 rows left; exact length, eager
    "f2-exact-length": ("qwen3-0.6b", {"max_ctx": 128}, 40, None),
    "recurrent": ("rwkv6-3b", {}, 10, None),
    "reference-mode": ("qwen3-0.6b", {"prefill_mode": "reference"}, 10,
                       None),
}


@pytest.mark.parametrize("case", list(HIT_CASES))
def test_pool_hit_runs_the_append_program_of_its_miss(models, monkeypatch,
                                                      case):
    """The miss (turn-1 on the preamble, then the delta's append) and the
    hit run the same append program, ("append", pad_to, the entry's ctx
    bucket); where the miss's append runs eagerly, so does the hit's, and
    it runs no program at all. Both give the same token."""
    arch, kw, n_delta, want = HIT_CASES[case]
    cfg, lm = models[arch]
    eng = ReplicaEngine(cfg, lm, n_slots=4, **{"max_ctx": 256, **kw},
                        prefix_pool_tokens=4 * PRE)
    miss, hit = _fleet(cfg.vocab_size, (n_delta, n_delta))
    spy = _Spy(monkeypatch)
    t_miss, _ = eng.prefill_conversation(eng.kv.acquire(), miss,
                                         prefix_len=PRE)
    miss_keys, spy.keys = spy.keys, []
    prog_keys = set(eng.programs())
    s = eng.kv.acquire()
    t_hit, _ = eng.prefill_conversation(s, hit, prefix_len=PRE)
    assert eng.prefix_pool.total_hits == 1
    assert eng.n_pooled_prefix_tokens == PRE
    assert int(eng.kv.lengths[s]) == PRE + n_delta
    assert spy.keys == ([] if want is None else [want])
    assert set(eng.programs()) == prog_keys  # the hit built nothing
    if want is not None:
        assert want in miss_keys and miss_keys[-1] == want
        assert ("prefill", 128, 0) in miss_keys
    off = ReplicaEngine(cfg, lm, n_slots=4, **{"max_ctx": 256, **kw})
    off.prefill_conversation(off.kv.acquire(), miss, prefix_len=PRE)
    t_off, _ = off.prefill_conversation(off.kv.acquire(), hit,
                                        prefix_len=PRE)
    assert int(t_hit) == int(t_off)
    assert int(t_miss) == int(off.prefill_conversation(
        off.kv.acquire(), miss, prefix_len=PRE)[0])


def test_warmed_pooled_replica_builds_nothing_on_its_first_hit(models):
    """`warmup=True` builds every append program a hit can reach (the
    reference's `warmup_prefill` builds its `_get_shared` programs there):
    the first miss and the first hit charge no compile_s, and leave the
    programs' keys as they were."""
    cfg, lm = models["qwen3-0.6b"]
    eng = ReplicaEngine(cfg, lm, n_slots=4, max_ctx=256, warmup=True,
                        prefix_pool_tokens=4 * PRE)
    keys, compile_s = set(eng.programs()), eng.compile_s
    assert ("append", 32, 128) in keys and compile_s > 0
    for toks in _fleet(cfg.vocab_size, (10, 23)):
        eng.prefill_conversation(eng.kv.acquire(), toks, prefix_len=PRE)
    assert eng.prefix_pool.total_hits == 1
    assert eng.compile_s == compile_s
    assert set(eng.programs()) == keys


# --------------------------------------------------------------------------- #
# pool on against pool off
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", list(ARCHS))
def test_pool_hits_equal_misses_tokens_and_live_rows(models, arch):
    """Four conversations sharing one preamble, each kept in its slot:
    with the pool (one miss, three hits) and without it the tokens are
    equal and every live cache row — K/V, MLA's latent rows, RWKV6's fixed
    states — byte-identical."""
    cfg, lm = models[arch]
    engs = {p: ReplicaEngine(cfg, lm, n_slots=4, max_ctx=256,
                             prefix_pool_tokens=p) for p in (0, 4 * PRE)}
    toks = {p: [int(e.prefill_conversation(e.kv.acquire(), c,
                                           prefix_len=PRE)[0])
                for c in _fleet(cfg.vocab_size)]
            for p, e in engs.items()}
    off, on = engs[0], engs[4 * PRE]
    assert on.prefix_pool.total_hits == 3
    assert toks[0] == toks[4 * PRE]
    np.testing.assert_array_equal(off.kv.lengths, on.kv.lengths)
    for s in range(4):
        assert all(torch.equal(a, b) for a, b in
                   zip(_live_rows(off, s), _live_rows(on, s)))


def _serve(cfg, lm, pool, n=8):
    reps = [ReplicaEngine(cfg, lm, n_slots=8, max_ctx=1024, replica_id=i,
                          role=r, prefix_pool_tokens=pool)
            for i, r in enumerate(("prefill", "decode", "decode"))]
    srv = EngineServer(make_scheduler("conserve"), reps, record_tokens=True,
                       strict_accounting=True)
    recs = srv.serve(make_scenario("shared_preamble_fleet", n, seed=0,
                                   scale="engine"))
    assert len(recs) == n
    srv.check_accounting()
    return srv


def _streams(srv):
    return {k: [int(t) for t in v] for k, v in srv.sampled_tokens.items()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_served_fleet_streams_equal_pool_on_and_off(models, arch):
    """`shared_preamble_fleet` at engine scale, 1 prefiller + 2 decoders
    under ConServe: every (cid, turn) stream is the same with the pool on
    every replica and with none, and the prefiller's pool was hit."""
    cfg, lm = models[arch]
    off = _serve(cfg, lm, 0)
    on = _serve(cfg, lm, 1024)
    assert on.states[0].pooled_prefix_hits > 0
    assert on.replicas[0].n_pooled_prefix_tokens > 0
    assert _streams(on) == _streams(off)


def test_served_pool_on_streams_equal_jax_engine():
    """Converted reduced qwen3-0.6b weights, the pool on every replica: the
    port's served streams equal the JAX `EngineServer`'s, whose pool hits
    run its jitted `_get_shared` programs; both prefillers are hit."""
    jcfg = jax_reduced("qwen3-0.6b")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_reduced("qwen3-0.6b")
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           "cpu")
    n = 5
    jreps = [JaxReplica(jcfg, jp, n_slots=8, max_ctx=1024, replica_id=i,
                        role=r, prefix_pool_tokens=1024)
             for i, r in enumerate(("prefill", "decode", "decode"))]
    jsrv = JaxServer(jax_make_scheduler("conserve"), jreps,
                     record_tokens=True, strict_accounting=True)
    assert len(jsrv.serve(jax_make_scenario(
        "shared_preamble_fleet", n, seed=0, scale="engine"))) == n
    srv = _serve(cfg, lm, 1024, n=n)
    assert jsrv.states[0].pooled_prefix_hits > 0
    assert srv.states[0].pooled_prefix_hits > 0
    assert _streams(srv) == _streams(jsrv)
