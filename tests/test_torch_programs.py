"""The replica's compiled programs (`repro_torch.engine.programs`): one per
bucket key for the decode chunk, turn-1 prefill and the append, built
lazily or by `warmup_decode` / `warmup_prefill` / `warmup=True`.

On the CPU nothing is captured: building a program allocates its buffers
and runs its warm-up pass, and every run is the same body, eagerly. So the
CPU checks what the graphs stand on: the mirrors of the reference's
warm-up and compile-time tests (tests/test_decode_fused.py,
tests/test_prefill_jit.py), build time kept out of every measured dt, the
warm-up passes leaving the cache byte-identical, a graph's n_steps giving
what an eager run's max(remaining) gives, the device-indexed fold and
prefix gather byte-identical to the slicing forms on the `groups`/`rem`
trees of all three families, no host read inside any body, and the warmed
replica's streams equal to the JAX engine's. The capture, the replay and
its launch counts are the `gpu` cases of tests/test_torch_gpu.py."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.engine import ReplicaEngine as JaxReplica  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.engine import ReplicaEngine  # noqa: E402
from repro_torch.engine.kvcache import (fold_prefill,  # noqa: E402
                                        fold_prefill_at, gather_slot_prefix,
                                        leaves, map_leaves, slice_slot_prefix)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from torch_support import NoHostRead, one_thread  # noqa: E402,F401

FAMILIES = ("qwen3-0.6b", "rwkv6-3b", "recurrentgemma-9b")


@pytest.fixture(scope="module")
def models():
    """Seeded reduced weights of the three families, on the CPU."""
    out = {}
    for arch in FAMILIES:
        cfg = get_reduced(arch)
        out[arch] = (cfg, build_model(cfg).init(0, "cpu"))
    return out


def _engine(models, arch="qwen3-0.6b", **kw):
    cfg, lm = models[arch]
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_ctx", 128)
    return ReplicaEngine(cfg, lm, **kw)


def _snapshot(eng):
    return [t.clone() for _, t in leaves(eng.kv.caches)]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _filled(models, arch, n_slots=4, max_ctx=64):
    """An engine with three live slots of different lengths."""
    eng = _engine(models, arch, n_slots=n_slots, max_ctx=max_ctx)
    nt = np.zeros(n_slots, np.int32)
    em = np.zeros(n_slots, bool)
    for i, n in enumerate((23, 9, 40)):
        s = eng.kv.acquire()
        t, _ = eng.prefill_conversation(s, np.arange(5 + i, 5 + i + n,
                                                     dtype=np.int32))
        nt[s], em[s] = int(t), True
    return eng, nt, em


# --------------------------------------------------------------------------- #
# mirrors of the reference's warm-up and compile-time tests
# --------------------------------------------------------------------------- #
def test_warmup_precompiles_and_separates_compile_time(models):
    """tests/test_decode_fused.py:183 — warmup_decode pre-builds (chunk,
    ctx) buckets; build time lands in compile_s and never in the measured
    decode dt."""
    eng = _engine(models)
    spent = eng.warmup_decode(chunks=(1, 4), ctx_limits=(64,))
    assert spent > 0
    assert (1, 64) in eng._fused and (4, 64) in eng._fused
    assert eng.compile_s == pytest.approx(spent)

    s0 = eng.kv.acquire()
    t0, _ = eng.prefill_conversation(s0, np.arange(7, 30, dtype=np.int32))
    nt = np.zeros(4, np.int32)
    em = np.zeros(4, bool)
    nt[s0], em[s0] = int(t0), True
    before = eng.compile_s
    _, dt = eng.decode_steps(nt, em, 4)  # hits the pre-warmed (4, 64) bucket
    assert eng.compile_s == before  # no build charged on a warm bucket
    # a cold bucket builds into compile_s, and the reported dt stays in the
    # same regime as the warm call (the build is NOT in dt)
    _, dt_cold = eng.decode_steps(nt, em, 2)
    assert eng.compile_s > before
    assert (2, 64) in eng._fused
    assert dt_cold < 100 * max(dt, 1e-4)


def test_prefill_compile_time_off_the_clock(models):
    """tests/test_prefill_jit.py:118 — a cold bucket's build lands in
    compile_s and never in the measured dt (the two are disjoint parts of
    the call); a warm bucket charges no build at all."""
    eng = _engine(models, n_slots=2, max_ctx=256)
    s = eng.kv.acquire()
    assert eng.compile_s == 0.0
    t0 = time.perf_counter()
    _, dt_cold = eng.prefill_conversation(s, np.arange(3, 40, dtype=np.int32))
    wall = time.perf_counter() - t0
    spent = eng.compile_s
    assert spent > 0                      # bucket 64 built...
    assert dt_cold + spent <= wall        # ...but never inside measured dt
    assert set(eng._prefill) == {(64, 0)}  # (pad_to, n_front)
    eng.kv.release(s)
    s = eng.kv.acquire()
    before = eng.compile_s
    _, dt_warm = eng.prefill_conversation(s, np.arange(9, 50, dtype=np.int32))
    assert eng.compile_s == before        # same bucket: no build charged
    assert dt_warm < 100 * max(dt_cold, 1e-4)


def test_warmup_prefill_precompiles(models):
    """tests/test_prefill_jit.py:140 — warmup_prefill pre-builds the named
    (length[, ctx]) buckets so a cold replica's first conversations hit
    warm programs."""
    eng = _engine(models, n_slots=2, max_ctx=128)
    spent = eng.warmup_prefill(lengths=(32, 64), ctx_limits=(64,))
    assert spent > 0
    assert eng.compile_s == pytest.approx(spent)
    assert set(eng._prefill) == {(32, 0), (64, 0)}
    assert set(eng._append) == {(32, 64), (64, 64)}
    s = eng.kv.acquire()
    before = eng.compile_s
    eng.prefill_conversation(s, np.arange(4, 30, dtype=np.int32))  # 32-bucket
    eng.append_prefill(s, np.arange(50, 80, dtype=np.int32))  # (32, 64)
    assert eng.compile_s == before  # both hit pre-warmed programs
    # The reference shares prefill programs process-wide, so its second
    # replica compiles nothing. A CUDA graph binds the addresses of its own
    # replica's cache and weights, so the port's programs are per replica:
    # a second replica builds its own.
    eng2 = _engine(models, n_slots=2, max_ctx=128)
    assert eng2.warmup_prefill(lengths=(32, 64), ctx_limits=(64,)) > 0
    assert set(eng2._prefill) == {(32, 0), (64, 0)}


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_exact_prefill_families_build_no_prefill_program(models, arch):
    """tests/test_prefill_jit.py:220 — recurrent families keep the
    exact-length eager prefill: warmup_prefill builds nothing and returns
    0.0, a prefill is not bucketed and charges no build."""
    eng = _engine(models, arch, n_slots=2, max_ctx=64)
    assert eng.warmup_prefill() == 0.0
    s = eng.kv.acquire()
    eng.prefill_conversation(s, np.arange(5, 26, dtype=np.int32))
    eng.append_prefill(s, np.arange(40, 47, dtype=np.int32))
    assert int(eng.kv.lengths[s]) == 28  # exact, unbucketed
    assert eng.compile_s == 0.0          # nothing built
    assert not eng._prefill and not eng._append


@pytest.mark.parametrize("arch", FAMILIES)
def test_constructor_warmup_builds_every_reachable_program(models, arch):
    """warmup=True builds every (chunk, ctx) decode bucket and, for the
    padding family, every turn-1 length and reachable (length, ctx) pair
    (the reference's rule: the smallest prefix in ctx bucket C plus the
    append must fit the slot)."""
    eng = _engine(models, arch, n_slots=2, max_ctx=64, warmup=True)
    assert set(eng._fused) == {(c, 64) for c in (1, 2, 4, 8, 16, 32)}
    if arch == "qwen3-0.6b":
        assert set(eng._prefill) == {(32, 0), (64, 0)}
        assert set(eng._append) == {(32, 64), (64, 64)}
    else:
        assert not eng._prefill and not eng._append
    assert eng.compile_s > 0
    assert set(eng.programs()) == (
        {("decode",) + k for k in eng._fused}
        | {("prefill",) + k for k in eng._prefill}
        | {("append",) + k for k in eng._append})


# --------------------------------------------------------------------------- #
# building a program leaves the cache as it found it
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", FAMILIES)
def test_warmup_passes_leave_the_cache_byte_identical(models, arch):
    """A program's warm-up pass executes (on CUDA it precedes the capture):
    the decode pass freezes every lane, the prefill pass saves and restores
    the slot it writes. Live slots keep every byte."""
    eng, _, _ = _filled(models, arch)
    before = _snapshot(eng)
    eng.warmup_decode(chunks=(1, 8), ctx_limits=(64,))
    eng.warmup_prefill(lengths=(32,), ctx_limits=(64,))
    assert _same(before, _snapshot(eng))


@pytest.mark.parametrize("arch", FAMILIES)
def test_bucket_steps_equal_live_steps(models, arch):
    """A graph runs its bucket's n_steps; an eager run stops at
    max(remaining). Frozen lanes change nothing, so both leave the same
    tokens and caches."""
    eng, nt, em = _filled(models, arch)
    rem = np.where(em, [5, 3, 2, 0], 0).astype(np.int32)
    prog = eng._get_fused(8, 64)
    host = np.concatenate([nt, eng.kv.lengths, em, rem, [0]])
    start = _snapshot(eng)
    out = {}
    for steps in (5, 8):
        for t, s in zip(leaves(eng.kv.caches), start):
            t[1].copy_(s)
        prog.load(host)
        prog.run_eager(steps)
        out[steps] = (prog.out[:5].clone(), _snapshot(eng))
    assert torch.equal(out[5][0], out[8][0])
    assert _same(out[5][1], out[8][1])


# --------------------------------------------------------------------------- #
# the device-indexed fold and prefix gather
# --------------------------------------------------------------------------- #
def _random_tree(tree, seed):
    rs = np.random.RandomState(seed)

    def fill(_, t):
        x = torch.from_numpy(rs.standard_normal(t.shape).astype(np.float32))
        return x.to(t.dtype)
    return map_leaves(fill, tree)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("slot,offset,S", [(0, 0, 32), (2, 17, 7),
                                           (3, 0, 64), (1, 60, 4)])
def test_device_indexed_fold_and_gather_equal_slicing(models, arch, slot,
                                                      offset, S):
    """`fold_prefill_at` writes the bytes `fold_prefill` writes, and
    `gather_slot_prefix` reads the bytes `slice_slot_prefix` reads, on the
    `groups`/`rem` trees of every family (recurrentgemma-9b at 5 layers:
    one repetition of its pattern under "groups", two RG-LRU layers under
    "rem")."""
    cfg, _ = models[arch]
    if arch == "recurrentgemma-9b":
        cfg = cfg.scaled(n_layers=5)
    model = build_model(cfg)
    caches = _random_tree(model.init_cache(4, 64, device="cpu"), 1)
    new = _random_tree(model.init_cache(1, S, device="cpu"), 2)
    assert ("rem" in caches) == (arch == "recurrentgemma-9b")
    by_slice = map_leaves(lambda _, t: t.clone(), caches)
    by_index = map_leaves(lambda _, t: t.clone(), caches)
    fold_prefill(by_slice, new, slot, offset)
    fold_prefill_at(by_index, new, torch.tensor([slot], dtype=torch.int32),
                    torch.tensor([offset], dtype=torch.int32))
    for (p, a), (_, b) in zip(leaves(by_slice), leaves(by_index)):
        assert torch.equal(a, b), p
    for ctx in (16, 64):
        view = slice_slot_prefix(by_slice, slot, ctx)
        got = gather_slot_prefix(by_slice, torch.tensor([slot]), ctx)
        for (p, a), (_, b) in zip(leaves(view), leaves(got)):
            assert a.shape == b.shape and torch.equal(a, b), p


# --------------------------------------------------------------------------- #
# no host read inside a body
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", FAMILIES)
def test_program_bodies_read_nothing_back(models, arch):
    """The decode body of every family, and qwen's turn-1 and append
    bodies, run with the host reading nothing (the ops a CUDA graph cannot
    capture raise)."""
    eng, nt, em = _filled(models, arch)
    rem = np.where(em, 4, 0).astype(np.int32)
    runs = [(eng._get_fused(4, 64),
             np.concatenate([nt, eng.kv.lengths, em, rem, [0]]))]
    if arch == "qwen3-0.6b":
        free = eng.kv.acquire()
        toks = np.arange(3, 30, dtype=np.int32)
        runs += [(eng._get_prefill(32), eng._prefill_host(free, toks, 32, 0)),
                 (eng._get_append(32, 64),
                  eng._prefill_host(0, toks, 32, int(eng.kv.lengths[0])))]
    for prog, host in runs:
        prog.load(host)
        with NoHostRead():
            prog.run_eager()
    # the mode does see host reads
    with pytest.raises(AssertionError, match="host read"):
        with NoHostRead():
            int(eng._fused[(4, 64)].out[0, 0])


# --------------------------------------------------------------------------- #
# the slice as a whole: the warmed replica against the JAX engine
# --------------------------------------------------------------------------- #
def test_warmed_replica_streams_equal_jax_engine():
    """Converted reduced qwen3-0.6b weights: two conversations — turn-1
    prefills, a ragged decode chunk, an append joining between chunks, a
    second chunk — through the port's warmed programs and through the JAX
    `ReplicaEngine`'s AOT programs give the same greedy tokens."""
    jcfg = jax_reduced("qwen3-0.6b")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_reduced("qwen3-0.6b")
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           "cpu")

    def roll(eng):
        s0, s1 = eng.kv.acquire(), eng.kv.acquire()
        t0, _ = eng.prefill_conversation(s0, np.arange(11, 48,
                                                       dtype=np.int32))
        t1, _ = eng.prefill_conversation(s1, np.arange(100, 111,
                                                       dtype=np.int32))
        nt = np.zeros(3, np.int32)
        em = np.zeros(3, bool)
        nt[s0], nt[s1], em[s0], em[s1] = int(t0), int(t1), True, True
        rem = np.where(em, [5, 3, 0], 0).astype(np.int32)
        seq, _ = eng.decode_steps(nt, em, rem)
        out = [int(t0), int(t1)] + [int(x) for x in seq[:5, s0]] \
            + [int(x) for x in seq[:3, s1]]
        t2, _ = eng.append_prefill(s1, np.arange(60, 75, dtype=np.int32))
        nt[s0], nt[s1] = int(seq[4, s0]), int(t2)
        seq, _ = eng.decode_steps(nt, em, 4)
        return out + [int(t2)] + [int(x) for x in seq[:, [s0, s1]].ravel()]

    port = ReplicaEngine(cfg, lm, n_slots=3, max_ctx=128)
    port.warmup_decode(chunks=(4, 8), ctx_limits=(64, 128))
    port.warmup_prefill(lengths=(16, 32, 64), ctx_limits=(64,))
    want = roll(JaxReplica(jcfg, jp, n_slots=3, max_ctx=128))
    assert roll(port) == want
