"""F18 (ROADMAP queue 3), shown on the CPU: at the published capacity factor
the MoE breaks the stream contracts, in the JAX package and in the port
alike.

Reduced deepseek-v2-lite-16b at cf 1.25 (`reduced_config` sets cf = E/K,
which drops nothing): capacity is `ceil(n·K·cf / E)` places an expert over
each group of tokens, and a decode step's dead lanes and a prefill
bucket's pad rows take places too. So a token's expert output depends on
which other slots are live: turning rotation off, or a decoder's death and
the replay of its conversation, change which tokens share a step, and the
greedy streams change with them. Both engines run on `FixedStepClock`
(every measured step a fixed logical cost) so that they place, rotate,
kill and replay at the same logical moments, and the number of (cid,
turn) streams that differ from the rotation-on, failure-free run is
printed for each package. At cf = E/K no stream of the port differs: the
contracts hold where nothing is dropped, which is where the two packages
gate byte-identity.

The two packages' streams are not compared turn for turn past turn 0:
this deployment (two decoders, three conversations) appends against slot
buffers padded past their live rows, where the reference's MLA
append-prefill places the new keys wrongly (F22, shown here at the layer:
the port places them right)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import make_scheduler as jax_make_scheduler  # noqa: E402
from repro.core.conversation import Conversation as JaxConversation  # noqa: E402
from repro.core.conversation import Turn as JaxTurn  # noqa: E402
from repro.engine import EngineServer as JaxServer  # noqa: E402
from repro.engine import ReplicaEngine as JaxReplica  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.chaos.triggers import FailWhen, FixedStepClock  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import make_scheduler  # noqa: E402
from repro_torch.core.conversation import Conversation, Turn  # noqa: E402
from repro_torch.engine import EngineServer, ReplicaEngine  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

ARCH = "deepseek-v2-lite-16b"
PUBLISHED_CF = 1.25


class _Port(FailWhen, FixedStepClock, EngineServer):
    pass


class _Jax(FailWhen, FixedStepClock, JaxServer):
    pass


PORT = dict(server=_Port, replica=ReplicaEngine, scheduler=make_scheduler,
            conv=Conversation, turn=Turn)
JAX = dict(server=_Jax, replica=JaxReplica, scheduler=jax_make_scheduler,
           conv=JaxConversation, turn=JaxTurn)

# name -> (server kwargs, kill trigger kwargs)
CASES = {"rotation_on": ({}, dict(min_turn=10 ** 9)),
         "rotation_off": ({"rotation": False}, dict(min_turn=10 ** 9)),
         "replay": ({}, dict(victim_cid=1, min_turn=1))}


def _trace(side, n=3):
    return [side["conv"](cid=i, arrival_s=i * 1e-6, turns=[
        side["turn"](append_tokens=24 + 4 * i, output_tokens=10 + i,
                     tool_time_s=0.05),
        side["turn"](append_tokens=10 + 2 * i, output_tokens=8,
                     tool_time_s=0.0)]) for i in range(n)]


@pytest.fixture(scope="module")
def models():
    """{cf: (port cfg, port params, jax cfg, jax params)}: one set of
    reduced weights, converted in this process, at each capacity factor
    (the router and experts do not depend on it)."""
    jcfg = jax_reduced(ARCH)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    out = {}
    for cf in (None, PUBLISHED_CF):
        over = {} if cf is None else {"capacity_factor": cf}
        cfg = get_reduced(ARCH).scaled(**over)
        out[cf] = (cfg, params_from_numpy(tree, cfg, "cpu"),
                   jcfg.scaled(**over), jp)
    return out


def _serve(side, cfg, params, case):
    server_kw, trigger = CASES[case]
    reps = [side["replica"](cfg, params, n_slots=6, max_ctx=256,
                            replica_id=0, role="prefill"),
            side["replica"](cfg, params, n_slots=3, max_ctx=256,
                            replica_id=1, role="decode"),
            side["replica"](cfg, params, n_slots=3, max_ctx=256,
                            replica_id=2, role="decode")]
    srv = side["server"](side["scheduler"]("conserve"), reps,
                         record_tokens=True, strict_accounting=True,
                         **trigger, **server_kw)
    recs = srv.serve(_trace(side))
    assert len(recs) == 3
    if case == "replay":
        assert srv.killed is not None and srv.n_recoveries >= 1
    return {k: [int(t) for t in v] for k, v in srv.sampled_tokens.items()}


def _n_differ(a, b):
    assert set(a) == set(b)
    return sum(a[k] != b[k] for k in a)


def _differ_from_rotation_on(side, cfg, params):
    runs = {c: _serve(side, cfg, params, c) for c in CASES}
    return runs, {c: _n_differ(runs["rotation_on"], runs[c])
                  for c in ("rotation_off", "replay")}


@pytest.mark.parametrize("cf", [None, PUBLISHED_CF], ids=["dropless",
                                                          "published"])
def test_f18_a_slot_depends_on_the_other_live_slots(models, cf):
    """The mechanism, step by step: one decode step of 8 slots, the last
    slot's token fixed, the other seven drawn anew 20 times. At cf 1.25 the
    last slot's logits change with the others' tokens (its (token, k)
    places come last and are dropped when the others fill its experts) in
    some draws, the same draws in both packages (the reference's weights
    are drawn per process, F4, so how many varies from run to run); at cf
    = E/K they never change."""
    import jax.numpy as jnp
    from repro.models import build_model as jax_build_model
    from repro_torch.models import build_model
    cfg, params, jcfg, jp = models[cf]
    m, jm = build_model(cfg), jax_build_model(jcfg)
    B, ctx = 8, 16
    caches = m.init_cache(B, ctx, device="cpu")
    jc = jax.tree_util.tree_map(lambda leaf: jnp.zeros(leaf.shape,
                                                       leaf.dtype),
                                jm.cache_skeleton(B, ctx))
    pos = ctx - 1
    jdecode = jax.jit(jm.decode_step)

    def last_slot(toks):
        lt = m.decode_step(params, torch.from_numpy(toks), caches,
                           torch.tensor(pos))[0][-1].numpy()
        lj = np.asarray(jdecode(jp, jnp.asarray(toks), jc,
                                jnp.asarray(pos))[0])[-1]
        np.testing.assert_allclose(lt, lj, atol=1e-4)
        return lt, lj

    rs = np.random.RandomState(0)
    toks = rs.randint(0, cfg.vocab_size, B)
    t0, j0 = last_slot(toks)
    moved = {"port": 0, "jax": 0}
    for _ in range(20):
        toks[:-1] = rs.randint(0, cfg.vocab_size, B - 1)
        lt, lj = last_slot(toks)
        moved["port"] += bool(np.abs(lt - t0).max() > 1e-3)
        moved["jax"] += bool(np.abs(lj - j0).max() > 1e-3)
    print(f"F18, cf {cfg.capacity_factor}: the last slot's logits moved "
          f"in {moved} of 20 draws of the other slots")
    assert moved["port"] == moved["jax"]
    if cf == PUBLISHED_CF:
        assert moved["port"] > 0
    else:
        assert moved["port"] == 0


def test_f18_published_capacity_breaks_the_stream_contracts(models):
    """Served, at cf 1.25: the (cid, turn) streams that rotation off and a
    decoder's death and replay change, in each package, printed. Which
    streams change depends on which slots share each step when the kill
    lands, which the engine's measured clock moves under load, so the
    counts are printed, not gated (the dropless runs below are gated)."""
    cfg, params, jcfg, jp = models[PUBLISHED_CF]
    _, port = _differ_from_rotation_on(PORT, cfg, params)
    _, ref = _differ_from_rotation_on(JAX, jcfg, jp)
    print(f"F18 at cf {PUBLISHED_CF}, of 6 (cid, turn) streams, differing "
          f"from the rotation-on failure-free run: port {port}, JAX {ref}")


def test_f18_contracts_hold_where_nothing_is_dropped(models):
    """At cf = E/K the port's streams do not depend on rotation or replay;
    its turn-0 streams equal the JAX engine's, and its later turns differ
    only by F22 (the reference's MLA append-prefill positions)."""
    cfg, params, jcfg, jp = models[None]
    assert cfg.capacity_factor == cfg.n_experts / cfg.top_k
    port, differ = _differ_from_rotation_on(PORT, cfg, params)
    assert differ == {"rotation_off": 0, "replay": 0}
    ref = _serve(JAX, jcfg, jp, "rotation_on")
    assert {k: v for k, v in port["rotation_on"].items() if k[1] == 0} == \
        {k: v for k, v in ref.items() if k[1] == 0}


def test_f22_reference_mla_append_positions_new_keys_after_the_buffer():
    """F22: the reference's `mla_prefill` in engine mode (a prefix buffer
    padded past its live length, prefix_start 0, kv_lens) gives the new
    keys the positions P + j after the WHOLE buffer, not start_pos + j, so
    the causal mask hides each new token's own key and those before it;
    its logits then differ from the same append against the prefix trimmed
    to its live rows. The port's `mla_prefill` places them at start_pos + j
    and gives the same output both ways."""
    import jax.numpy as jnp
    from repro.models import attention as jatt
    from repro.models.layers import init_params as jax_init
    from repro_torch.models import attention as tatt
    jcfg = jax_reduced(ARCH)
    cfg = get_reduced(ARCH)
    jp = jax_init(jatt.attn_skeleton(jcfg, "attn_mla"),
                  jax.random.PRNGKey(3))
    attn = tatt.MLA(cfg, "cpu")
    with torch.no_grad():
        for n, t in attn.named_parameters():
            t.copy_(torch.from_numpy(np.asarray(jp[n])))
    rs = np.random.RandomState(0)
    live, buf, S = 20, 64, 6
    x0 = rs.standard_normal((1, live, cfg.d_model)).astype(np.float32)
    xa = rs.standard_normal((1, S, cfg.d_model)).astype(np.float32)
    _, jc = jatt.mla_prefill(jp, jcfg, jnp.asarray(x0), 0)
    _, tc = tatt.mla_prefill(attn, cfg, torch.from_numpy(x0), 0)
    jpad = {k: jnp.pad(v, ((0, 0), (0, buf - live), (0, 0)))
            for k, v in jc.items()}
    tpad = {k: torch.nn.functional.pad(v, (0, 0, 0, buf - live))
            for k, v in tc.items()}
    lens = np.array([live], np.int32)
    j_trim, _ = jatt.mla_prefill(jp, jcfg, jnp.asarray(xa), live,
                                 prefix_kv=jc)
    j_pad, _ = jatt.mla_prefill(jp, jcfg, jnp.asarray(xa), live,
                                prefix_kv=jpad, kv_lens=jnp.asarray(lens),
                                prefix_start=0)
    t_trim, _ = tatt.mla_prefill(attn, cfg, torch.from_numpy(xa), live,
                                 prefix_kv=tc)
    t_pad, _ = tatt.mla_prefill(attn, cfg, torch.from_numpy(xa), live,
                                prefix_kv=tpad,
                                kv_lens=torch.from_numpy(lens),
                                prefix_start=0)
    j_gap = float(np.abs(np.asarray(j_pad) - np.asarray(j_trim)).max())
    t_gap = float((t_pad - t_trim).abs().max())
    print(f"F22: padded against trimmed prefix, max |out| gap: JAX "
          f"{j_gap:.3e}, port {t_gap:.3e}")
    assert j_gap > 1e-2
    assert t_gap < 1e-5
    np.testing.assert_allclose(t_trim.numpy(), np.asarray(j_trim),
                               atol=1e-5)
