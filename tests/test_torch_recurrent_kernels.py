"""The numerics of K3's and K4's chunk-parallel decompositions, on the CPU.

The kernels themselves (`csrc/wkv6.cu`, `csrc/rglru.cu`) run only on a card
(tests/test_torch_gpu.py holds them against their plain versions there).
What can be checked here is their arithmetic: the two functions below
follow the kernels' plans step for step, in float32 torch, and are held
against the JAX package's step recurrences `ref.wkv6_ref` and
`ref.rglru_ref` on inputs drawn with numpy from a seed.

- K3's plan: chunks of 8 tokens; in each, the recurrence from a zero state
  gives the local y (bonus included) and the chunk's state contribution;
  the chunk's total decay and r~_t = r_t * prod_{s<t} d_s are running
  products of d = exp(logw); a carry S <- D (.) S + dS runs over the chunks;
  y_t = local y_t + r~_t . S_chunk-start. Within 5e-5 of the result's
  magnitude (tests/test_kernels.py::test_wkv6_sweep's tolerance), under
  slow, default and strong decay (|cum logw| of 10^2-10^3 per 64 tokens,
  as at rwkv6-3b's full-width init).
- K4's plan: tiles of up to 16 x 16 steps split evenly over up to 16
  segments of at least 4 steps; each segment scans from zero keeping the
  local h and the running product of its decays; a carry over the
  segments; h_t = local_t + P_t * carry.
  Within 1e-5 (test_rglru_sweep's tolerance).
- The exponent form: the JAX `wkv6_chunked` forms its decay factors as
  exp(cum_t - cum_j) from log-decays summed over a 64-token chunk. What
  these draws show: its error grows with |cum| (from ~4e-7 under slow
  decay to ~1e-5 under strong decay) but stays inside 5e-5 here, while the
  running products stay at the slow-decay level. The model's own inputs,
  whose states are larger, are checked on the card (chip_smoke phase 6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

WKV_RTOL = 5e-5   # tests/test_kernels.py::test_wkv6_sweep
RGLRU_TOL = 1e-5  # tests/test_kernels.py::test_rglru_sweep
# log-decay draws: logw = -exp(0.5 N + shift); per 64 tokens |cum| is ~1.3
# (slow), ~73 (default) and ~330 (strong)
DECAY_SHIFT = {"slow": -4.0, "default": 0.0, "strong": 1.5}


def wkv6_chunk_plan(r, k, v, logw, u, state, chunk: int = 8):
    """K3's decomposition. r, k, v, logw (B, S, H, hs); u (H, hs); state
    (B, H, hs, hs) [key, value]. Returns (y, final state), float32."""
    rf, kf, vf = r.float(), k.float(), v.float()
    d = torch.exp(logw.float())
    uf = u.float()
    run = state.float().clone()
    ys = []
    for c0 in range(0, r.shape[1], chunk):
        rc, kc, vc, dc = (a[:, c0:c0 + chunk] for a in (rf, kf, vf, d))
        # chunk-local recurrence from zero: the local y and dS
        st = torch.zeros_like(run)
        y_loc = []
        for q in range(rc.shape[1]):
            rt, kt, vt, dt = rc[:, q], kc[:, q], vc[:, q], dc[:, q]
            bonus = (rt * uf[None] * kt).sum(-1)
            y_loc.append(torch.einsum("bhi,bhij->bhj", rt, st)
                         + bonus[..., None] * vt)
            st = dt[..., None] * st + kt[..., None] * vt[..., None, :]
        # r~ and the chunk's total decay as running products
        P = torch.ones_like(dc[:, 0])
        r_tilde = []
        for q in range(rc.shape[1]):
            r_tilde.append(rc[:, q] * P)
            P = P * dc[:, q]
        # carry, then the cross-chunk term
        start = run
        run = P[..., None] * run + st
        for q in range(rc.shape[1]):
            ys.append(y_loc[q] + torch.einsum("bhi,bhij->bhj", r_tilde[q],
                                              start))
    if not ys:
        return rf.new_zeros(r.shape), run
    return torch.stack(ys, dim=1), run


def rglru_segment_plan(log_a, b, h0, max_seg: int = 16, max_len: int = 16,
                       min_len: int = 4):
    """K4's decomposition. log_a, b (B, S, W); h0 (B, W). Returns (h_all,
    h_T), float32."""
    a = torch.exp(log_a.float())
    bf = b.float()
    S = a.shape[1]
    h = h0.float().clone()
    out = torch.empty_like(bf)
    for t0 in range(0, S, max_seg * max_len):
        rem = min(S - t0, max_seg * max_len)
        n_seg = min(max_seg, -(-rem // min_len))
        seg_len = -(-rem // n_seg)
        ends = []  # (P, local h) at each segment's end
        local = []
        for s in range(n_seg):
            lo, hi = t0 + s * seg_len, min(t0 + (s + 1) * seg_len, t0 + rem)
            hl, P = torch.zeros_like(h), torch.ones_like(h)
            steps = []
            for t in range(lo, hi):
                hl = a[:, t] * hl + bf[:, t]
                P = P * a[:, t]
                steps.append((t, P, hl))
            local.append(steps)
            ends.append((P, hl))
        cin = h
        for s in range(n_seg):
            for t, P, hl in local[s]:
                out[:, t] = P * cin + hl
            cin = ends[s][0] * cin + ends[s][1]
        h = cin
    return out, h


def _wkv_inputs(seed, B, S, H, hs, decay):
    rs = np.random.RandomState(seed)

    def n(shape, sc):
        return (rs.standard_normal(shape) * sc).astype(np.float32)

    r, k, v = (n((B, S, H, hs), 0.5) for _ in range(3))
    logw = -np.exp(n((B, S, H, hs), 0.5) + DECAY_SHIFT[decay])
    return r, k, v, logw.astype(np.float32), n((H, hs), 0.3), \
        n((B, H, hs, hs), 0.2)


def _rel(got, want):
    """max|got - want| / max(1, max|want|) over the outputs."""
    return max(float(np.max(np.abs(np.asarray(g, np.float32)
                                   - np.asarray(w, np.float32))))
               / max(1.0, float(np.max(np.abs(np.asarray(w)))))
               for g, w in zip(got, want))


def _jax_ref(fn, arrays):
    return [np.asarray(x) for x in fn(*[jnp.asarray(a) for a in arrays])]


@pytest.mark.parametrize("decay", ["slow", "default", "strong"])
@pytest.mark.parametrize("B,S,H,hs", [(1, 1, 2, 16), (1, 7, 2, 32),
                                      (2, 9, 3, 16), (1, 150, 2, 64),
                                      (1, 256, 1, 64)])
def test_wkv6_chunk_plan_matches_jax_step_recurrence(decay, B, S, H, hs):
    """S = 1, one token short of a chunk, one past it, the served median and
    four 64-token chunks of the JAX chunked form."""
    a = _wkv_inputs(0, B, S, H, hs, decay)
    want = _jax_ref(jref.wkv6_ref, a)
    got = wkv6_chunk_plan(*(torch.from_numpy(x) for x in a))
    assert got[0].shape == (B, S, H, hs)
    assert _rel([t.numpy() for t in got], want) < WKV_RTOL


def test_wkv6_bf16_inputs_widen_exactly():
    """bf16 r, k, v: the plan on the bf16 tensors equals the plan on their
    exact fp32 widening, and both sit within 5e-5 of the JAX recurrence
    fed the widened values."""
    a = _wkv_inputs(1, 1, 40, 2, 32, "strong")
    t = [torch.from_numpy(x) for x in a]
    t[:3] = [x.to(torch.bfloat16) for x in t[:3]]
    wide = [x.float() for x in t]
    got = wkv6_chunk_plan(*t)
    same = wkv6_chunk_plan(*wide)
    assert all(torch.equal(g, s) for g, s in zip(got, same))
    want = _jax_ref(jref.wkv6_ref, [x.numpy() for x in wide])
    assert _rel([x.numpy() for x in got], want) < WKV_RTOL


def test_exp_cum_factors_lose_precision_as_decay_grows():
    """The JAX `wkv6_chunked` (exp(cum_t - cum_j) factors, 64-token chunks)
    against the running products, each against the step recurrence, under
    slow and strong decay. What these draws show: the exponent form's error
    grows more than tenfold with |cum| (~4e-7 to ~1e-5) though it stays
    inside 5e-5; the products' stays at the slow-decay level."""
    err = {}
    for decay in ("slow", "strong"):
        a = _wkv_inputs(0, 1, 256, 2, 64, decay)
        want = _jax_ref(jref.wkv6_ref, a)
        err["exp", decay] = _rel(_jax_ref(jrec.wkv6_chunked, a), want)
        err["prod", decay] = _rel(
            [x.numpy() for x in wkv6_chunk_plan(*(torch.from_numpy(x)
                                                  for x in a))], want)
    assert err["exp", "strong"] > 10 * err["exp", "slow"]
    assert err["exp", "strong"] > 5 * err["prod", "strong"]
    assert err["prod", "strong"] < 3 * err["prod", "slow"] + 1e-6
    assert max(err.values()) < WKV_RTOL


def _scan_inputs(seed, B, S, W, strong=False):
    """test_rglru_sweep's distributions (log_a = -exp(0.3 N), b ~ 0.5 N,
    h0 ~ 0.2 N); `strong` shifts log_a so decays reach ~1e-4."""
    rs = np.random.RandomState(seed)

    def n(shape, sc):
        return (rs.standard_normal(shape) * sc).astype(np.float32)

    log_a = -np.exp(n((B, S, W), 0.3) + (2.0 if strong else 0.0))
    return log_a.astype(np.float32), n((B, S, W), 0.5), n((B, W), 0.2)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("B,S,W", [(1, 1, 33), (1, 15, 64), (1, 24, 48),
                                   (2, 257, 40), (1, 150, 96), (1, 512, 32)])
def test_rglru_segment_plan_matches_jax_step_recurrence(strong, B, S, W):
    """S = 1, one step short of a full segment, the median append (6
    segments of 4), one past a full tile, the served median (16 segments of
    10) and two full tiles."""
    a = _scan_inputs(0, B, S, W, strong)
    want = _jax_ref(jref.rglru_ref, a)
    got = rglru_segment_plan(*(torch.from_numpy(x) for x in a))
    assert got[0].shape == (B, S, W) and got[1].shape == (B, W)
    for g, w in zip(got, want):
        assert float(np.max(np.abs(g.numpy() - w))) < RGLRU_TOL
