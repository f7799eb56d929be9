"""The port's RG-LRU against the JAX package's: the gated linear recurrence
(K4's plain version and the log-depth torch scan) and the RG-LRU layer's
pieces (`_causal_conv1d`, `_rglru_gates`, `rglru_prefill`, `rglru_decode`).

Recurrence: on the CPU, `ops.rglru_scan` takes K4's plain version (the step
recurrence of `kernels/ref.py`); it and the port's `rglru_scan_logdepth`
are held against the JAX `rglru_ref` and the Pallas `rglru_pallas` in
interpret mode, on the shapes of tests/test_kernels.py::test_rglru_sweep
plus S = 1 and a W that is not a power of two, at its 1e-5. K4 itself is
held against its plain version on a card (tests/test_torch_gpu.py).

Layer: one RG-LRU of `get_reduced("recurrentgemma-9b")` (d_model 64,
lru_width 64, conv width 4, float32), its weights converted from the JAX
params made in this process; outputs and states within 1e-5. Inputs are
made with numpy from a seed and handed to both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_kernel import rglru_pallas  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rglru import rglru_cuda, rglru_plain  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

TOL = 1e-5  # tests/test_kernels.py::test_rglru_sweep
IMPLS = ("torch", "cuda")


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32)
                               - t.float().numpy())))


def _scan_inputs(seed, B, S, W):
    """tests/test_kernels.py's distributions: log_a = -exp(0.3 N), b ~ 0.5 N,
    h0 ~ 0.2 N."""
    rs = np.random.RandomState(seed)

    def n(shape, sc):
        return (rs.standard_normal(shape) * sc).astype(np.float32)

    return -np.exp(n((B, S, W), 0.3)), n((B, S, W), 0.5), n((B, W), 0.2)


# --------------------------------------------------------------------------- #
# The recurrence: K4's plain version and the log-depth scan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,S,W,chunk,block_w", [
    (1, 128, 64, 64, 32), (1, 128, 64, 128, 64),
    (2, 256, 128, 64, 32), (2, 256, 128, 128, 64),
    (1, 512, 32, 64, 32),
    (1, 1, 64, 128, 512), (3, 37, 100, 128, 512)])
def test_rglru_plain_and_logdepth_match_jax(B, S, W, chunk, block_w):
    """The sweep's shapes (blocks that fit the dims), S = 1 and a ragged
    W = 100 with S = 37: four implementations agree within 1e-5."""
    arrs = _scan_inputs(0, B, S, W)
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(a) for a in arrs]
    want = {"ref": jref.rglru_ref(*j),
            "pallas": rglru_pallas(*j, chunk=chunk, block_w=block_w)}
    got = {"plain": ops.rglru_scan(*t),  # CPU tensors: the plain version
           "logdepth": trec.rglru_scan_logdepth(*t)}
    for wn, (wh, whT) in want.items():
        for gn, (gh, ghT) in got.items():
            assert gh.dtype == torch.float32 and gh.shape == (B, S, W)
            assert _err(wh, gh) < TOL, (wn, gn)
            assert _err(whT, ghT) < TOL, (wn, gn)


def test_rglru_dispatch_and_plain_version():
    """CPU tensors under impl="cuda" take the plain version and launch
    nothing; the plain version is the step recurrence; the CUDA wrapper
    refuses CPU tensors instead of falling back."""
    la, b, h0 = (torch.from_numpy(a) for a in _scan_inputs(1, 2, 9, 24))
    before = rglru_cuda.launches
    a1 = ops.rglru_scan(la, b, h0, impl="cuda")
    a2 = ops.rglru_scan(la, b, h0, impl="torch")
    assert rglru_cuda.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a1, a2))
    assert all(torch.equal(x, y) for x, y in zip(a1, rglru_plain(la, b, h0)))
    assert all(torch.equal(x, y) for x, y in zip(a1, ref.rglru_ref(la, b, h0)))
    assert torch.equal(a1[0][:, -1], a1[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru_cuda(la, b, h0)
    with pytest.raises(ValueError, match="impl"):
        ops.rglru_scan(la, b, h0, impl="pallas")


def test_logdepth_scan_folds_h0_and_takes_bf16_inputs():
    la, b, h0 = (torch.from_numpy(a) for a in _scan_inputs(2, 1, 33, 16))
    h, hT = trec.rglru_scan_logdepth(la.bfloat16(), b.bfloat16(), h0)
    want, wT = ref.rglru_ref(la.bfloat16(), b.bfloat16(), h0)
    assert h.dtype == torch.float32
    assert float((h - want).abs().max()) < TOL
    assert float((hT - wT).abs().max()) < TOL


# --------------------------------------------------------------------------- #
# The RG-LRU layer
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def layer():
    """One RG-LRU layer (groups/p0 of repetition 0) of the reduced model,
    the port's weights converted from the JAX params made here."""
    jcfg = jax_reduced("recurrentgemma-9b")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_reduced("recurrentgemma-9b")
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    jl = jax.tree_util.tree_map(lambda x: x[0], jp["groups"]["p0"]["rglru"])
    return cfg, jcfg, lm.blocks[0].rglru, jl


def _x(seed, shape):
    return (np.random.RandomState(seed).standard_normal(shape) * 0.5).astype(
        np.float32)


@pytest.mark.parametrize("S", [1, 2, 3, 9])
def test_causal_conv1d_matches_jax_and_carries_any_length(layer, S):
    """S < K-1 included: the carry is the last K-1 rows of prev ++ u, so a
    conv run token by token equals the conv over the whole input."""
    _, _, rg, jl = layer
    u, prev = _x(0, (2, S, 64)), _x(1, (2, 3, 64))
    jo, jc = jrec._causal_conv1d(jnp.asarray(u), jl["conv_k"], jl["conv_b"],
                                 jnp.asarray(prev))
    to, tc = trec._causal_conv1d(torch.from_numpy(u), rg.conv_k, rg.conv_b,
                                 torch.from_numpy(prev))
    assert _err(jo, to) < TOL and _err(jc, tc) == 0.0
    carry, outs = torch.from_numpy(prev), []
    for t in range(S):
        o, carry = trec._causal_conv1d(torch.from_numpy(u[:, t:t + 1]),
                                       rg.conv_k, rg.conv_b, carry)
        outs.append(o)
    assert float((torch.cat(outs, 1) - to).abs().max()) < TOL
    assert torch.equal(carry, tc)


def test_rglru_gates_match_jax(layer):
    _, _, rg, jl = layer
    u = _x(2, (2, 7, 64))
    jla, jig = jrec._rglru_gates(jl, jnp.asarray(u))
    tla, tig = trec._rglru_gates(rg, torch.from_numpy(u))
    assert tla.dtype == tig.dtype == torch.float32
    assert _err(jla, tla) < TOL and _err(jig, tig) < TOL
    assert float(tla.max()) <= 0.0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("S", [1, 5, 70])
def test_rglru_prefill_and_decode_match_jax(layer, impl, S):
    """A prefill from a carried state, then two decode steps: outputs, h and
    the conv carry within 1e-5 under both impls."""
    cfg, jcfg, rg, jl = layer
    x, x1 = _x(3, (2, S, 64)), _x(4, (2, 1, 64))
    state = {"h": _x(5, (2, 64)), "conv": _x(6, (2, 3, 64))}
    jo, js = jrec.rglru_prefill(jl, jcfg, jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in state.items()})
    to, ts = trec.rglru_prefill(rg, cfg, torch.from_numpy(x),
                                {k: torch.from_numpy(v)
                                 for k, v in state.items()},
                                attention_impl=impl)
    assert _err(jo, to) < TOL
    assert _err(js["h"], ts["h"]) < TOL and _err(js["conv"], ts["conv"]) == 0
    for _ in range(2):
        jo, js = jrec.rglru_decode(jl, jcfg, jnp.asarray(x1), js)
        to, ts = trec.rglru_decode(rg, cfg, torch.from_numpy(x1), ts)
        assert _err(jo, to) < TOL and _err(js["h"], ts["h"]) < TOL
    with pytest.raises(ValueError, match="attention_impl"):
        trec.rglru_prefill(rg, cfg, torch.from_numpy(x), ts,
                           attention_impl="pallas")


def test_rglru_init_state_matches_jax_shapes(layer):
    cfg, jcfg, _, _ = layer
    js = jrec.rglru_init_state(jcfg, 3)
    ts = trec.rglru_init_state(cfg, 3, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in js.items()} == {
        k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
        for k, v in ts.items()}
