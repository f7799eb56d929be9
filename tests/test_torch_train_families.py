"""The port's training forward (`Model.hidden` + the chunked cross-entropy)
on one model of each family, against the JAX package's.

On reduced weights converted from the JAX params in this process and the
same seeded `SyntheticLM` batch, in float32: the loss within LOSS_RTOL
(1e-5) relative and every leaf's gradient within GRAD_RTOL (1e-4) of that
leaf's max |g_ref|, against the jitted
`jax.value_and_grad(make_loss_fn(...))` — for qwen3-0.6b (qk-norm),
gemma3-12b (five local layers to one global; S = 96 spans the reduced
window of 64 and stays within one 256-query chunk, where the reference's
`local_attention` is right, F7), gemma3-12b again with `flash_vjp` (the
recomputing backward under a window), deepseek-v2-lite-16b (MLA + the MoE
at the reduced cf = E/K), rwkv6-3b (`wkv6_chunked`), recurrentgemma-9b (the
log-depth RG-LRU scan, here at 4 layers: one pattern repetition and one
"rem" layer), internvl2-26b (seeded `frontend_embeds`) and whisper-small
(`encdec_hidden` over seeded frames).

rwkv6-3b is held to a float64 yardstick instead of the reference alone:
the reference's weights are drawn per process (F4: its init salts
`hash(path)`), and on some draws a head's WKV output has a variance far
below the group norm's eps, which then scales the fp32 rounding of that
output by up to 1/sqrt(eps) ~ 316 in every gradient behind it. Over
PYTHONHASHSEED 0-11 the reference's own fp32 gradients were up to 1.36e-4
of max |g| from float64 (seed 2), past GRAD_RTOL, and the port's up to
4.24e-4 before its chunked WKV summed the bonus term r·(u ⊙ k) in float64,
1.90e-4 after. So each rwkv6 leaf's gradient must be within GRAD_RTOL of
the yardstick, or no farther from it than YARD_MARGIN (2) times the
reference's own distance; the worst ratio measured was 1.41 (seed 2). The
yardstick is the port's training forward run on the same converted
weights with every op in float64 — the WKV recurrence and the
cross-entropy's logits included, `Tensor.float` widened to float64 — and a
dispatch mode refuses any op that gives a narrower float from tensor
inputs. Because the yardstick is the port's own code, two more checks tie
the case to the reference, so that a fault of the port's forward or
backward, which would move the yardstick with it, still fails: each
leaf's reference gradient within REF_YARD_CAP (5e-4) of the yardstick
(worst measured over seeds 0-23: 1.36e-4, seed 2), and each leaf's port
gradient within RWKV_GRAD_RTOL (1e-3) of the reference's, relative to its
max |g_ref| (worst measured over seeds 0-23: 3.26e-4, seed 2).

The port alone: every remat granularity gives the same loss and the same
gradients as no remat, and the training forward calls no function of
`kernels.ops` (a kernel has no backward; training runs the reference's
train path, `attention_impl="torch"`).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        reference_leaves)
from repro_torch.train import (DataConfig, SyntheticLM,  # noqa: E402
                               make_loss_fn)
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# rwkv6: the port's distance to the float64 yardstick may be this many
# times the reference's own (see the module docstring)
YARD_MARGIN = 2.0
# rwkv6: the reference's gradient's distance to the yardstick, and the
# port's to the reference's, each relative to the leaf's max |g|
REF_YARD_CAP = 5e-4
RWKV_GRAD_RTOL = 1e-3
# (arch, config overrides, sequence length)
FAMILIES = [("qwen3-0.6b", {}, 32),
            ("gemma3-12b", {}, 96),
            ("gemma3-12b", {"flash_vjp": True}, 96),
            ("deepseek-v2-lite-16b", {}, 32),
            ("rwkv6-3b", {}, 32),
            ("recurrentgemma-9b", {"n_layers": 4}, 32),
            ("internvl2-26b", {}, 32),
            ("whisper-small", {}, 32)]
IDS = ["qwen3", "gemma3", "gemma3-flash_vjp", "deepseek", "rwkv6",
       "recurrentgemma", "internvl2", "whisper"]


def reference_layout(lm, named, dtype=torch.float32):
    """{name: tensor} over the port's parameters -> {keystr: numpy} in the
    JAX package's stacked tree (`convert.reference_leaves`), copies in
    `dtype`."""
    out = {}
    for key, names, stacked in reference_leaves(lm):
        ts = [named[n].detach().to(dtype).clone() for n in names]
        out[key] = (torch.stack(ts) if stacked else ts[0]).numpy()
    return out


def _batch(cfg, seq):
    """A seeded batch of 2; a vision model's patch embeddings and an
    encoder-decoder's frames (encoder_seq of them) from the same seed."""
    n_front = (cfg.encoder_seq if cfg.is_encoder_decoder else
               cfg.frontend_len if cfg.frontend != "none" else 0)
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=2, frontend_len=n_front,
                                  d_model=cfg.d_model)).batch(0)


def _loss_and_grads(model, lm, batch, remat=True):
    names, ps = zip(*lm.named_parameters())
    for p in ps:
        p.requires_grad_(True)
    loss = make_loss_fn(model, remat=remat, loss_chunk=16)(lm, batch)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, ps)))


class Float64Only(TorchDispatchMode):
    """Raise on any op that gives a float narrower than float64 from
    tensor inputs (a factory of exact constants, such as the initial
    zero state, is left alone: its first use widens it)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor)
               for t in tree_flatten((args, kwargs))[0]):
            for t in tree_flatten(out)[0]:
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and t.dtype != torch.float64):
                    raise AssertionError(f"{func} gave {t.dtype}")
        return out


def float64_grads(arch, over, params_np, batch, monkeypatch):
    """The yardstick: the port's loss and gradients on the converted
    weights with every op in float64, in the reference's layout."""
    cfg = get_reduced(arch).scaled(dtype="float64", **over)
    lm = params_from_numpy(params_np, cfg, "cpu").double()
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", torch.Tensor.double)
        with Float64Only():
            loss, grads = _loss_and_grads(build_model(cfg), lm, batch)
    assert loss.dtype == torch.float64
    return reference_layout(lm, grads, torch.float64)


@pytest.fixture
def no_kernel_calls(monkeypatch):
    """Any call into `kernels.ops` raises."""
    def refuse(*a, **kw):
        raise AssertionError("the training forward called kernels.ops")
    for fn in ("prefill_attention", "decode_attention", "wkv6",
               "rglru_scan"):
        monkeypatch.setattr(ops, fn, refuse)


@pytest.mark.parametrize("arch,over,seq", FAMILIES, ids=IDS)
def test_loss_and_grads_match_reference(arch, over, seq, no_kernel_calls,
                                        monkeypatch):
    jcfg = jax_reduced(arch).scaled(**over)
    cfg = get_reduced(arch).scaled(**over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, jp)
    lm = params_from_numpy(params_np, cfg, "cpu")
    batch = _batch(cfg, seq)
    grad_fn = jax.value_and_grad(jax_make_loss_fn(jm, loss_chunk=16))
    jl, jg = jax.jit(grad_fn)(jp, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    loss, grads = _loss_and_grads(build_model(cfg), lm, batch)
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    want = {jax.tree_util.keystr(p): np.asarray(g)
            for p, g in jax.tree_util.tree_leaves_with_path(jg)}
    got = reference_layout(lm, grads)
    assert list(got) == list(want)
    if arch == "rwkv6-3b":
        yard = float64_grads(arch, over, params_np, batch, monkeypatch)
        for key, g in got.items():
            y = yard[key].astype(np.float64)
            top = np.abs(y).max()
            d_port = np.abs(g - y).max() / top
            d_ref = np.abs(want[key] - y).max() / top
            assert d_ref <= REF_YARD_CAP, (key, d_ref)
            assert d_port <= max(GRAD_RTOL, YARD_MARGIN * d_ref), (
                key, d_port, d_ref)
            err = np.abs(g - want[key]).max()
            assert err <= RWKV_GRAD_RTOL * np.abs(want[key]).max(), key
        return
    for key, g in got.items():
        err = np.abs(g - want[key]).max()
        assert err <= GRAD_RTOL * np.abs(want[key]).max(), key


@pytest.mark.parametrize("arch,over,seq", FAMILIES, ids=IDS)
def test_remat_granularities_match_no_remat(arch, over, seq,
                                            no_kernel_calls):
    cfg = get_reduced(arch).scaled(**over)
    lm = build_model(cfg).init(0, "cpu")
    batch = _batch(cfg, seq)
    base_loss, base = _loss_and_grads(build_model(cfg), lm, batch,
                                      remat=False)
    for gran in ("group", "layer", "both"):
        model = build_model(dataclasses.replace(cfg, remat_granularity=gran))
        loss, grads = _loss_and_grads(model, lm, batch)
        assert torch.equal(loss, base_loss), gran
        for n, g in grads.items():
            assert torch.equal(g, base[n]), (gran, n)
