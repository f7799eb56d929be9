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
from torch_support import one_thread  # noqa: E402,F401

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
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


def reference_layout(lm, named):
    """{name: tensor} over the port's parameters -> {keystr: numpy} in the
    JAX package's stacked tree (`convert.reference_leaves`), float32
    copies."""
    out = {}
    for key, names, stacked in reference_leaves(lm):
        ts = [named[n].detach().float().clone() for n in names]
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


@pytest.fixture
def no_kernel_calls(monkeypatch):
    """Any call into `kernels.ops` raises."""
    def refuse(*a, **kw):
        raise AssertionError("the training forward called kernels.ops")
    for fn in ("prefill_attention", "decode_attention", "wkv6",
               "rglru_scan"):
        monkeypatch.setattr(ops, fn, refuse)


@pytest.mark.parametrize("arch,over,seq", FAMILIES, ids=IDS)
def test_loss_and_grads_match_reference(arch, over, seq, no_kernel_calls):
    jcfg = jax_reduced(arch).scaled(**over)
    cfg = get_reduced(arch).scaled(**over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    lm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           "cpu")
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
