"""The port's training substrate (`repro_torch.train`) on olmo-1b.

Mirrors of the reference's own tests on the port alone: tests/test_train.py
(the loss falls, grad accumulation equals the full batch, compressed grads
stay close, the data is deterministic), tests/test_checkpoint.py (round
trip, newest complete step, restore into a skeleton, shape mismatch) and
tests/test_perf_variants.py's flash-VJP and remat tests, each at the
reference's tolerances.

Parity with the JAX package on reduced olmo-1b, weights converted in this
process (Python salts the reference's init per process) and the same
seeded `SyntheticLM` batches, in float32:
  * the loss within LOSS_RTOL (1e-5) relative and every leaf's gradient
    within GRAD_RTOL (1e-4) of that leaf's max |g_ref|, against
    `jax.value_and_grad(make_loss_fn(...))`;
  * `adamw_update` alone on the same gradients: params and moments within
    OPT_TOL (1e-6);
  * three whole steps: the losses within STEPS_RTOL (1e-4) relative (not
    the parameters: Adam turns a rounding-level gradient near 0 into a
    +-lr step, so a parameter comparison would test noise);
  * grad accumulation and bf16 gradient compression: loss and grad norm
    within STEPS_RTOL relative.
F20 (weight decay on the reference's STACKED tree) and F19 (the reference
cannot restore a bfloat16 checkpoint; the port restores it bit-exactly and
writes the same files) are each shown on both packages. The port's
launcher trains `--small` on the CPU, and `--resume` continues an
interrupted run with the same losses. A kernel launch with a
grad-requiring input raises.
"""
import copy
import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import adamw_update as jax_adamw_update  # noqa: E402
from repro.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train import restore_checkpoint as jax_restore  # noqa: E402
from repro.train import save_checkpoint as jax_save  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train_lm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        reference_leaves)
from repro_torch.train import (AdamWConfig, DataConfig,  # noqa: E402
                               SyntheticLM, adamw_init, adamw_state_skeleton,
                               adamw_update, latest_step, make_loss_fn,
                               make_train_step, restore_checkpoint,
                               save_checkpoint)
from repro_torch.train.optimizer import decay_mask  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
OPT_TOL = 1e-6
STEPS_RTOL = 1e-4


def reference_layout(lm, named):
    """{name: tensor} over the port's parameters -> {keystr: numpy} in the
    JAX package's stacked tree (`convert.reference_leaves`), float32
    copies."""
    out = {}
    for key, names, stacked in reference_leaves(lm):
        ts = [named[n].detach().float().clone() for n in names]
        out[key] = (torch.stack(ts) if stacked else ts[0]).numpy()
    return out


def _pair(arch="olmo-1b", **over):
    """(JAX model, JAX params, port Model, port module on the CPU holding
    the same weights)."""
    jm = jax_build(jax_reduced(arch).scaled(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(arch).scaled(**over)
    return jm, jp, build_model(cfg), params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(l, dtype=np.float32)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(cfg, step=0, seq=32, batch=8):
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch)).batch(step)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _max_diff(m1, m2):
    return max(float((a.detach().float() - b.detach().float()).abs().max())
               for a, b in zip(m1.parameters(), m2.parameters()))


# --------------------------------------------------------------------------- #
# mirrors of tests/test_train.py
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced("olmo-1b")
    model = build_model(cfg)
    params = model.init(0, "cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8))
    return cfg, model, params, data


def test_loss_decreases(setup):
    cfg, model, params, data = setup
    params = copy.deepcopy(params)
    opt = adamw_init(params)
    step = make_train_step(
        model, AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=40))
    losses = []
    for i in range(25):
        params, opt, m = step(params, opt, data.batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2


def test_grad_accum_matches_full_batch(setup):
    cfg, model, params, data = setup
    batch = data.batch(0)
    cfgo = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    p1, p2 = copy.deepcopy(params), copy.deepcopy(params)
    p1, _, m1 = make_train_step(model, cfgo, grad_accum=1)(
        p1, adamw_init(p1), batch)
    p2, _, m2 = make_train_step(model, cfgo, grad_accum=4)(
        p2, adamw_init(p2), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-3
    assert _max_diff(p1, p2) < 3e-2  # same update up to fp tolerance


def test_grad_compression_close_to_exact(setup):
    cfg, model, params, data = setup
    batch = data.batch(1)
    cfgo = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    p1, p2 = copy.deepcopy(params), copy.deepcopy(params)
    _, _, m1 = make_train_step(model, cfgo)(p1, adamw_init(p1), batch)
    _, _, m2 = make_train_step(model, cfgo, compress_grads=True)(
        p2, adamw_init(p2), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5  # same fwd
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) \
        < 0.02 * float(m1["grad_norm"]) + 1e-3


def test_data_determinism_and_sharding():
    dc = DataConfig(vocab_size=1000, seq_len=16, global_batch=8)
    d = SyntheticLM(dc)
    b1, b2 = d.batch(5), d.batch(5)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    # shards are disjoint substreams covering the global batch size
    s0 = SyntheticLM(dc, shard=0, n_shards=2).batch(5)
    s1 = SyntheticLM(dc, shard=1, n_shards=2).batch(5)
    assert s0["tokens"].shape[0] == 4 and s1["tokens"].shape[0] == 4
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    # labels are next-token shifted
    assert np.array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


# --------------------------------------------------------------------------- #
# mirrors of tests/test_checkpoint.py
# --------------------------------------------------------------------------- #
@pytest.fixture()
def ckpt_setup(tmp_path):
    model = build_model(get_reduced("olmo-1b"))
    params = model.init(0, "cpu")
    return model, params, adamw_init(params), tmp_path


def test_checkpoint_roundtrip(ckpt_setup):
    model, params, opt, d = ckpt_setup
    save_checkpoint(d, 7, params, opt, extra={"tokens_seen": 123})
    assert latest_step(d) == 7
    fresh = model.init(1, "cpu")
    p2, o2, extra = restore_checkpoint(d, 7, fresh, adamw_init(fresh))
    assert extra["tokens_seen"] == 123
    for a, b in zip(params.parameters(), p2.parameters()):
        assert torch.equal(a, b)
    assert int(o2["step"]) == int(opt["step"])


def test_latest_step_picks_newest_complete(ckpt_setup):
    model, params, opt, d = ckpt_setup
    save_checkpoint(d, 1, params, opt)
    save_checkpoint(d, 5, params, opt)
    # simulate a crashed write: dir without manifest
    (Path(d) / "step_9").mkdir()
    assert latest_step(d) == 5


def test_restore_into_skeleton_structs(ckpt_setup):
    """Restore targets may be an uninitialised module and the state's meta
    skeleton (fresh process, no init)."""
    model, params, opt, d = ckpt_setup
    opt["mu"]["embed.w"] += 0.5
    opt["step"] += 3
    save_checkpoint(d, 3, params, opt)
    sk = model.module("cpu")
    p2, o2, _ = restore_checkpoint(d, 3, sk, adamw_state_skeleton(sk))
    for a, b in zip(params.parameters(), p2.parameters()):
        assert torch.equal(a, b)
    for sec in ("mu", "nu"):
        assert list(o2[sec]) == list(opt[sec])
        for n in opt[sec]:
            assert torch.equal(o2[sec][n], opt[sec][n])
    assert o2["step"].dtype == torch.int32 and int(o2["step"]) == 3


def test_shape_mismatch_raises(ckpt_setup):
    model, params, opt, d = ckpt_setup
    save_checkpoint(d, 2, params, opt)
    bad = build_model(get_reduced("olmo-1b").scaled(n_layers=3)).module(
        "cpu")
    with pytest.raises(ValueError):
        restore_checkpoint(d, 2, bad, adamw_state_skeleton(bad))


# --------------------------------------------------------------------------- #
# mirrors of tests/test_perf_variants.py
# --------------------------------------------------------------------------- #
def test_flash_vjp_matches_scan_path_grads():
    cfg0 = get_reduced("olmo-1b")
    cfg1 = dataclasses.replace(cfg0, flash_vjp=True)
    toks = np.random.RandomState(1).randint(0, cfg0.vocab_size, (2, 64))
    batch = {"tokens": toks, "labels": toks}
    m0, m1 = build_model(cfg0), build_model(cfg1)
    p0 = m0.init(0, "cpu")
    p1 = copy.deepcopy(p0)
    p0, _, s0 = make_train_step(m0, AdamWConfig())(p0, adamw_init(p0), batch)
    p1, _, s1 = make_train_step(m1, AdamWConfig())(p1, adamw_init(p1), batch)
    assert abs(float(s0["loss"]) - float(s1["loss"])) < 1e-6
    assert _max_diff(p0, p1) < 1e-6  # identical parameter update


def test_remat_granularity_preserves_loss():
    cfg0 = get_reduced("olmo-1b")
    toks = np.random.RandomState(0).randint(0, cfg0.vocab_size, (2, 32))
    batch = {"tokens": toks, "labels": toks}
    losses = {}
    for gran in ("group", "layer", "both"):
        cfg = dataclasses.replace(cfg0, remat_granularity=gran)
        m = build_model(cfg)
        params = m.init(0, "cpu")
        _, _, s = make_train_step(m, AdamWConfig())(params,
                                                    adamw_init(params), batch)
        losses[gran] = float(s["loss"])
    assert max(losses.values()) - min(losses.values()) < 1e-5


# --------------------------------------------------------------------------- #
# parity with the JAX package
# --------------------------------------------------------------------------- #
def _grads(model, lm, batch):
    names, ps = zip(*lm.named_parameters())
    for p in ps:
        p.requires_grad_(True)
    loss = make_loss_fn(model)(lm, batch)
    return float(loss.detach()), dict(zip(names, torch.autograd.grad(loss,
                                                                     ps)))


def test_loss_and_grads_match_reference():
    jm, jp, model, lm = _pair()
    batch = _batch(model.cfg)
    jl, jg = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm)))(jp,
                                                               _jnp(batch))
    loss, grads = _grads(model, lm, batch)
    assert abs(loss - float(jl)) <= LOSS_RTOL * abs(float(jl))
    want, got = _flat(jg), reference_layout(lm, grads)
    assert list(got) == list(want)
    for key, g in got.items():
        err = np.abs(g - want[key]).max()
        assert err <= GRAD_RTOL * np.abs(want[key]).max(), key


def test_adamw_update_matches_reference():
    """The same gradients through both updates, twice (the second from
    non-zero moments): params and moments within OPT_TOL."""
    jm, jp, model, lm = _pair()
    jcfg = JaxAdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    _, jg = jax.value_and_grad(jax_make_loss_fn(jm))(jp, _jnp(_batch(
        model.cfg)))
    flat_g = _flat(jg)
    grads = {}
    for key, names, stacked in reference_leaves(lm):
        g = torch.from_numpy(flat_g[key].copy())
        for i, n in enumerate(names):
            grads[n] = g[i] if stacked else g
    jstate, state = jax_adamw_init(jp), adamw_init(lm)
    for _ in range(2):
        jp, jstate, jmet = jax_adamw_update(jcfg, jg, jstate, jp)
        lm, state, met = adamw_update(cfg, grads, state, lm)
        assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) \
            <= OPT_TOL * float(jmet["grad_norm"])
        assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-7)
    assert int(state["step"]) == int(jstate["step"]) == 2
    pairs = [(reference_layout(lm, dict(lm.named_parameters())), _flat(jp))]
    pairs += [(reference_layout(lm, state[s]), _flat(jstate[s]))
              for s in ("mu", "nu")]
    for got, want in pairs:
        assert list(got) == list(want)
        for key in got:
            assert np.abs(got[key] - want[key]).max() <= OPT_TOL, key


def test_three_steps_match_reference():
    jm, jp, model, lm = _pair()
    jstep = jax.jit(jax_make_train_step(jm, JaxAdamWConfig(
        lr=3e-3, warmup_steps=2, total_steps=10)))
    step = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=2,
                                              total_steps=10))
    jstate, state = jax_adamw_init(jp), adamw_init(lm)
    for i in range(3):
        batch = _batch(model.cfg, step=i)
        jp, jstate, jm_ = jstep(jp, jstate, _jnp(batch))
        lm, state, m = step(lm, state, batch)
        want = float(jm_["loss"])
        assert abs(float(m["loss"]) - want) <= STEPS_RTOL * want, i


@pytest.mark.parametrize("grad_accum,compress", [(2, False), (1, True),
                                                 (4, True)])
def test_grad_accum_and_compression_match_reference(grad_accum, compress):
    jm, jp, model, lm = _pair()
    batch = _batch(model.cfg, step=2)
    kw = dict(grad_accum=grad_accum, compress_grads=compress)
    _, _, jmet = jax_make_train_step(jm, JaxAdamWConfig(), **kw)(
        jp, jax_adamw_init(jp), _jnp(batch))
    _, _, met = make_train_step(model, AdamWConfig(), **kw)(
        lm, adamw_init(lm), batch)
    for k in ("loss", "grad_norm"):
        want = float(jmet[k])
        assert abs(float(met[k]) - want) <= STEPS_RTOL * want, k


# --------------------------------------------------------------------------- #
# F20: weight decay on the reference's stacked tree
# --------------------------------------------------------------------------- #
F20_ARCHS = [("qwen3-0.6b", {}), ("gemma3-12b", {}), ("rwkv6-3b", {}),
             ("recurrentgemma-9b", {"n_layers": 5}),  # 1 group + 2 "rem"
             ("deepseek-v2-lite-16b", {}), ("whisper-small", {})]


@pytest.mark.parametrize("arch,over", F20_ARCHS, ids=[a for a, _ in F20_ARCHS])
def test_decay_mask_is_reference_ndim(arch, over):
    """The port decays exactly the leaves whose reference-tree ndim is >= 2,
    shown on both packages: with zero gradients only the decay moves a
    parameter, and each package moves the same leaves."""
    jm, jp, model, lm = _pair(arch, **over)
    want = {k: v.ndim >= 2 for k, v in _flat(jp).items()}
    mask = decay_mask(lm)
    for key, names, _ in reference_leaves(lm):
        assert {mask[n] for n in names} == {want[key]}, key
    cfg = JaxAdamWConfig(lr=1e-2, warmup_steps=1)
    before = _flat(jp)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jp)
    jp, _, _ = jax_adamw_update(cfg, zeros, jax_adamw_init(jp), jp)
    moved_ref = {k: not np.array_equal(v, before[k])
                 for k, v in _flat(jp).items()}
    assert moved_ref == want
    before = reference_layout(lm, dict(lm.named_parameters()))
    lm, _, _ = adamw_update(AdamWConfig(lr=1e-2, warmup_steps=1),
                            {n: torch.zeros_like(p)
                             for n, p in lm.named_parameters()},
                            adamw_init(lm), lm)
    after = reference_layout(lm, dict(lm.named_parameters()))
    assert {k: not np.array_equal(v, before[k])
            for k, v in after.items()} == want


def test_norm_scale_under_groups_is_decayed():
    """F20: qwen3's per-layer RMSNorm and qk-norm scales sit under "groups"
    (ndim 2 there) and are decayed; the final norm's scale (ndim 1) and a
    "rem" layer's are not."""
    _, _, _, lm = _pair("recurrentgemma-9b", n_layers=4)
    mask = decay_mask(lm)
    assert mask["blocks.0.ln1.scale"] and mask["blocks.2.ln2.scale"]
    assert not mask["blocks.3.ln1.scale"]  # the remainder's layer
    assert not mask["final_norm.scale"]
    _, _, _, lm = _pair("qwen3-0.6b")
    mask = decay_mask(lm)
    assert mask["blocks.1.attn.q_scale"] and mask["blocks.0.ln1.scale"]
    assert not mask["final_norm.scale"]


# --------------------------------------------------------------------------- #
# F19: bfloat16 checkpoints
# --------------------------------------------------------------------------- #
def _bf16_pair():
    jm, jp, _, _ = _pair("qwen3-0.6b")
    jp = jax.tree_util.tree_map(lambda l: l.astype(jnp.bfloat16), jp)
    cfg = get_reduced("qwen3-0.6b").scaled(dtype="bfloat16")
    lm = params_from_numpy(jax.tree_util.tree_map(
        lambda l: np.asarray(l.astype(jnp.float32)), jp), cfg, "cpu")
    return jm, jp, build_model(cfg), lm


def test_reference_cannot_restore_bf16_the_port_restores_it_exactly(
        tmp_path):
    jm, jp, model, lm = _bf16_pair()
    jopt = jax_adamw_init(jp)
    jax_save(tmp_path, 4, jp, jopt)
    with pytest.raises(ValueError, match="cast"):
        jax_restore(tmp_path, 4, jp, jopt)
    sk = model.module("cpu")
    p2, o2, _ = restore_checkpoint(tmp_path, 4, sk, adamw_state_skeleton(sk))
    want = {jax.tree_util.keystr(p): np.asarray(l).view(np.int16)
            for p, l in jax.tree_util.tree_leaves_with_path(jp)}
    ps = dict(p2.named_parameters())
    for key, names, stacked in reference_leaves(p2):
        ts = [ps[n] for n in names]
        got = (torch.stack(ts) if stacked else ts[0]).view(torch.int16)
        assert np.array_equal(got.numpy(), want[key]), key
    assert int(o2["step"]) == 0


def test_port_checkpoint_is_the_reference_format(tmp_path):
    """A port-written bf16 checkpoint has the reference's manifest — keys,
    order, files, shapes, dtypes — and byte-identical files."""
    jm, jp, model, lm = _bf16_pair()
    jax_save(tmp_path / "ref", 4, jp, jax_adamw_init(jp))
    save_checkpoint(tmp_path / "port", 4, lm, adamw_init(lm))
    dirs = [tmp_path / sub / "step_4" for sub in ("ref", "port")]
    ref, port = (json.loads((d / "manifest.json").read_text()) for d in dirs)
    assert port == ref
    assert any(e["dtype"] == "bfloat16" for e in ref["keys"])
    for ent in ref["keys"]:
        a, b = ((d / ent["file"]).read_bytes() for d in dirs)
        assert a == b, ent["key"]


def test_float32_checkpoints_restore_in_either_package(tmp_path):
    jm, jp, model, lm = _pair()
    jopt = jax_adamw_init(jp)
    jax_save(tmp_path / "ref", 1, jp, jopt)
    sk = model.module("cpu")
    p2, _, _ = restore_checkpoint(tmp_path / "ref", 1, sk,
                                  adamw_state_skeleton(sk))
    want = _flat(jp)
    got = reference_layout(p2, dict(p2.named_parameters()))
    assert all(np.array_equal(got[k], want[k]) for k in want)
    opt = adamw_init(lm)
    opt["nu"]["embed.w"] += 2.0
    save_checkpoint(tmp_path / "port", 1, lm, opt)
    zero = jax.tree_util.tree_map(jnp.zeros_like, jp)
    p3, o3, _ = jax_restore(tmp_path / "port", 1, zero, jopt)
    assert all(np.array_equal(v, want[k]) for k, v in _flat(p3).items())
    assert float(o3["nu"]["embed"]["w"].min()) == 2.0


# --------------------------------------------------------------------------- #
# the launcher and the kernels' guard
# --------------------------------------------------------------------------- #
SMALL = ["--small", "--device", "cpu", "--seq", "32", "--batch", "4"]


def test_launcher_loss_falls(tmp_path, capsys):
    losses = train_lm.main(SMALL + ["--steps", "12", "--ckpt-dir",
                                    str(tmp_path), "--ckpt-every", "100"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2
    assert "params=1.6M" in capsys.readouterr().out


def test_launcher_resume_equals_uninterrupted(tmp_path):
    args = SMALL + ["--steps", "6", "--ckpt-dir", str(tmp_path),
                    "--ckpt-every", "3"]
    whole = train_lm.main(args)
    shutil.rmtree(tmp_path / "step_6")  # interrupted after step 3
    resumed = train_lm.main(args + ["--resume"])
    assert resumed == whole[3:]


def test_kernel_launch_refuses_grad():
    """The guard on every kernel launch: grad mode on and an input that
    requires grad raises, naming the kernel and the train path; without
    either it passes."""
    x = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match='wkv6.*attention_impl="torch"'):
        ops._refuse_grad("wkv6", None, x)
    with torch.no_grad():
        ops._refuse_grad("wkv6", x)
    ops._refuse_grad("rglru", x.detach(), None)
