"""The port's placements (`repro_torch.models.sharding`) against the
reference's PartitionSpecs (`repro.models.sharding`).

For every leaf of all eleven published configs, in "tp" and "fsdp" modes,
the port's spec of each per-layer parameter equals the reference's spec of
its stacked leaf (`param_pspecs` over `model.skeleton()`, no mesh needed)
with the group axis dropped; `convert.reference_leaves` pairs the names.
The one way the two may differ is listed: in "fsdp" mode the reference
shards the largest dim divisible by 16 of the STACKED leaf, which can be
the group axis, and the port then shards the layer's own largest such dim.
No published leaf does that (the list is empty); a reduced qwen3 at 32
layers, whose qk-norm scales (32, 16) do, shows the rule. Cache specs
equal `cache_pspecs` (batch > 1) and `_long_ctx_spec` (batch 1) on both
meshes' dp axes; placements put a ("pod", "data") dim on pod, then data,
and rank 0's shard is the ceil share at offset 0. A checkpoint restored
with `shardings` holds, on each parameter and its moments, rank 0's slice
of the saved array.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch.specs import _long_ctx_spec  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.sharding import cache_pspecs, data_pspec, \
    param_pspecs  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config, get_reduced  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, world, \
    world_size  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402
from repro_torch.models.convert import reference_leaves  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

# fsdp leaves of the published configs whose reference spec shards the
# group axis (no per-layer counterpart): none
FSDP_GROUP_AXIS = {arch: [] for arch in ALL_ARCHS}


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized(), "a test left a process group behind"


def _ref_specs(tree, skeleton):
    """{keystr: (spec padded to the leaf's rank)} of a reference spec tree
    over its skeleton."""
    specs = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    shapes = jax.tree_util.tree_leaves(skeleton)
    return {jax.tree_util.keystr(p): tuple(s) + (None,) * (
        len(l.shape) - len(tuple(s))) for (p, s), l in zip(specs, shapes)}


def _mismatches(ref_cfg, cfg, mode):
    ref = _ref_specs(param_pspecs(ref_cfg, ref_build(ref_cfg).skeleton(),
                                  mode=mode),
                     ref_build(ref_cfg).skeleton())
    module = build_model(cfg).module("meta")
    mine = S.param_specs(cfg, module, mode)
    bad, n = [], 0
    for key, names, stacked in reference_leaves(module):
        want = ref[key][1:] if stacked else ref[key]
        n += 1
        if any(mine[name] != want for name in names):
            bad.append(key)
    assert n == len(ref), "every reference leaf has port parameters"
    return bad


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_reference(arch, mode):
    bad = _mismatches(ref_config(arch), get_config(arch), mode)
    assert bad == (FSDP_GROUP_AXIS[arch] if mode == "fsdp" else [])


def test_fsdp_group_axis_leaves_are_the_listed_kind():
    """Reduced qwen3 at 32 layers: the stacked qk-norm scales (32, 16)
    shard the group axis in the reference; the port shards the scale's own
    16. Those two leaves are the only difference."""
    from repro.configs import get_reduced as ref_reduced
    bad = _mismatches(ref_reduced("qwen3-0.6b").scaled(n_layers=32),
                      get_reduced("qwen3-0.6b").scaled(n_layers=32), "fsdp")
    assert bad == ["['groups']['p0']['attn']['k_scale']",
                   "['groups']['p0']['attn']['q_scale']"]
    assert S.fsdp_spec((16,)) == ("model",)


def test_rwkv_channel_mix_stays_replicated():
    """F21: `wk`/`wv` are in the replicated set, tested before the cmix
    rules, in both packages; the channel-mix's receptance is sharded."""
    cfg = get_config("rwkv6-3b")
    specs = S.param_specs(cfg, build_model(cfg).module("meta"))
    assert specs["blocks.0.cmix.wk"] == (None, None)
    assert specs["blocks.0.cmix.wv"] == (None, None)
    assert specs["blocks.0.cmix.wr"] == (None, "model")


@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-12b", "rwkv6-3b",
                                  "recurrentgemma-9b",
                                  "deepseek-v2-lite-16b", "whisper-small"])
def test_cache_specs_match_reference(arch, batch):
    ref_cfg = ref_config(arch)
    sk = ref_build(ref_cfg).cache_skeleton(batch, 64)
    cfg = get_config(arch)
    tree = build_model(cfg).init_cache(batch, 64, device="meta")
    for dp in (("data",), ("pod", "data")):
        if batch == 1:
            ref = jax.tree_util.tree_map_with_path(
                lambda p, l: _long_ctx_spec(p, l, dp), sk)
            mine = S.long_ctx_specs(tree, dp)
        else:
            ref = cache_pspecs(ref_cfg, sk, dp)
            mine = S.cache_specs(cfg, tree, dp)
        ref = _ref_specs(ref, sk)
        flat = {}

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{path}[{k!r}]")
                else:
                    flat[f"{path}[{k!r}]"] = v
        walk(mine, "")
        assert flat == ref


@pytest.mark.parametrize("multi_pod", [False, True])
def test_data_placements_and_rank0_shard(multi_pod):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with world(world_size(multi_pod=multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        dp = ("pod", "data") if multi_pod else ("data",)
        assert S.mesh_axes(mesh) == (dp, "model")
        want = tuple(data_pspec(dp, 3))
        assert S.data_spec(dp, 3) == want + (None,) * (3 - len(want))
        pl = S.data_placements(mesh, 3)
        assert pl == ((Shard(0), Shard(0), Replicate()) if multi_pod
                      else (Shard(0), Replicate()))
        # pod is the major axis: rank 0 holds the first ceil share
        shape, offset = compute_local_shape_and_global_offset(
            (100, 7, 5), mesh, pl)
        n = math.prod(mesh.size(m) for m in range(len(dp)))
        assert tuple(shape) == (math.ceil(100 / n), 7, 5) == \
            S.local_shape((100, 7, 5), mesh, pl)
        assert tuple(offset) == (0, 0, 0)
        with pytest.raises(ValueError, match="mesh's order"):
            S.to_placements(mesh, ((dp[-1], "model")[::-1],))


def test_restore_with_shardings_slices_rank0(tmp_path):
    from repro_torch.train import adamw_init, restore_checkpoint, \
        save_checkpoint
    from repro_torch.train.optimizer import adamw_state_skeleton
    cfg = get_reduced("olmo-1b")
    model = build_model(cfg)
    params = model.init(3, "cpu")
    opt = adamw_init(params)
    for n, t in opt["mu"].items():
        t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(
            len(n))))
    save_checkpoint(str(tmp_path), 5, params, opt)
    saved = {n: p.detach().clone() for n, p in params.named_parameters()}
    mu = {n: t.clone() for n, t in opt["mu"].items()}
    with world(256):
        mesh = make_production_mesh(device="cpu")
        like = model.init(0, "cpu")
        pls = S.param_placements(cfg, like, mesh)
        shardings = {n: (mesh, pl) for n, pl in pls.items()}
        got, state, _ = restore_checkpoint(
            str(tmp_path), 5, like, adamw_state_skeleton(like),
            shardings=shardings)
        n_sharded = 0
        for n, p in got.named_parameters():
            assert isinstance(p, DTensor) and p.placements == pls[n]
            local = S.local_shape(saved[n].shape, mesh, pls[n])
            sl = tuple(slice(0, s) for s in local)
            assert torch.equal(p.to_local(), saved[n][sl])
            assert state["mu"][n].placements == pls[n]
            assert torch.equal(state["mu"][n].to_local(), mu[n][sl])
            n_sharded += p.to_local().numel() < p.numel()
        assert n_sharded > 0
        assert int(state["step"]) == int(opt["step"])
        assert np.isfinite(float(got.embed.w.to_local().sum()))
