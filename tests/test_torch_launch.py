"""The port's launch layer (`repro_torch.launch.{mesh,specs,dryrun,train}`).

tests/test_launch.py's three tests run against the port (cell support rules
and the copied HLO collective parser). `cell_supported` equals the
reference's for every arch x shape, and `probe_config(arch, k)` equals the
reference's field by field for k = 1, 2.

The dry run runs on the meta device over torch's fake process group, on
reduced configs with the shapes cut (SHAPES monkeypatched: the published
ones take minutes to trace on a CPU): the record carries the reference's
keys (`hlo_lines` dropped, `trace_s` for lower/compile); its argument bytes
equal the sum of every input's ceil shard computed here from the shapes;
collectives appear under TP on the 16x16 mesh and none on the (1, 1) host
mesh; and the per-device FLOPs and collective bytes of a uniform stack
obey the probe identity full = g1 + (G-1)·(g2 - g1) exactly, and its
bytes accessed are the same for every layer after the first (whose
residual is converted to a partial sum, which no later layer repeats). The train launcher's --execute raises
on a process group of the wrong size, and its default dry run prints the
memory record. No test leaves a process group behind.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import (ALL_ARCHS, ASSIGNED, SHAPES,  # noqa: E402
                                 ShapeSpec, get_reduced, shapes)
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.dryrun import measure, parse_collectives, \
    run_cell  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, \
    world  # noqa: E402
from repro_torch.launch.specs import build_cell, cell_supported  # noqa: E402
from repro_torch.models.sharding import param_placements  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401

SMALL = {"train_4k": ShapeSpec("train_4k", 64, 32, "train"),
         "prefill_32k": ShapeSpec("prefill_32k", 64, 32, "prefill"),
         "decode_32k": ShapeSpec("decode_32k", 128, 32, "decode"),
         "long_500k": ShapeSpec("long_500k", 256, 1, "decode")}


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized(), "a test left a process group behind"


@pytest.fixture
def small(monkeypatch):
    """Short shapes and reduced configs for the dry run."""
    for k, v in SMALL.items():
        monkeypatch.setitem(shapes.SHAPES, k, v)
    monkeypatch.setattr(specs, "get_config", get_reduced)


# --- tests/test_launch.py, against the port ---------------------------------
def test_long_500k_support_rules():
    ok = {a for a in ASSIGNED if cell_supported(a, "long_500k")[0]}
    assert ok == {"rwkv6-3b", "recurrentgemma-9b"}
    # gemma3 is excluded by its published 128k max context, not by attention
    sup, reason = cell_supported("gemma3-12b", "long_500k")
    assert not sup and "max_seq" in reason


def test_all_other_cells_supported():
    for a in ASSIGNED:
        for s in SHAPES:
            if s == "long_500k":
                continue
            assert cell_supported(a, s)[0], (a, s)


def test_collective_parser():
    hlo = """
  %ar = bf16[16,128,512]{2,1,0} all-reduce(bf16[16,128,512] %x), replica_groups={}
  %ag.1 = f32[256,1024]{1,0} all-gather(f32[16,1024] %y), dimensions={0}
  %p = (bf16[8,8]{1,0}, bf16[8,8]{1,0}) all-to-all(%a, %b)
  %cp = u32[4]{0} collective-permute(u32[4] %z)
  %not_a_collective = f32[2]{0} add(f32[2] %a, f32[2] %b)
"""
    totals, counts = parse_collectives(hlo)
    assert counts["all-reduce"] == 1 and totals["all-reduce"] == 16*128*512*2
    assert counts["all-gather"] == 1 and totals["all-gather"] == 256*1024*4
    assert counts["all-to-all"] == 1 and totals["all-to-all"] == 2*8*8*2
    assert counts["collective-permute"] == 1 and totals["collective-permute"] == 16
    assert sum(counts.values()) == 4


# --- equal to the reference ------------------------------------------------
def test_cell_supported_matches_reference():
    from repro.launch.specs import cell_supported as ref
    for a in ALL_ARCHS:
        for s in SHAPES:
            assert cell_supported(a, s) == ref(a, s), (a, s)


@pytest.mark.parametrize("k", [1, 2])
def test_probe_config_matches_reference(k):
    from repro.launch.specs import probe_config as ref
    for a in ALL_ARCHS:
        mine, theirs = specs.probe_config(a, k), ref(a, k)
        for f in dataclasses.fields(theirs):
            assert getattr(mine, f.name) == getattr(theirs, f.name), (
                a, f.name)


# --- the dry run -------------------------------------------------------------
def _ceil_bytes(t, mesh, placements):
    shape = list(t.shape)
    for dim in range(len(shape)):
        n = math.prod(mesh.size(m) for m, p in enumerate(placements)
                      if p.is_shard() and p.dim == dim)
        shape[dim] = math.ceil(shape[dim] / n)
    return math.prod(shape) * t.element_size()


def test_dry_run_record(small, tmp_path):
    rec = run_cell("qwen3-0.6b", "decode_32k", False, out_dir=tmp_path,
                   device="meta")
    assert {"arch", "shape", "mesh", "variant", "supported", "n_devices",
            "probes", "collective_bytes", "collective_counts",
            "collective_total", "flops", "flops_global", "bytes_accessed",
            "trace_s", "memory"} <= set(rec)
    assert "hlo_lines" not in rec and "lower_s" not in rec
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes"}
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert set(rec["collective_bytes"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert rec["collective_total"] > 0
    assert 0 < rec["flops"] < rec["flops_global"]
    assert (tmp_path / "qwen3-0.6b__decode_32k__16x16__base.json").exists()
    skip = run_cell("qwen3-0.6b", "long_500k", False, out_dir=tmp_path,
                    device="meta")
    assert skip["supported"] is False and "reason" in skip


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_argument_bytes_are_the_ceil_shards(small, shape):
    with world(256):
        mesh = make_production_mesh(device="meta")
        cfg = get_reduced("qwen3-0.6b")
        fn, args = build_cell("qwen3-0.6b", shape, mesh, cfg=cfg)
        want = 0
        for p in args[0].parameters():
            want += _ceil_bytes(p, mesh, p.placements)
        stack = list(args[1:])
        while stack:
            x = stack.pop()
            if isinstance(x, dict):
                stack.extend(x.values())
            elif hasattr(x, "placements"):
                want += _ceil_bytes(x, mesh, x.placements)
            elif isinstance(x, torch.Tensor):
                want += x.nbytes
        _, counts = measure(fn, args)
    # the train batch's tokens and labels are one stand-in
    if shape == "train_4k":
        want -= _ceil_bytes(args[2]["labels"], mesh,
                            args[2]["labels"].placements)
    assert counts["memory"]["argument_bytes"] == want
    assert counts["memory"]["temp_bytes"] > 0


def test_collectives_under_tp_and_none_on_the_host_mesh(small):
    cfg = get_reduced("olmo-1b")
    with world(256):
        mesh = make_production_mesh(device="meta")
        _, tp = measure(*build_cell("olmo-1b", "prefill_32k", mesh, cfg=cfg))
        pls = param_placements(cfg, build_cell(
            "olmo-1b", "prefill_32k", mesh, cfg=cfg)[1][0], mesh)
        assert any(p.is_shard() for pl in pls.values() for p in pl)
    with world(1):
        _, host = measure(*build_cell("olmo-1b", "prefill_32k",
                                      make_host_mesh(device="meta"),
                                      cfg=cfg))
    assert tp["collective_counts"]["all-reduce"] + tp["collective_counts"][
        "reduce-scatter"] > 0 and tp["collective_total"] > 0
    assert host["collective_total"] == 0
    assert sum(host["collective_counts"].values()) == 0
    assert host["flops"] == host["flops_global"] > tp["flops"]


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_probe_identity_is_exact(small, shape):
    base = get_reduced("qwen3-0.6b")
    got = {}
    with world(256):
        mesh = make_production_mesh(device="meta")
        for g in (1, 2, 3, 4):
            _, got[g] = measure(*build_cell(
                "qwen3-0.6b", shape, mesh, cfg=base.scaled(n_layers=g)))
    for key in ("flops", "flops_global", "collective_total"):
        g1, g2, full = got[1][key], got[2][key], got[4][key]
        assert full == g1 + 3 * (g2 - g1), key
        assert g2 > g1
    # bytes: DTensor keeps the residual stream a partial sum from layer to
    # layer, and turns the first layer's replicated residual into one by a
    # division (Replicate -> Partial) that later layers skip, so the
    # identity holds exactly from the second layer on
    b = {g: got[g]["bytes_accessed"] for g in got}
    assert b[4] - b[3] == b[3] - b[2] > 0


def test_train_launcher_refuses_the_wrong_world():
    from repro_torch.launch.train import main
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="256 ranks"):
            main(["--execute", "--steps", "1"])
    finally:
        dist.destroy_process_group()


def test_train_launcher_dry_run(small, capsys):
    from repro_torch.launch.train import main
    main(["--arch", "olmo-1b", "--device", "meta"])
    out = capsys.readouterr().out
    assert "argument_bytes" in out and "temp_bytes" in out
    assert "traced OK for olmo-1b on (16, 16)" in out


# --- the programs' numbers on a real mesh -----------------------------------
def _rank_of_real_mesh(rank, port, results):
    """One rank of a real 4-process gloo group on a (2, 2) mesh: the
    DTensor programs (every `ShardingRules` rule on their path: GQA's
    uneven head split with one KV head, the gathered slices, the batched
    products over data x heads, the masked embedding and target gather)
    against the plain model on the same weights and inputs; the train
    step with and without flash_vjp."""
    import copy
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.models import build_model
        from repro_torch.models import sharding as S
        from repro_torch.train import AdamWConfig, adamw_init, \
            make_train_step

        def place(t, pl):
            return distribute_tensor(t, mesh, pl, src_data_rank=None)

        def placed(module):
            module = copy.deepcopy(module)
            pls = S.param_placements(cfg, module, mesh)
            for n, p in list(module.named_parameters()):
                owner = (module.get_submodule(n.rsplit(".", 1)[0])
                         if "." in n else module)
                setattr(owner, n.rsplit(".", 1)[-1], torch.nn.Parameter(
                    place(p.detach(), pls[n]), requires_grad=False))
            return module

        def full(t):
            return t.full_tensor() if hasattr(t, "full_tensor") else t

        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        cfg = get_reduced("qwen3-0.6b").scaled(n_kv_heads=1)
        m = build_model(cfg)
        ref = m.init(0, "cpu")
        gen = torch.Generator().manual_seed(0)
        B, ctx = 4, 32
        toks = torch.randint(0, cfg.vocab_size, (B, 16), generator=gen)
        dtoks = place(toks, S.data_placements(mesh, 2))
        gaps = {}
        want, _ = m.prefill(ref, toks)
        got, _ = specs.Program(lambda p, t: m.prefill(
            p, t, attention_impl="torch"))(placed(ref), dtoks)
        gaps["prefill"] = float((full(got) - want).abs().max())
        caches = {s: {k: {n: torch.randn(leaf.shape, generator=gen) * 0.5
                          for n, leaf in node.items()}
                      for k, node in tree.items()}
                  for s, tree in m.init_cache(B, ctx, device="cpu").items()}
        pls = S.cache_placements(cfg, mesh, caches, B)
        dcaches = {s: {k: {n: place(leaf, pls[s][k][n])
                           for n, leaf in node.items()}
                       for k, node in tree.items()}
                   for s, tree in caches.items()}
        pos = torch.tensor(ctx - 1, dtype=torch.int32)
        want, _ = m.decode_step(ref, toks[:, 0], caches, pos)
        got, _ = specs.Program(lambda p, t, c, q: m.decode_step(
            p, t, c, q, attention_impl="torch"))(
            placed(ref), place(toks[:, 0], S.to_placements(
                mesh, ("data",))), dcaches, pos)
        gaps["decode"] = float((full(got) - want).abs().max())
        batch = {"tokens": toks, "labels": toks}
        for flash in (False, True):  # online attention, or flash_vjp's
            model = build_model(cfg.scaled(flash_vjp=flash))
            step = make_train_step(model, AdamWConfig())
            plain = copy.deepcopy(ref)
            _, _, want = step(plain, adamw_init(plain), batch)
            dm = placed(ref)
            opt = {"mu": {n: torch.zeros_like(p) for n, p in
                          dm.named_parameters()},
                   "nu": {n: torch.zeros_like(p) for n, p in
                          dm.named_parameters()},
                   "step": torch.zeros((), dtype=torch.int32)}
            _, _, got = specs.Program(step)(dm, opt, {
                k: place(v, S.data_placements(mesh, 2))
                for k, v in batch.items()})
            tag = "_flash" if flash else ""
            gaps["loss" + tag] = float(abs(full(got["loss"])
                                           - want["loss"]))
            gaps["grad_norm" + tag] = float(abs(full(got["grad_norm"])
                                                - want["grad_norm"]))
            new = dict(plain.named_parameters())
            gaps["params" + tag] = max(
                float((full(p.detach()) - new[n]).abs().max())
                for n, p in dm.named_parameters())
        # a strided shard (batch on data, heads on model, merged) gathered
        # by hand gives the merged tensor back
        x = torch.randn(4, 6, 3, generator=gen)
        merged = specs._strided_view(place(x, (S.Shard(0), S.Shard(1))),
                                     (24, 3))
        gaps["unstride"] = float((specs._unstride(merged).full_tensor()
                                  - x.reshape(24, 3)).abs().max())
        if rank == 0:
            results.put(gaps)
        dist.destroy_process_group()
    except Exception:  # the parent reports the child's traceback
        import traceback
        results.put(traceback.format_exc())


def test_programs_match_the_plain_model_on_a_real_2x2_mesh():
    import multiprocessing
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_of_real_mesh,
                         args=(r, port, results)) for r in range(4)]
    for p in procs:
        p.start()
    try:
        gaps = results.get(timeout=240)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert isinstance(gaps, dict), gaps
    print(gaps)
    assert all(v < 1e-5 for v in gaps.values()), gaps


def test_reprobe_refreshes_the_ports_records(small, tmp_path, monkeypatch):
    """`launch.reprobe` rewrites the depth probes of the records in the
    port's artifact directory (here a temporary one) and leaves the rest
    of each record as it was."""
    import json
    from repro_torch.launch import dryrun, reprobe
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", tmp_path)
    rec = run_cell("qwen3-0.6b", "decode_32k", False, out_dir=tmp_path,
                   device="meta")
    path = tmp_path / "qwen3-0.6b__decode_32k__16x16__base.json"
    reprobe.main(["--only-arch", "qwen3-0.6b"])
    new = json.loads(path.read_text())
    assert new["probes"]["method"] == "unrolled+block_full"
    assert new["probes"]["g2"]["flops"] > new["probes"]["g1"]["flops"] > 0
    assert {k: v for k, v in new.items() if k != "probes"} == json.loads(
        json.dumps({k: v for k, v in rec.items() if k != "probes"}))
    assert not dist.is_initialized()
