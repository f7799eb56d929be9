"""Production-mesh dry run (reference `repro/launch/dryrun.py`): build every
(architecture x input-shape) cell against the production mesh (16x16
single-pod / 2x16x16 multi-pod), run rank 0's program and record what one
device of that deployment holds, computes and communicates, as JSON.

The reference lowers and compiles on 512 fake host devices and reads XLA's
`memory_analysis()` and `cost_analysis()`. Here the mesh is a `DeviceMesh`
over torch's fake process group (`launch.mesh.world`): this process is rank
0, every collective a no-op, and the program (`launch.specs`) runs on
DTensors whose local tensors are rank 0's shards. `Meter`, a dispatch mode
below DTensor, sees rank 0's local ops and counts:

- `memory.argument_bytes`: the bytes of every input's local shard (an
  uneven split's ceil shard, the shard XLA pads to); `memory.output_bytes`:
  the returned tree's local storages (a train step's parameters, updated in
  place, count as outputs); `memory.temp_bytes`: the peak of live local
  storage bytes during the run, less the arguments. Buffers DTensor makes
  and frees inside one op's redistribution are not seen.
- `flops`: PER DEVICE — torch's flop registry (the matmul family: mm, bmm,
  addmm, baddbmm, attention) over rank 0's local ops, so replicated work
  counts on every device and sharded work once per shard. `flops_global`
  is the same registry over the program's global shapes (`ShardingRules`).
  XLA's cost analysis of an SPMD program is per device, and it also counts
  elementwise ops, which neither count here.
- `local_ops`: how many ops rank 0 runs (its kernel launches, collectives
  included, on a card).
- `bytes_accessed`: the operand and result bytes of rank 0's local ops,
  views and collectives left out. The ops are unfused, so this is an upper
  bound on what a fused program moves.
- `collective_bytes` / `collective_counts`: the result-buffer bytes and the
  count of each `c10d_functional` collective, under the reference's five
  names (`parse_collectives`'s accounting). On a CPU mesh (the meta
  estimate) torch runs an all-to-all as an all-gather and a chunk, so a
  cell that moves shards between dims records all-gathers there.

`trace_s` (the run's wall time) replaces `lower_s` / `compile_s`, and the
record has no `hlo_lines` (there is no HLO). Depth probes rerun the cell at
one and two pattern repetitions (`specs.probe_config`), as the reference
records them. The port runs every layer, so its record needs no
extrapolation: where a probe's program is the cell's (a decode cell), a
uniform stack's FLOPs and collective bytes equal g1 + (G-1)·(g2 - g1)
exactly.

With `device="cuda"` (the default), rank 0's program then also runs on the
card, on seeded shards, when the estimate (arguments + temp) fits the
card's memory: `memory.measured_peak_bytes` is `max_memory_allocated()`
over the run less what the process held before the cell's arguments were
made (so arguments included, and nothing else), and "on_card" holds the
card's name and power limit, its argument bytes and the run's seconds.
A cell that the estimate says fits and that runs out of memory raises.
`device="meta"` records the estimate only.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--device meta]
"""
import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ARTIFACT_DIR = (Path(__file__).resolve().parents[3] / "build"
                / "repro_torch_dryrun")

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "pred": 1, "s8": 1, "u8": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _type_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def parse_collectives(hlo_text: str):
    """Sum result-buffer bytes of every collective op in post-SPMD HLO.
    (operand size == result size for all-reduce / permute / all-to-all; for
    all-gather this counts the full gathered buffer ~= wire traffic; see
    benchmarks/roofline.py for the accounting note)."""
    totals = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        for op in _COLLECTIVES:
            # match result op, not operands mentioned elsewhere
            if f" {op}(" in line or f" {op}-start(" in line:
                lhs = line.split(f" {op}", 1)[0]
                for dtype, dims in _SHAPE_RE.findall(lhs):
                    if dtype in _DTYPE_BYTES:
                        totals[op] += _type_bytes(dtype, dims)
                counts[op] += 1
                break
    return totals, counts


# c10d_functional op name -> the reference's collective name
_FUNCOL = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
           ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
           ("permute", "collective-permute"))


def _collective(func):
    if func.namespace not in ("_c10d_functional", "c10d_functional"):
        return None
    name = func._overloadpacket.__name__
    for key, ref in _FUNCOL:
        if key in name:
            return ref
    return None


def _tensors(tree):
    """The plain tensors a tree of DTensors, tensors, modules, dicts and
    sequences holds (a DTensor's local tensor, a module's parameters)."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [t for p in tree.parameters() for t in _tensors(p)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _storage_bytes(tree) -> int:
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _make_meter(args):
    import weakref

    import torch
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    class Meter(TorchDispatchMode):
        """Rank 0's local ops (module docstring): DTensor-level ops are
        passed down (NotImplemented) so DTensor runs them with this mode
        still active and its local ops come through here."""

        def __init__(self):
            super().__init__()
            self.live = {}
            self.now = self.peak = 0
            self._track(_tensors(args))
            self.argument_bytes = self.now
            self.flops = 0
            self.bytes_accessed = 0
            self.ops = 0
            self.coll_bytes = {k: 0 for k in _COLLECTIVES}
            self.coll_counts = {k: 0 for k in _COLLECTIVES}

        def _track(self, out):
            for t in tree_leaves(out):
                if not isinstance(t, torch.Tensor):
                    continue
                st = t.untyped_storage()
                key = st._cdata
                if key in self.live:
                    continue
                self.live[key] = st.nbytes()
                self.now += st.nbytes()
                self.peak = max(self.peak, self.now)
                weakref.finalize(st, self._free, key)

        def _free(self, key):
            self.now -= self.live.pop(key, 0)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            # DTensor's sharding propagation runs ops on global-shaped fake
            # tensors to learn an output's metadata: not rank 0's work
            if any(issubclass(t, FakeTensor) for t in types) or any(
                    isinstance(t, FakeTensor) for t in tree_leaves(out)):
                return out
            self.ops += 1
            coll = _collective(func)
            if coll is not None:
                self.coll_bytes[coll] += sum(
                    t.nbytes for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
                self.coll_counts[coll] += 1
            elif func.namespace not in ("_c10d_functional",
                                        "c10d_functional"):
                count = flop_registry.get(func._overloadpacket)
                if count is not None:
                    self.flops += count(*args, **kwargs, out_val=out)
                if not func.is_view:
                    self.bytes_accessed += sum(
                        t.nbytes for t in tree_leaves((args, kwargs, out))
                        if isinstance(t, torch.Tensor))
            self._track(out)
            return out

    return Meter()


def measure(fn, args):
    """Run `fn(*args)` under a `Meter`: (its output, the counts)."""
    meter = _make_meter(args)
    t0 = time.time()
    with meter:
        out = fn(*args)
    trace_s = time.time() - t0
    counts = {
        "flops": meter.flops,
        "flops_global": fn.rules.flops_global,
        "bytes_accessed": meter.bytes_accessed,
        "memory": {"argument_bytes": meter.argument_bytes,
                   "output_bytes": _storage_bytes(out),
                   "temp_bytes": meter.peak - meter.argument_bytes},
        "collective_bytes": meter.coll_bytes,
        "collective_counts": meter.coll_counts,
        "collective_total": sum(meter.coll_bytes.values()),
        "local_ops": meter.ops,
        "trace_s": round(trace_s, 2),
    }
    return out, counts


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _defined_collectives():
    """A dispatch mode that gives each collective of rank 0's local program
    the result torch 2.13's fake group gives it — an all-gather repeats the
    local shard, an all-reduce and an all-to-all keep it, a reduce-scatter
    keeps its first share — computed on the card, so that the program's
    output holds defined values. (torch 2.11's fake group leaves a
    reduce-scatter's and an all-to-all's output as allocated.)"""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class DefinedCollectives(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            name = (func._overloadpacket.__name__
                    if _collective(func) else None)
            if name == "all_gather_into_tensor":
                x, n = args[0], args[1]
                return torch.cat([x] * n, dim=0)
            if name == "reduce_scatter_tensor":
                x, n = args[0], args[2]
                return x.narrow(0, 0, x.shape[0] // n).clone()
            if name == "all_reduce":
                return args[0].clone()
            if name == "all_to_all_single":
                x, rows = args[0], sum(args[1])
                return (x.clone() if rows == x.shape[0]
                        else x.new_zeros((rows, *x.shape[1:])))
            return func(*args, **kwargs)

    return DefinedCollectives()


def run_on_card(arch, shape_name, multi_pod, cfg, **program_kw):
    """Rank 0's program on the card under the fake group, its collectives'
    results defined (`_defined_collectives`): (the output, a record of its
    measured peak and argument bytes)."""
    import torch
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell

    mesh = make_production_mesh(multi_pod=multi_pod, device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # what the process held before
    fn, args = build_cell(arch, shape_name, mesh, cfg=cfg, device="cuda",
                          **program_kw)
    argument_bytes = _storage_bytes(args)  # before a step replaces any
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with _defined_collectives():
        out = fn(*args)
    torch.cuda.synchronize()
    return out, {
        "kind": torch.cuda.get_device_name(0), "card": card(),
        "argument_bytes": argument_bytes,
        "measured_peak_bytes": torch.cuda.max_memory_allocated() - held,
        "run_s": round(time.time() - t0, 2),
    }


def estimate_cell(arch: str, shape_name: str, mesh, cfg, device: str,
                  multi_pod: bool, **program_kw):
    """One cell's counts on `mesh` (a meta run, `measure`), printed; with
    `device="cuda"` and an estimate that fits the card, also rank 0's run
    on the card (`run_on_card`): its record under "on_card" and its peak as
    `memory.measured_peak_bytes`. Needs the mesh's process group."""
    from repro_torch.launch.specs import build_cell
    fn, args = build_cell(arch, shape_name, mesh, cfg=cfg, **program_kw)
    _, counts = measure(fn, args)
    del fn, args
    mem = counts["memory"]
    print(mem)    # what one device holds
    print({"flops": counts["flops"],
           "bytes accessed": counts["bytes_accessed"]})
    if device == "cuda":
        import torch
        need = mem["argument_bytes"] + mem["temp_bytes"]
        total = torch.cuda.get_device_properties(0).total_memory
        if need > total:
            counts["on_card"] = {"skipped": f"estimate {need} B > card "
                                            f"{total} B"}
        else:
            _, counts["on_card"] = run_on_card(arch, shape_name, multi_pod,
                                               cfg, **program_kw)
            mem["measured_peak_bytes"] = counts["on_card"][
                "measured_peak_bytes"]
    elif device != "meta":
        raise ValueError(f"device {device!r} not in ('cuda', 'meta')")
    return counts


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "base", out_dir: Path = ARTIFACT_DIR,
             cfg_overrides=None, device: str = "cuda", **program_kw):
    """Dry-run one cell on the production mesh and write its record."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh, world, world_size
    from repro_torch.launch.specs import build_cell, cell_supported, \
        probe_config

    mesh_name = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}__{variant}"
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{tag}.json"

    ok, reason = cell_supported(arch, shape_name)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "variant": variant, "supported": ok, "device": device}
    if not ok:
        record["reason"] = reason
        out_path.write_text(json.dumps(record, indent=2))
        print(f"[dryrun] {tag}: {reason}")
        return record

    base_cfg = get_config(arch)
    cfg_used = base_cfg.scaled(**cfg_overrides) if cfg_overrides else None
    cfg_full = cfg_used or base_cfg
    with world(world_size(multi_pod=multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        counts = estimate_cell(arch, shape_name, mesh, cfg_used, device,
                               multi_pod, **program_kw)
        _, n_groups, _ = cfg_full.pattern_groups()
        probes = {"n_groups": n_groups,
                  "pattern_len": len(cfg_full.block_pattern)}
        if n_groups > 1:
            for k in (1, 2):
                pcfg = probe_config(arch, k)
                if cfg_overrides:
                    pcfg = pcfg.scaled(**cfg_overrides)
                pfn, pargs = build_cell(arch, shape_name, mesh, cfg=pcfg,
                                        **program_kw)
                _, pc = measure(pfn, pargs)
                probes[f"g{k}"] = {
                    "flops": pc["flops"],
                    "bytes_accessed": pc["bytes_accessed"],
                    "collective_total": pc["collective_total"],
                }
        record.update({"n_devices": mesh.size(), **counts,
                       "probes": probes})
    out_path.write_text(json.dumps(record, indent=2))
    print(f"[dryrun] {tag}: flops={record['flops']:.3e} "
          f"coll={record['collective_total']:.3e}B "
          f"trace={record['trace_s']:.1f}s")
    return record


def all_cells():
    from repro_torch.configs import ASSIGNED, SHAPES
    return [(a, s) for a in ASSIGNED for s in SHAPES]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--in-process", action="store_true",
                    help="run --all cells in this process (default: one "
                         "subprocess per cell for isolation)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--flash-vjp", action="store_true",
                    help="recomputing flash attention (train memory variant)")
    ap.add_argument("--kv-dtype", default="",
                    help="quantized KV cache dtype for decode cells (int8)")
    ap.add_argument("--rwkv-pad-heads", type=int, default=0)
    ap.add_argument("--remat-layer", action="store_true",
                    help="per-layer remat granularity (train memory variant)")
    ap.add_argument("--fsdp", action="store_true",
                    help="FSDP/ZeRO-3 param sharding on the model axis "
                         "(train variant; baseline is Megatron TP)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta"],
                    help="cuda (default): the estimate, then rank 0's "
                         "program on the card; meta: the estimate only")
    args = ap.parse_args(argv)

    kw = {"device": args.device}
    if args.grad_accum != 1:
        kw["grad_accum"] = args.grad_accum
    if args.compress_grads:
        kw["compress_grads"] = True
    if args.no_remat:
        kw["remat"] = False
    if args.loss_chunk:
        kw["loss_chunk"] = args.loss_chunk
    if args.fsdp:
        kw["sharding_mode"] = "fsdp"
    overrides = {}
    if args.flash_vjp:
        overrides["flash_vjp"] = True
    if args.kv_dtype:
        overrides["kv_cache_dtype"] = args.kv_dtype
    if args.rwkv_pad_heads:
        overrides["rwkv_pad_heads_to"] = args.rwkv_pad_heads
    if args.remat_layer:
        overrides["remat_granularity"] = "layer"
    if overrides:
        kw["cfg_overrides"] = overrides

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required")
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        for mp in meshes:
            run_cell(args.arch, args.shape, mp, variant=args.variant, **kw)
        return

    cells = all_cells()
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    todo = []
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            tag = f"{arch}__{shape}__{mesh_name}__{args.variant}"
            if not args.force and (ARTIFACT_DIR / f"{tag}.json").exists():
                print(f"[dryrun] {tag}: cached, skip")
                continue
            todo.append((arch, shape, mp))

    if args.in_process:
        for arch, shape, mp in todo:
            run_cell(arch, shape, mp, variant=args.variant, **kw)
        return

    failed = []
    for arch, shape, mp in todo:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--variant", args.variant,
               "--device", args.device]
        if mp:
            cmd.append("--multi-pod")
        if args.grad_accum != 1:
            cmd += ["--grad-accum", str(args.grad_accum)]
        if args.compress_grads:
            cmd.append("--compress-grads")
        if args.no_remat:
            cmd.append("--no-remat")
        if args.flash_vjp:
            cmd.append("--flash-vjp")
        if args.kv_dtype:
            cmd += ["--kv-dtype", args.kv_dtype]
        if args.rwkv_pad_heads:
            cmd += ["--rwkv-pad-heads", str(args.rwkv_pad_heads)]
        if args.loss_chunk:
            cmd += ["--loss-chunk", str(args.loss_chunk)]
        if args.remat_layer:
            cmd.append("--remat-layer")
        if args.fsdp:
            cmd.append("--fsdp")
        print("[dryrun] spawn:", " ".join(cmd), flush=True)
        r = subprocess.run(cmd)
        if r.returncode != 0:
            print(f"[dryrun] FAILED: {arch} {shape} multi_pod={mp}",
                  flush=True)
            failed.append((arch, shape, mp))
    if failed:
        raise SystemExit(f"[dryrun] {len(failed)} cell(s) failed: {failed}")


if __name__ == "__main__":
    main()
