"""Training launcher (reference `repro/launch/train.py`): builds the sharded
train step of `train_4k` for an (arch, mesh) and dry-runs it by default
(`dryrun.measure` of rank 0's program under the fake process group: the
per-device memory record), or, with --execute, runs real steps on
`SyntheticLM` batches.

  python -m repro_torch.launch.train --arch olmo-1b [--multi-pod]
      [--device meta|cuda] [--execute --steps N]

--execute needs the real process group of a torchrun launch (NCCL) whose
world size equals the mesh's (256 ranks, 512 with --multi-pod); anything
else raises before the first step. Each rank then builds its own shards of
the seeded weights and feeds its shard of each global batch. The dry run
needs the fake group; --execute skips it.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta"],
                    help="the dry run's device: cuda (default) or meta")
    ap.add_argument("--execute", action="store_true",
                    help="run real steps (requires a torchrun process group "
                         "of the mesh's size); default is the dry run only")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.launch.dryrun import measure, run_on_card
    from repro_torch.launch.mesh import make_production_mesh, world, \
        world_size
    from repro_torch.launch.specs import build_train_program

    n = world_size(multi_pod=args.multi_pod)
    kw = dict(grad_accum=args.grad_accum, compress_grads=args.compress_grads)
    if args.execute:
        if not dist.is_initialized():
            dist.init_process_group("nccl")
        if dist.get_backend() == "fake" or dist.get_world_size() != n:
            raise RuntimeError(
                f"--execute needs a real process group of {n} ranks (a "
                f"torchrun launch); this one is {dist.get_backend()} with "
                f"{dist.get_world_size()}")
        _execute(args, **kw)
        return
    with world(n):
        mesh = make_production_mesh(multi_pod=args.multi_pod, device="meta")
        step_fn, step_args = build_train_program(args.arch, mesh, **kw)
        _, counts = measure(step_fn, step_args)
        del step_fn, step_args
        print(counts["memory"])
        print("traced OK for", args.arch, "on", tuple(mesh.shape))
        if args.device == "cuda":
            _, rec = run_on_card(args.arch, "train_4k", args.multi_pod, None,
                                 **kw)
            print({"measured_peak_bytes": rec["measured_peak_bytes"],
                   "card": rec["card"]})


def _execute(args, **kw):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_train_program
    from repro_torch.models.sharding import data_placements
    from repro_torch.train import DataConfig, SyntheticLM
    from torch.distributed.tensor import distribute_tensor

    torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    mesh = make_production_mesh(multi_pod=args.multi_pod, device="cuda")
    step_fn, (params, opt, _) = build_train_program(args.arch, mesh,
                                                    device="cuda", **kw)
    cfg = get_config(args.arch)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 4096, 256))
    for i in range(args.steps):
        batch = {k: distribute_tensor(torch.as_tensor(v, device="cuda"),
                                      mesh, data_placements(mesh, v.ndim),
                                      src_data_rank=None)
                 for k, v in data.batch(i).items()}
        params, opt, m = step_fn(params, opt, batch)
        print(f"step {i}: loss={float(m['loss'].full_tensor()):.4f}")


if __name__ == "__main__":
    main()
