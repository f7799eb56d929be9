"""Refresh the depth-probe measurements inside the port's existing dry-run
artifacts (`dryrun.ARTIFACT_DIR`, never the reference's) without rerunning
the main cells (reference `repro/launch/reprobe.py`). The probes run on the
meta device.

  python -m repro_torch.launch.reprobe [--mesh 16x16] [--variant base]
"""
import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--only-arch", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import ARTIFACT_DIR, measure
    from repro_torch.launch.mesh import make_production_mesh, world, \
        world_size
    from repro_torch.launch.specs import build_cell, probe_config

    multi_pod = args.mesh == "2x16x16"
    with world(world_size(multi_pod=multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        for f in sorted(ARTIFACT_DIR.glob(
                f"*__{args.mesh}__{args.variant}.json")):
            rec = json.loads(f.read_text())
            if not rec.get("supported"):
                continue
            arch, shape = rec["arch"], rec["shape"]
            if args.only_arch and arch != args.only_arch:
                continue
            cfg_full = get_config(arch)
            _, n_groups, _ = cfg_full.pattern_groups()
            probes = {"n_groups": n_groups,
                      "pattern_len": len(cfg_full.block_pattern),
                      "method": "unrolled+block_full"}
            if n_groups > 1:
                for k in (1, 2):
                    pfn, pargs = build_cell(arch, shape, mesh,
                                            cfg=probe_config(arch, k))
                    _, pc = measure(pfn, pargs)
                    probes[f"g{k}"] = {
                        "flops": pc["flops"],
                        "bytes_accessed": pc["bytes_accessed"],
                        "collective_total": pc["collective_total"],
                    }
            rec["probes"] = probes
            f.write_text(json.dumps(rec, indent=2))
            g = probes.get("g2", {}).get("flops", 0) - probes.get(
                "g1", {}).get("flops", 0)
            print(f"[reprobe] {arch} {shape}: per-group flops {g:.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
