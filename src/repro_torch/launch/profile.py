"""Where the time of one decode chunk and one turn-1 prefill goes, on a card.

    python -m repro_torch.launch.profile [--slots 16] [--ctx 300]
           [--steps 16] [--prefill 512]

Builds one decode replica of qwen3-0.6b (full width, bf16, seeded torch
init), fills every slot with a `--ctx`-token conversation, and traces with
`torch.profiler` one ragged decode chunk of `--steps` steps over all slots
and one turn-1 prefill of `--prefill` tokens. For each it prints the
measured wall time (host clock, ending in `torch.cuda.synchronize()`), the
summed device time of the kernels the trace saw and its share of the wall
time (the device's busy share; the rest is idle, waiting on the host), the
number of kernel launches, and the kernels that took the most device time.
Needs a card.
"""
from __future__ import annotations

import argparse

TOP = 10  # kernels listed per traced region


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def _report(title, prof, wall_s, top):
    import torch
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = [r for r in rows if r[1] > 0]
    busy_ms = sum(r[1] for r in rows) / 1e3
    launches = sum(r[2] for r in rows)
    print(f"{title}: wall {wall_s * 1e3:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / (wall_s * 1e3):.1f}% of wall), "
          f"{launches} kernel launches")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%  "
              f"x{n:<5d} {key[:90]}")
    return busy_ms, launches


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--ctx", type=int, default=300)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--prefill", type=int, default=512)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.engine import ReplicaEngine
    from repro_torch.models import build_model

    dev = resolve_device("cuda")
    cfg = get_config("qwen3-0.6b")
    params = build_model(cfg).init(0, dev)
    eng = ReplicaEngine(cfg, params, n_slots=args.slots, max_ctx=1024,
                        attention_impl="cuda")
    rs = np.random.RandomState(0)
    nt = np.zeros(args.slots, np.int32)
    for _ in range(args.slots):
        s = eng.kv.acquire()
        nt[s] = int(eng.prefill_conversation(
            s, rs.randint(0, cfg.vocab_size, args.ctx))[0])
    em = np.ones(args.slots, bool)
    eng.decode_steps(nt, em, 2)  # warm
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    print(f"{torch.cuda.get_device_name(0)}; {cfg.name} {cfg.dtype}, "
          f"{cfg.n_layers} layers, {args.slots} slots at ctx ~{args.ctx}")
    _, dt0 = eng.decode_steps(nt, em, args.steps)
    print(f"decode chunk without the profiler: {dt0 * 1e3:.3f} ms "
          f"({dt0 * 1e3 / args.steps:.3f} ms per step)")
    with profile(activities=acts) as prof:
        _, dt = eng.decode_steps(nt, em, args.steps)
    _report(f"decode chunk ({args.steps} steps x {args.slots} slots, "
            f"profiled)", prof, dt, TOP)

    toks = rs.randint(0, cfg.vocab_size, args.prefill)
    for profiled in (False, True):
        eng.kv.release(0)
        s = eng.kv.acquire()
        torch.cuda.synchronize()
        if not profiled:
            _, dt = eng.prefill_conversation(s, toks)
            print(f"turn-1 prefill without the profiler: {dt * 1e3:.3f} ms")
            continue
        with profile(activities=acts) as prof:
            _, dt = eng.prefill_conversation(s, toks)
        _report(f"turn-1 prefill ({args.prefill} tokens, profiled)", prof,
                dt, TOP)


if __name__ == "__main__":
    main()
