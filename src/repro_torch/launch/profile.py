"""Where the time of one decode chunk and one turn-1 prefill goes, on a card,
with the replica's CUDA graphs and without them.

    python -m repro_torch.launch.profile
           [--arch qwen3-0.6b|olmo-1b|stablelm-12b|nemotron-4-15b|
                   gemma3-12b|rwkv6-3b|recurrentgemma-9b|
                   deepseek-v2-lite-16b|llama4-scout-17b-a16e|
                   internvl2-26b|whisper-small]
           [--layers N] [--slots 16] [--ctx 300] [--steps 16]
           [--prefill 512]

Builds one decode replica of `--arch` (default qwen3-0.6b; full width,
bf16, seeded torch init; `--layers` cuts the depth to N layers, widths
unchanged, for a model whose weights do not fit the card, such as
llama4-scout-17b-a16e's 200.7 GiB), fills every slot with a `--ctx`-token
conversation (after seeded stub frontend embeddings for internvl2-26b's
256 patches and whisper-small's 1500 frames), and traces with
`torch.profiler` one ragged decode chunk of `--steps` steps over all
slots and one turn-1 prefill of `--prefill` tokens, each twice: through the same bodies run eagerly
(`cuda_graphs=False`) and replayed from the bucket's CUDA graph (built and
captured by an untraced call first; its capture seconds are printed). For
each it prints the measured wall time (host clock, ending in
`torch.cuda.synchronize()`), the summed device time of the kernels the
trace saw and its share of the wall time (the device's busy share; the
rest is idle, waiting on the host), the number of kernel launches, and the
kernels that took the most device time, and the launches of each of the
port's own kernels (K1-K4) in each region, by its counter and as the trace
saw them. Needs a card.
"""
from __future__ import annotations

import argparse

TOP = 10  # kernels listed per traced region
# each port kernel's launch counter and the name its device kernels carry
# in the trace (K1's split launch; K2's two kernels share the prefix)
TRACE_NAMES = {"decode_attention": "decode_split_kernel",
               "prefill_attention": "prefill_", "wkv6": "wkv6_kernel",
               "rglru": "rglru_kernel"}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def kernel_rows(prof):
    """(name, device µs, launches) of each CUDA kernel a trace saw."""
    import torch
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return [r for r in rows if r[1] > 0]


def traced(fn):
    """Run `fn()` once under `torch.profiler` (CPU and CUDA activity).
    Returns (its result, `kernel_rows` of the trace)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
    return out, kernel_rows(prof)


def _report(title, rows, wall_s, top):
    from repro_torch.kernels import ops
    busy_ms = sum(r[1] for r in rows) / 1e3
    launches = sum(r[2] for r in rows)
    print(f"{title}: wall {wall_s * 1e3:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / (wall_s * 1e3):.1f}% of wall), "
          f"{launches} kernel launches")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%  "
              f"x{n:<5d} {key[:90]}")
    print(f"  port kernel launches: {ops.launch_counts()}")
    counts = {name: (sum(n for key, _, n in rows if sym in key),
                     sum(us for key, us, _ in rows if sym in key) / 1e3)
              for name, sym in TRACE_NAMES.items()}
    print("  port kernels in the trace (launches, device ms): "
          + ", ".join(f"{name} {n} {ms:.3f}"
                      for name, (n, ms) in counts.items()))
    ops.reset_launch_counts()
    return busy_ms, launches


MODES = ((False, "eager"), (True, "CUDA graph"))


def main(argv=None):
    from repro_torch.configs import ALL_ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ALL_ARCHS)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: all)")
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--ctx", type=int, default=300)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--prefill", type=int, default=512)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.engine import ReplicaEngine
    from repro_torch.engine.replica import ctx_bucket, decode_chunk_bucket
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.scaled(n_layers=args.layers)
    params = build_model(cfg).init(0, dev)
    eng = ReplicaEngine(cfg, params, n_slots=args.slots, max_ctx=1024,
                        attention_impl="cuda")
    rs = np.random.RandomState(0)
    n_front = (cfg.encoder_seq if cfg.is_encoder_decoder
               else cfg.frontend_len if cfg.frontend != "none" else 0)

    def front():
        """Seeded stub frontend embeddings (None without a frontend)."""
        if not n_front:
            return None
        x = rs.standard_normal((1, n_front, cfg.d_model)).astype(np.float32)
        return torch.from_numpy(x).to(dev, cfg.torch_dtype)

    nt = np.zeros(args.slots, np.int32)
    for _ in range(args.slots):
        s = eng.kv.acquire()
        nt[s] = int(eng.prefill_conversation(
            s, rs.randint(0, cfg.vocab_size, args.ctx), front())[0])
    em = np.ones(args.slots, bool)
    print(f"{torch.cuda.get_device_name(0)}; {cfg.name} {cfg.dtype}, "
          f"{cfg.n_layers} layers, {args.slots} slots at ctx ~{args.ctx}")
    n_steps = decode_chunk_bucket(args.steps)
    for graphs, label in MODES:
        eng.cuda_graphs = graphs
        for _ in range(2):  # warm: build (and capture) the next buckets
            eng.decode_steps(nt, em, args.steps)
        ctx = ctx_bucket(int(eng.kv.lengths.max()) + n_steps, 1024)
        _, dt0 = eng.decode_steps(nt, em, args.steps)
        prog = eng._fused[(n_steps, ctx)]
        print(f"decode chunk, {label}, without the profiler: "
              f"{dt0 * 1e3:.3f} ms ({dt0 * 1e3 / args.steps:.3f} ms per "
              f"step); bucket ({n_steps}, {ctx}) captured in "
              f"{prog.capture_s:.3f} s")
        ops.reset_launch_counts()
        (_, dt), rows = traced(lambda: eng.decode_steps(nt, em, args.steps))
        _report(f"decode chunk, {label} ({args.steps} steps x {args.slots} "
                f"slots, profiled)", rows, dt, TOP)

    toks = rs.randint(0, cfg.vocab_size, args.prefill)
    fe = front()
    eager = eng.exact_prefill or cfg.is_encoder_decoder
    if eager:
        print("turn-1 prefill: a recurrent model prefills at the exact "
              "length, an encoder-decoder at its bucket, eagerly, in both "
              "modes")
    for graphs, label in MODES[:1] if eager else MODES:
        eng.cuda_graphs = graphs
        for profiled in (None, False, True):  # warm, timed, traced
            eng.kv.release(0)
            s = eng.kv.acquire()
            torch.cuda.synchronize()
            if profiled is None:
                eng.prefill_conversation(s, toks, fe)
            elif not profiled:
                _, dt = eng.prefill_conversation(s, toks, fe)
                print(f"turn-1 prefill, {label}, without the profiler: "
                      f"{dt * 1e3:.3f} ms")
            else:
                ops.reset_launch_counts()
                (_, dt), rows = traced(
                    lambda: eng.prefill_conversation(s, toks, fe))
                _report(f"turn-1 prefill, {label} ({args.prefill} tokens, "
                        f"profiled)", rows, dt, TOP)
    print(f"programs {len(eng.programs())}, compile_s {eng.compile_s:.3f} s, "
          f"graph pool {eng.graph_pool_bytes() / 2**20:.1f} MiB, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


if __name__ == "__main__":
    main()
