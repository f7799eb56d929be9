"""Serving launcher of the port: the ConServe deployment on real replicas.

  python -m repro_torch.launch.serve --engine [--device cuda|cpu]
         [--slots N] [--n-conversations N] [--scheduler NAME]

One prefiller and two decoders, each a `ReplicaEngine` of the reduced
qwen3-0.6b with seeded weights, behind an `EngineServer` with the chosen
scheduler, replay a generated agentic trace through the shared `Runtime`
contract and print the serving summary. `--device` defaults to cuda and
fails without a card; pass `--device cpu` for a CPU run. (`chip_smoke.py`
serves the full-width model.)
"""
import argparse


def _drive(runtime, trace):
    """The whole serving contract: submit + run, then the summary."""
    from repro_torch.core.metrics import summarize
    recs = runtime.serve(trace)
    s = summarize(recs)
    for k in ("ttfet_gmean", "ttfet_p95", "last_tbt_gmean", "e2e_gmean",
              "kv_transfers_per_conv"):
        print(f"  {k}: {s[k]:.4f}")
    waits = [w for w in runtime.queue_waits().values() if w > 0]
    if waits:
        print(f"  admission waits: {len(waits)} conversations, "
              f"max {max(waits):.3f}s (backpressure, not a crash)")
    return recs


def engine_trace(n_conversations: int):
    """The launcher's engine workload: the classic generated agentic trace
    at engine scale."""
    from repro_torch.traces import TraceConfig, generate_trace
    tc = TraceConfig(first_input_median=150, first_input_max=500,
                     append_median=24, append_max=64,
                     output_median=10, output_max=32, mean_turns=3.0,
                     max_turns=6, tool_mean_s=0.05)
    return generate_trace(n_conversations, 2.0, cfg=tc)


def main(argv=None):
    ap = argparse.ArgumentParser()
    from repro_torch.core import SCHEDULERS
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scheduler", default="conserve",
                    choices=sorted(SCHEDULERS))
    ap.add_argument("--n-conversations", type=int, default=12)
    ap.add_argument("--slots", type=int, default=16,
                    help="KV slots per replica (small values exercise "
                         "admission backpressure)")
    ap.add_argument("--no-rotation", action="store_true",
                    help="disable continuous decode rotation (chunk-"
                         "boundary-only admission)")
    ap.add_argument("--prefill-mode", default=None,
                    choices=["jit", "reference"])
    args = ap.parse_args(argv)
    if not args.engine:
        ap.error("only --engine is ported to repro_torch so far")

    from repro_torch.configs import get_reduced
    from repro_torch.core import make_scheduler
    from repro_torch.device import resolve_device
    from repro_torch.engine import EngineServer, ReplicaEngine
    from repro_torch.models import build_model

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    params = build_model(cfg).init(0, device)
    reps = [ReplicaEngine(cfg, params, n_slots=args.slots, max_ctx=1024,
                          replica_id=i, role="prefill" if i == 0 else "decode")
            for i in range(3)]
    srv = EngineServer(make_scheduler(args.scheduler), reps,
                       rotation=not args.no_rotation,
                       prefill_mode=args.prefill_mode)
    _drive(srv, engine_trace(args.n_conversations))


if __name__ == "__main__":
    main()
