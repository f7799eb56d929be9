"""Serving launcher of the port: the ConServe deployment driver.

Three modes:
  --engine  : real replicas of the port on one device (the card by
              default; `--device cpu` for a CPU run)
  --sim     : the calibrated discrete-event cluster runtime (no model, no
              device)
  (default) : the production-mesh dry run of `--arch`'s prefill_32k and
              decode_32k cells (`launch.dryrun.estimate_cell`): each
              per-device memory record, on `--device meta` the estimate
              only, on cuda also rank 0's measured peak on the card

Both drive their backend through the ONE shared
`repro_torch.core.runtime.Runtime` contract (submit/run/results + admission
control), so the launcher — like the schedulers — cannot tell the two
scales apart.

  python -m repro_torch.launch.serve [--engine | --sim] [--multi-pod]
         [--arch qwen3-0.6b|olmo-1b|stablelm-12b|nemotron-4-15b|gemma3-12b|
                 rwkv6-3b|recurrentgemma-9b|deepseek-v2-lite-16b|
                 llama4-scout-17b-a16e|internvl2-26b|whisper-small]
         [--device cuda|cpu] [--slots N] [--n-conversations N]
         [--scheduler NAME] [--gateway] [--scenario NAME] [--seed S]

`--engine` runs one prefiller and two decoders (three mixed replicas under
`collocated`), each a `ReplicaEngine` of the reduced `--arch` (default
qwen3-0.6b) with seeded weights and slots of max_ctx 1024. A replica
refuses max_ctx > window for a model with local attention, and the reduced
recurrentgemma-9b's and gemma3-12b's windows are 64: the launcher widens a
reduced window below max_ctx to max_ctx, and says so. A replica refuses an
encoder-decoder's turn-1 whose frames do not number encoder_seq (F16), and
the reduced whisper-small sends 8 frames (its frontend_len) to 16 cross
rows: the launcher sets its frontend_len to encoder_seq, and says so.
`--device` defaults to cuda and fails without a card. `--sim` runs
`paper_deployment(scheduler)`.
(`chip_smoke.py` serves the models at full width.)

--scenario picks a named workload from the scenario library
(`repro_torch.traces.SCENARIOS`); --gateway serves it LIVE through the async
streaming gateway (staged arrivals, per-token event bus) instead of the
offline submit+run batch path — same runtime, same records, plus live
streaming observables.
"""
import argparse


def _drive(runtime, trace, gateway: bool = False):
    """The whole serving contract, backend-agnostic. With `gateway`, the
    trace is injected live through `repro_torch.serve` (staged arrivals
    driven by an asyncio loop) rather than submitted as one offline batch."""
    from repro_torch.core.metrics import summarize
    if gateway:
        from repro_torch.serve import serve_scenario_live
        recs, gw, _ = serve_scenario_live(runtime, trace)
        h = gw.health()
        print(f"  gateway: {h['n_submitted']} submitted, {h['n_done']} done, "
              f"{h['n_shed']} shed; events: {h['events_seen']}")
    else:
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


def engine_roles(scheduler: str):
    """Replica roles of the engine deployment: the collocated baseline
    places every turn on a mixed replica; the others split one prefiller
    from two decoders."""
    if scheduler == "collocated":
        return ("mixed",) * 3
    return ("prefill", "decode", "decode")


def main(argv=None):
    ap = argparse.ArgumentParser()
    from repro_torch.core import SCHEDULERS
    from repro_torch.configs import ALL_ARCHS
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ALL_ARCHS)
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--sim", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="engine: the replicas' device; default mode: cuda "
                         "(the estimate, then rank 0 on the card) or meta")
    ap.add_argument("--multi-pod", action="store_true",
                    help="default mode: the 2x16x16 mesh")
    ap.add_argument("--scheduler", default="conserve",
                    choices=sorted(SCHEDULERS))
    ap.add_argument("--n-conversations", type=int, default=12)
    ap.add_argument("--slots", type=int, default=16,
                    help="engine: KV slots per replica (small values "
                         "exercise admission backpressure)")
    ap.add_argument("--no-rotation", action="store_true",
                    help="engine: disable continuous decode rotation "
                         "(chunk-boundary-only admission)")
    ap.add_argument("--prefill-mode", default=None,
                    choices=["jit", "reference"])
    ap.add_argument("--gateway", action="store_true",
                    help="serve LIVE through the async streaming gateway "
                         "(staged arrivals + per-token event bus) instead "
                         "of the offline batch path")
    ap.add_argument("--scenario", default=None,
                    help="named workload from the scenario library "
                         "(pareto_burst, supervisor_worker, hitl_longpark, "
                         "shared_preamble_fleet); default: the classic "
                         "generate_trace workload")
    ap.add_argument("--seed", type=int, default=0,
                    help="scenario seed (byte-identical trace per seed)")
    args = ap.parse_args(argv)

    if args.engine:
        from repro_torch.configs import get_reduced
        from repro_torch.core import make_scheduler
        from repro_torch.device import resolve_device
        from repro_torch.engine import EngineServer, ReplicaEngine
        from repro_torch.models import build_model
        from repro_torch.models.config import ATTN_LOCAL

        device = resolve_device(args.device)
        cfg = get_reduced(args.arch)
        max_ctx = 1024
        if ATTN_LOCAL in cfg.block_pattern and 0 < cfg.window < max_ctx:
            print(f"  {cfg.name} (reduced): window {cfg.window} -> {max_ctx} "
                  f"(a replica needs max_ctx <= window)")
            cfg = cfg.scaled(window=max_ctx)
        if cfg.is_encoder_decoder and cfg.frontend_len != cfg.encoder_seq:
            print(f"  {cfg.name} (reduced): frontend_len {cfg.frontend_len} "
                  f"-> encoder_seq {cfg.encoder_seq} (the frames fill the "
                  f"cross rows)")
            cfg = cfg.scaled(frontend_len=cfg.encoder_seq)
        params = build_model(cfg).init(0, device)
        reps = [ReplicaEngine(cfg, params, n_slots=args.slots,
                              max_ctx=max_ctx, replica_id=i, role=role)
                for i, role in enumerate(engine_roles(args.scheduler))]
        srv = EngineServer(make_scheduler(args.scheduler), reps,
                           rotation=not args.no_rotation,
                           prefill_mode=args.prefill_mode)
        if args.scenario:
            from repro_torch.traces import make_scenario
            trace = make_scenario(args.scenario, args.n_conversations,
                                  seed=args.seed, scale="engine")
        else:
            trace = engine_trace(args.n_conversations)
        _drive(srv, trace, gateway=args.gateway)
        return

    if args.sim:
        from repro_torch.cluster import paper_deployment
        from repro_torch.traces import TraceConfig, generate_trace

        sim = paper_deployment(args.scheduler)
        if args.scenario:
            from repro_torch.traces import make_scenario
            trace = make_scenario(args.scenario, args.n_conversations,
                                  seed=args.seed, scale="paper")
        else:
            trace = generate_trace(args.n_conversations, 1.634,
                                   TraceConfig(seed=17))
        _drive(sim, trace, gateway=args.gateway)
        return

    from repro_torch.launch.dryrun import estimate_cell
    from repro_torch.launch.mesh import make_production_mesh, world, \
        world_size

    if args.device not in ("cuda", "meta"):
        ap.error("the production-mesh dry run runs on --device cuda or meta")
    with world(world_size(multi_pod=args.multi_pod)):
        mesh = make_production_mesh(multi_pod=args.multi_pod, device="meta")
        for name in ("prefill_32k", "decode_32k"):
            counts = estimate_cell(args.arch, name, mesh, None, args.device,
                                   args.multi_pod)
            print(f"{name}: traced OK on {tuple(mesh.shape)}; "
                  f"{counts['memory']}")


if __name__ == "__main__":
    main()
