#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (counted in setup_s): the kernels
loaded or built, the weights made on the card from the seed, the
deployment's replicas and server built, every program the cell's traffic
reaches captured, and the cell's open-loop arrivals served until the
server's logical clock reaches the mix's fill. The window is the next
`--seconds` of that clock, with arrivals continuing: the conversations
that arrive in it are measured, whatever the program's speed. Then the
arrivals stop and those conversations drain, the program is freed, and a
sample of what it served is judged against the plain reference. The last line of standard output is
the result as one JSON object; its "compared" key, last, holds each number
compared beside its limit, which are also the last lines of standard
error. With --trace 1 the metrics are the cell's per-layer metrics, read
from the benchmark's spans, the program's counters and a profiled
sub-window of the device trace.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
RUN_LIMIT_S = 360.0
CHECK_RESERVE_S = 25.0     # the drain stops this long before the limit
PROFILE_AFTER_S = 10.0     # the profiled sub-window starts at a turn-1
PROFILE_S = 1.5            # prefill this far (wall) into the window, and lasts
PROFILE_MAX_S = 3.5        # this long, or until it holds PROFILE_DECODES
PROFILE_DECODES = 3        # decode calls, up to PROFILE_MAX_S


def set_paths():
    """The program and the benchmark on the path, and every build cache of
    the program at a fixed directory inside the checkout."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def log(msg: str):
    print(f"[{time.perf_counter() - T_START:8.2f}s] {msg}", file=sys.stderr,
          flush=True)


def forbidden_modules():
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def run(found, bench, seed: int, seconds: float, trace: bool, device: str,
        root: Path = ROOT, t_start: float = T_START, control: bool = False):
    """One run of a found cell on `device`; returns the result dict. With
    `control` (calibration only) the judge also reads the control's
    numbers on the same sample, into the result's detail."""
    import torch

    from bench.harness import check, drive, profile, spec, stats, system, \
        traffic, weights
    from bench.harness import counts as counts_mod

    conf, mix, cell = found["conf"], found["mix"], found["cell"]
    m, dep = conf["model"], conf["deployment"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    parts = {}

    t = time.perf_counter()
    if cuda and conf["engine"]["attention_impl"] == "cuda":
        from repro_torch.kernels import _build
        _build.ensure_built()
    parts["kernels_s"] = time.perf_counter() - t
    shapes, n_cut = traffic.build(mix, dep["max_ctx"])

    t = time.perf_counter()
    w = weights.make(m, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    parts["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    cfg = system.model_config(m, mix["serving"]["kv_cache_dtype"])
    lm = system.hand_over(cfg, w)
    srv, reps = system.build(conf, mix, lm, seed)
    parts["build_s"] = time.perf_counter() - t
    log(f"built {len(reps)} replicas, {len(shapes)} conversations "
        f"({n_cut} cut at max_ctx {dep['max_ctx']})")

    t = time.perf_counter()
    took = system.warm(reps, shapes, dep["max_ctx"], mix["fill_s"] + seconds)
    parts["warm_s"] = time.perf_counter() - t
    warm_by_kind = {}
    for dt, _, kind, _ in took:
        warm_by_kind[kind] = warm_by_kind.get(kind, 0.0) + dt
    log(f"warm-up by kind (s): {warm_by_kind}; slowest: "
        f"{[(round(dt, 2), rid, kind, key) for dt, rid, kind, key in sorted(took, reverse=True)[:6]]}")
    log(f"warmed {sum(len(r.programs()) for r in reps)} programs in "
        f"{parts['warm_s']:.1f} s; graph pools "
        f"{[r.graph_pool_bytes() for r in reps]} B"
        + (f"; allocated {torch.cuda.memory_allocated(dev)} B, reserved "
           f"{torch.cuda.memory_reserved(dev)} B" if cuda else ""))

    client = drive.Client(srv)
    spans = prof = None
    if trace:
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with torch.profiler.profile(activities=acts):   # start-up cost
            torch.ones(8, device=dev).sum().item()
        prof = torch.profiler.profile(activities=acts)
        spans = drive.Spans(reps)

    t = time.perf_counter()
    # a first run's kernel build is not held to the limit
    drain_until = t_start + parts["kernels_s"] + RUN_LIMIT_S - CHECK_RESERVE_S
    win = drive.serve(srv, reps, shapes, mix["fill_s"], seconds,
                      drain_until, client, spans,
                      prof, min(PROFILE_AFTER_S, seconds / 4), PROFILE_S,
                      profile_max_s=PROFILE_MAX_S,
                      profile_decodes=PROFILE_DECODES)
    parts["fill_s"] = win.setup_end - t
    setup_s = win.setup_end - t_start
    log(f"window: {win.wall_s:.2f} s wall, logical {win.logical[0]:.2f} -> "
        f"{win.logical[1]:.2f} s, {len(win.shapes)} conversations arrived, "
        f"{win.tokens} tokens streamed; drain {win.drain_s:.2f} s, "
        f"{len(win.unfinished)} unfinished")
    log(f"compute charged to the logical clocks in the window: "
        f"{win.compute_s:.3f} s over {win.wall_s:.3f} s of wall; "
        f"captures in the window {win.captures} ({win.compile_s:.3f} s)")

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    done = [s for s in win.shapes if s.cid not in set(win.unfinished)]
    e2e = stats.conversation_metrics([client.timeline(s) for s in done])
    e2e["output_tok_per_s"] = win.tokens / win.wall_s
    e2e["setup_s"] = setup_s
    waits = srv.queue_waits()

    ctx = None
    if trace:
        t = time.perf_counter()
        tr = (profile.read(prof, win.profile_s) if win.profile_s > 0
              else None)
        log(f"profiled {win.profile_s:.3f} s, calls "
            f"{spans.n_profiled}; trace read in "
            f"{time.perf_counter() - t:.1f} s")
        window_spans = spans.spans
        charged = sum(sp.dt for sp in window_spans if sp.name in drive.SPANNED)
        host = sum(sp.t1 - sp.t0 for sp in window_spans
                   if sp.name in drive.SPANNED)
        log(f"spans: the replicas charged {charged:.3f} s, the benchmark's "
            f"spans around the same calls took {host:.3f} s")
        ctx = dict(model=m, counts=counts_mod, window=win, spans=window_spans,
                   trace=tr, waits={s.cid: waits[s.cid] for s in win.shapes},
                   peaks=(counts_mod.peaks(torch.cuda.get_device_name(dev))
                          if cuda else None),
                   transfers_per_conv=(sum(srv.records[s.cid].n_kv_transfers
                                           for s in win.shapes)
                                       / max(len(win.shapes), 1)))

    sample = check.pick(done, seed, conf["check"]["min_served_tokens"],
                        conf["check"]["max_conversations"])
    streams = {s.cid: [client.stream(s.cid, i) for i in range(len(s.turns))]
               for s in sample}

    # free the program before the reference runs (the weights stay)
    del srv, reps, lm, client, spans, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    judged = check.judge(conf, w, seed, sample, streams, dev, control)
    log(f"reference: {judged['n_conversations']} conversations, "
        f"{judged['n_tokens']} served tokens, {time.perf_counter() - t:.1f} s")
    del w
    gc.collect()

    if trace:
        metrics = {}
        for pm in spec.per_layer_of(bench, cell["name"]):
            v = spec.reader(root, bench, pm["name"])(ctx)
            if v is not None:
                metrics[pm["name"]] = {"value": float(v), "unit": pm["unit"]}
            else:
                log(f"per-layer metric {pm['name']}: nothing to read")
    else:
        metrics = {n: {"value": float(e2e[n]),
                       "unit": next(x["unit"] for x in bench["end_to_end"]
                                    if x["name"] == n)}
                   for n in spec.reports(bench, cell["name"])}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"attempted": len(win.shapes), "failed": len(win.unfinished),
              "metrics": metrics, "device": device_info}
    if trace and ctx["trace"] is not None:
        tr = ctx["trace"]
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_kernels(),
                               "idle_gaps": tr.idle_gaps()}
    result["detail"] = {
        "setup_parts_s": parts, "warm_s_by_kind": warm_by_kind,
        "window_conversations": len(win.shapes), "cut_conversations": n_cut,
        "logical_window_s": list(win.logical), "drain_s": win.drain_s,
        "captures_in_window": win.captures,
        "occupancy_slots_parked": win.occupancy, "tokens_in_window": win.tokens,
        "n_ttfet": e2e["n_ttfet"], "n_ttft": e2e["n_ttft"],
        "n_tbt": e2e["n_tbt"],
        "judged": {k: judged[k] for k in ("miss_share", "logit_gap",
                                          "mean_gap", "n_tokens")},
        "control": judged.get("control"),
        "medians": {k: e2e[k] for k in ("ttfet_median_s",
                                         "turn_ttft_median_s",
                                         "last_tbt_median_ms")}}
    compared = check.compare(conf["check"], judged, len(win.unfinished))
    ok = check.passes(compared) and all(math.isfinite(x["value"]) for x in metrics.values())
    result["correct"] = bool(ok)
    result["compared"] = compared
    return {"correct": result.pop("correct"), **result}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_paths()
    from bench.harness import spec
    bench = spec.load_json(ROOT / "BENCHMARK.json")
    found = spec.find_cell(bench, ROOT, args.workload)
    import torch
    need = found["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this cell needs {need} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run(found, bench, args.seed, args.seconds, bool(args.trace),
                 "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad} (the port and the benchmark "
              f"may not load JAX or the JAX package)", file=sys.stderr)
        return 4
    for name, v in result["compared"].items():
        rel = ">=" if v.get("at_least") else "<="
        print(f"compared {name}: {v['value']!r} (limit {rel} {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
