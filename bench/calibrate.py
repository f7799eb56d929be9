#!/usr/bin/env python3
"""Calibration of a cell, run once when the cell is defined; the
benchmark's own runs never call it.

    python3 bench/calibrate.py --workload <cell> --rates 0.5,0.57,0.65 \
        --sweep-fill 25 --sweep-seconds 25 --sustained 0.45 --seeds 1,2,3

One process builds the deployment once (kernels, replicas, every program
that any round reaches) and then serves a fresh server over the same
replicas in each round, their slots emptied between rounds:

* the knee: the cell's traffic at each offered rate (arrivals a logical
  second) for a fill and a logical window, printing the admission backlog
  at the window's start and end and the admission waits of the window's
  first and last third of arrivals. The knee is the highest rate whose
  backlog does not grow, with every lower rate's (`--sustained` is a
  rate already known to hold); the cell's rate is four fifths of it
  (`--rate` gives it instead, and `--rates ''` skips the sweep).
* the seeds: for each seed, the cell at that rate as `run.py` serves it
  (the mix's fill and the window of `run_seconds`), the weights of that
  seed written into the replicas' own. The end-to-end metrics of each
  are printed. Then its sample is judged as `run.py` judges it, and the
  control (the reference computed in float8, weights and matrix-product
  inputs, choosing the tokens at the same positions) is read on the same sample and put through the same
  `check.compare`; where the card cannot hold the reference beside the
  idle replicas, that seed is judged once they are freed. The process
  exits 5 if a control run comes out correct.

Each round prints one JSON line; the last line summarises.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (bench/run.py: paths and caches)


def grows(row) -> bool:
    """A growing admission backlog: two or more parked at the window's end
    than at its start (one is a slot that is about to free), the last
    third of its arrivals waiting a second or more longer than the first
    third did, or parked bindings that filled the card."""
    if row.get("oom"):
        return True
    parked = lambda k: sum(q for _, q in row["occupancy"][k].values())  # noqa: E731
    return (parked("end") >= parked("start") + 2
            or row["wait_last_third_s"] > row["wait_first_third_s"] + 1.0)


def knee_of(rows, sustained: float) -> float:
    knee = sustained
    for row in sorted(rows, key=lambda r: r["rate"]):
        if grows(row):
            break
        knee = row["rate"]
    return knee


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--sweep-fill", type=float, default=25.0)
    ap.add_argument("--sweep-seconds", type=float, default=25.0)
    ap.add_argument("--sustained", type=float, default=0.0)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window's logical seconds (default: run_seconds)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.set_paths()
    import numpy as np
    import torch

    from bench.harness import check, drive, spec, stats, system, traffic, \
        weights
    bench = spec.load_json(run.ROOT / "BENCHMARK.json")
    found = spec.find_cell(bench, run.ROOT, args.workload)
    conf, mix = found["conf"], found["mix"]
    m, dep = conf["model"], conf["deployment"]
    fill = mix["fill_s"]
    seconds = args.seconds if args.seconds is not None else bench["run_seconds"]
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    rates = [float(r) for r in args.rates.split(",") if r]
    seeds = [int(s) for s in args.seeds.split(",") if s]

    def emit(row):
        print(json.dumps(row), flush=True)

    def free():
        gc.collect()             # the server's cycles hold parked packages
        if cuda:
            torch.cuda.empty_cache()

    if cuda and conf["engine"]["attention_impl"] == "cuda":
        from repro_torch.kernels import _build
        _build.ensure_built()
    w = weights.make(m, seeds[0] if seeds else 1, dev)
    lm = system.hand_over(system.model_config(
        m, mix["serving"]["kv_cache_dtype"]), w)
    reps = system.replicas(conf, mix, lm)
    # every program any round reaches: the sweep's rates, and the cell at
    # four fifths of each rate the knee can be
    cands = ([args.rate] if args.rate is not None else
             sorted({round(0.8 * r, 2) for r in rates + [args.sustained]
                     if r > 0} | ({mix["rate_conv_per_s"]} if not rates
                                  else set())))
    keys = {"prefill": set(), "append": set(), "decode": set()}
    for r, until in ([(r, args.sweep_fill + args.sweep_seconds)
                      for r in rates] + [(r, fill + seconds) for r in cands]):
        shapes = traffic.build(dict(mix, rate_conv_per_s=r),
                               dep["max_ctx"])[0]
        for k, v in system.warm_keys(shapes, dep["max_ctx"], until).items():
            keys[k] |= set(v)
    keys = {k: sorted(v, reverse=True) for k, v in keys.items()}
    t = time.perf_counter()
    system.warm_programs(reps, keys)
    run.log(f"warmed {sum(len(r.programs()) for r in reps)} programs in "
            f"{time.perf_counter() - t:.1f} s for rates {rates} and {cands}")
    free()

    def serve(rate, seed, fill_s, window_s, drain: bool):
        mx = dict(mix, rate_conv_per_s=rate)
        shapes, n_cut = traffic.build(mx, dep["max_ctx"])
        srv = system.server(conf, mx, reps, seed)
        client = drive.Client(srv)
        t0 = time.perf_counter()
        win = drive.serve(srv, reps, shapes, fill_s, window_s,
                          t0 + run.RUN_LIMIT_S, client, drain=drain)
        done = [s for s in win.shapes if s.cid not in set(win.unfinished)]
        e2e = (stats.conversation_metrics([client.timeline(s) for s in done])
               if done else {})
        waits = [srv.queue_waits()[s.cid] for s in win.shapes]
        third = max(len(waits) // 3, 1)
        row = {"rate": rate, "seed": seed, "n_window": len(win.shapes),
               "unfinished": len(win.unfinished), "cut": n_cut,
               "logical_window_s": list(win.logical),
               "fill_wall_s": win.setup_end - t0, "wall_s": win.wall_s,
               "drain_s": win.drain_s, "occupancy": win.occupancy,
               "captures": win.captures,
               "admission_wait_p95_s": stats.p95(waits),
               "wait_first_third_s": float(np.mean(waits[:third]))
               if waits else 0.0,
               "wait_last_third_s": float(np.mean(waits[-third:]))
               if waits else 0.0,
               "output_tok_per_s": win.tokens / win.wall_s, **e2e}
        sample = check.pick(done, seed, conf["check"]["min_served_tokens"],
                            conf["check"]["max_conversations"])
        streams = {s.cid: [client.stream(s.cid, i)
                           for i in range(len(s.turns))] for s in sample}
        for rep in reps:
            rep.kv.invalidate_all()
        del srv, client, win
        free()
        return row, sample, streams

    sweep = []
    for r in rates:
        try:
            row = serve(r, seeds[0] if seeds else 1, args.sweep_fill,
                        args.sweep_seconds, False)[0]
        except torch.cuda.OutOfMemoryError:
            # the parked bindings (each an exported slot) filled the card
            for rep in reps:
                rep.kv.invalidate_all()
            free()
            row = {"rate": r, "oom": True}
        row["grows"] = grows(row)
        sweep.append(row)
        emit({"sweep": row})
        if row.get("oom"):
            break
    knee = knee_of(sweep, args.sustained) if rates else None
    rate = (args.rate if args.rate is not None else
            round(0.8 * knee, 2) if rates else mix["rate_conv_per_s"])
    emit({"knee": knee, "rate": rate})

    out, ctl_correct, later = [], [], []

    def judge(seed, row, sample, streams, ws):
        judged = check.judge(conf, ws, seed, sample, streams, dev,
                             control=True)
        prog = check.compare(conf["check"], judged, row["unfinished"])
        ctl = check.compare(conf["check"], {**judged, **judged["control"]},
                            row["unfinished"])
        res = {"seed": seed, "program": {k: judged[k] for k in (
            "miss_share", "logit_gap", "mean_gap", "n_tokens")},
            "control": judged["control"], "program_correct":
            check.passes(prog), "control_correct": check.passes(ctl)}
        ctl_correct.append(res["control_correct"])
        out.append(res)
        emit({"judged": res})

    current = seeds[0] if seeds else None
    for seed in seeds:
        if seed != current:
            with torch.no_grad():
                for k, v in weights.make(m, seed, dev).items():
                    w[k].copy_(v)
            current = seed
            free()
        row, sample, streams = serve(rate, seed, fill, seconds, True)
        emit({"served": row})
        try:        # beside the idle replicas, if the card holds both
            judge(seed, row, sample, streams, w)
        except torch.cuda.OutOfMemoryError:
            free()
            later.append((seed, row, sample, streams))

    del reps, lm, w
    free()
    for seed, row, sample, streams in later:
        judge(seed, row, sample, streams, weights.make(m, seed, dev))
        free()
    summary = {"knee": knee, "rate": rate,
               "seconds": time.perf_counter() - T_START}
    for k in ("miss_share", "logit_gap", "mean_gap"):
        if out:
            summary[k] = {"program_max": max(r["program"][k] for r in out),
                          "control_min": min(r["control"][k] for r in out)}
    emit({"summary": summary})
    if any(ctl_correct):
        print("a control run came out correct", file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
