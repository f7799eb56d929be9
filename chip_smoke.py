#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main path — ConServe serving qwen3-0.6b at full width
through `ReplicaEngine`, `EngineServer` and `make_scheduler("conserve")` —
and holds each hand-written CUDA kernel of that path against its plain
PyTorch version on the card. Phases, each raising on failure:

  1. the card: CUDA present, `nvidia-smi` name and power limit;
  2. build: every kernel from `src/repro_torch/kernels/csrc`, one nvcc per
     source started together, with the seconds and `-Xptxas -v`;
  3. kernels: K1 (flash-decode) and K2 (flash-prefill) against their plain
     versions in fp32 (TF32 off) and bf16 at the main path's shapes, with
     kernel, plain and library (SDPA, timed only) milliseconds from CUDA
     events after a warm-up, and each kernel's bound from its shapes;
  4. full-width qwen3-0.6b in fp32 from a seeded torch init: prefill and a
     short decode rollout with attention_impl "cuda" and "torch" — logits
     within tolerance, greedy tokens equal;
  5. full-width qwen3-0.6b in bf16 served with strict accounting: (a) the
     golden-trace setup, whose summary must equal
     tests/golden/decode_golden_trace.json exactly; (b) the main path, one
     prefiller + two decoders on 8 conversations of the launcher's engine
     trace — all complete, one KV transfer per conversation, both kernels'
     launch counters > 0 (counted from 0 over this run alone).

The last three lines of standard output are the card's name and power
limit, one JSON object with a record per kernel, and
`{"ok": true, "device": {...}}`. Without a card, or without the repository
around it, it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "golden" / "decode_golden_trace.json"

HBM_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 CUDA cores; bf16 dense tensor
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_TOL = 1e-3               # fp32 full-width logits, cuda vs torch impl


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# timing helpers
# --------------------------------------------------------------------------- #
def cuda_ms(fn, warmup: int = 5, iters: int = 20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
def check_decode(torch, dtype, B, S_buf, S, H, Hkv, D, lens, seed=0):
    """K1 on a cache view trimmed from S_buf to S positions (batch stride of
    the full buffer, as the engine passes it), with the new token as the
    second branch. Returns (err, kernel_ms, plain_ms, library_ms, bound)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                      flash_decode_attention)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    rnd = lambda *s: (torch.randn(*s, generator=g, device="cuda") * 0.6).to(dt)  # noqa: E731
    q = rnd(B, H, D)
    kb, vb = rnd(B, S_buf, Hkv, D), rnd(B, S_buf, Hkv, D)
    k, v = kb[:, :S], vb[:, :S]
    kn, vn = rnd(B, Hkv, D), rnd(B, Hkv, D)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = flash_decode_attention(q, k, v, lengths, kn, vn)
    want = decode_attention_plain(q, k, v, lengths, kn, vn)
    torch.cuda.synchronize()
    err = max_err(got, want)
    if not err < TOL[dtype]:
        raise AssertionError(f"K1 {dtype} B={B} S={S} lens={lens}: "
                             f"max|err| {err} >= {TOL[dtype]}")
    assert ops.decode_attention(q, k, v, lengths, impl="cuda", k_new=kn,
                                v_new=vn).shape == q.shape
    k_ms = cuda_ms(lambda: flash_decode_attention(q, k, v, lengths, kn, vn))
    p_ms = cuda_ms(lambda: decode_attention_plain(q, k, v, lengths, kn, vn))
    # yardstick: one SDPA call over the same live keys (KV heads expanded
    # and the new token appended before timing; a boolean length mask)
    G = H // Hkv
    kc = torch.cat([k, kn[:, None]], 1).repeat_interleave(G, 2).transpose(1, 2)
    vc = torch.cat([v, vn[:, None]], 1).repeat_interleave(G, 2).transpose(1, 2)
    live = lengths.clamp(max=S)
    pos = torch.arange(S + 1, device="cuda")
    mask = ((pos[None] < live[:, None]) | (pos[None] == S))[:, None, None]
    q4 = q[:, :, None]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask))
    live_keys = int(live.sum()) + B
    isz = torch.finfo(dt).bits // 8
    nbytes = (2 * B * H * D + 2 * live_keys * Hkv * D) * isz + 4 * B
    flops = 4.0 * live_keys * H * D
    return err, k_ms, p_ms, lib_ms, bound_ms(nbytes, flops, dtype)


def check_prefill(torch, dtype, B, S, H, Hkv, D, window, seed=0):
    """K2 at one turn-1 shape. Returns (err, kernel_ms, plain_ms,
    library_ms, bound)."""
    import torch.nn.functional as F
    from repro_torch.kernels.prefill_attention import (flash_prefill_attention,
                                                       prefill_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    rnd = lambda *s: (torch.randn(*s, generator=g, device="cuda") * 0.6).to(dt)  # noqa: E731
    q, k, v = rnd(B, S, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    got = flash_prefill_attention(q, k, v, window=window)
    want = prefill_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    err = max_err(got, want)
    if not err < TOL[dtype]:
        raise AssertionError(f"K2 {dtype} B={B} S={S} window={window}: "
                             f"max|err| {err} >= {TOL[dtype]}")
    k_ms = cuda_ms(lambda: flash_prefill_attention(q, k, v, window=window))
    p_ms = cuda_ms(lambda: prefill_attention_plain(q, k, v, window=window))
    G = H // Hkv
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, 2).transpose(1, 2)
    vt = v.repeat_interleave(G, 2).transpose(1, 2)
    if window:
        i = torch.arange(S, device="cuda")
        wmask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,  # noqa: E731
                                                     attn_mask=wmask)
    else:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,  # noqa: E731
                                                     is_causal=True)
    lib_ms = cuda_ms(lib)
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    isz = torch.finfo(dt).bits // 8
    nbytes = B * S * (2 * H + 2 * Hkv) * D * isz
    flops = 4.0 * B * H * pairs * D
    return err, k_ms, p_ms, lib_ms, bound_ms(nbytes, flops, dtype)


def phase_kernels(torch, cfg):
    """K1 and K2 at the main path's shapes in fp32 and bf16. Returns the
    bf16 records at the shapes the served path runs most."""
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase 3: kernels vs plain versions (TF32 off; fp32 tol 2e-5, "
        "bf16 tol 2e-2)")
    recs = {}
    # decode: 16 slots of a max_ctx=1024 buffer read through ctx buckets;
    # lengths include 1, exactly S, and an idle slot longer than S
    dec_cases = []
    for S in (64, 256, 1024):
        lens = [1, S, S - 1, max(1, S // 2), 3 * S // 4, 5, S // 3 + 1, S]
        lens += [min(2 * S, 1024) if S < 1024 else 1024, 17 % S + 1,
                 S // 5 + 2, 1, S, 2, S // 2 + 3, 7]
        dec_cases.append((16, 1024, S, lens))
    for dtype in ("float32", "bfloat16"):
        for B, S_buf, S, lens in dec_cases:
            err, k_ms, p_ms, l_ms, (bms, by) = check_decode(
                torch, dtype, B, S_buf, S, H, Hkv, D, lens)
            log(f"  K1 {dtype:8s} B={B} S={S:4d}: max|err| {err:.3e}  "
                f"kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  library "
                f"{l_ms:.4f} ms  bound {bms:.5f} ms ({by})")
            if dtype == "bfloat16" and S == 256:
                recs["decode_attention"] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                    bound_ms=bms, bound_by=by)
    pre_cases = [(1, 64, 0), (1, 200, 0), (1, 512, 0), (1, 1024, 0),
                 (2, 256, 96)]
    for dtype in ("float32", "bfloat16"):
        for B, S, window in pre_cases:
            err, k_ms, p_ms, l_ms, (bms, by) = check_prefill(
                torch, dtype, B, S, H, Hkv, D, window)
            log(f"  K2 {dtype:8s} B={B} S={S:4d} window={window:3d}: "
                f"max|err| {err:.3e}  kernel {k_ms:.4f} ms  plain "
                f"{p_ms:.4f} ms  library {l_ms:.4f} ms  bound {bms:.5f} ms "
                f"({by})")
            if dtype == "bfloat16" and S == 512 and not window:
                recs["prefill_attention"] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                    bound_ms=bms, bound_by=by)
    return recs


# --------------------------------------------------------------------------- #
# phase 4: full-width fp32, cuda vs torch attention
# --------------------------------------------------------------------------- #
def phase_fp32_parity(torch, cfg, device, n_decode=8):
    import numpy as np
    from repro_torch.engine import ReplicaEngine
    from repro_torch.models import build_model
    cfg = cfg.scaled(dtype="float32")
    log(f"phase 4: {cfg.name} full width fp32 ({cfg.n_layers} layers), "
        f"attention_impl cuda vs torch")
    model = build_model(cfg)
    params = model.init(0, device)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, 300)
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=device)[None]
    logits, caches = {}, {}
    for impl in ("cuda", "torch"):
        logits[impl], caches[impl] = model.prefill(params, toks,
                                                   attention_impl=impl)
    err_p = max_err(logits["cuda"], logits["torch"])
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device=device)
    nxt = logits["torch"][:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    cache = {k: {kk: {n: torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, 64)) for n, t in vv.items()}
        for kk, vv in v.items()} for k, v in caches["torch"].items()}
    dl = {impl: model.decode_step(params, nxt, cache, pos, kv_lens=pos,
                                  attention_impl=impl)[0]
          for impl in ("cuda", "torch")}
    err_d = max_err(dl["cuda"], dl["torch"])
    log(f"  logits max|err| prefill {err_p:.3e}, decode {err_d:.3e} "
        f"(tol {LOGIT_TOL})")
    if not (err_p < LOGIT_TOL and err_d < LOGIT_TOL):
        raise AssertionError("fp32 logits differ between attention impls")
    streams = {}
    for impl in ("cuda", "torch"):
        eng = ReplicaEngine(cfg, params, n_slots=2, max_ctx=512,
                            attention_impl=impl)
        s = eng.kv.acquire()
        t, _ = eng.prefill_conversation(s, prompt)
        nt = np.zeros(2, np.int32)
        em = np.zeros(2, bool)
        nt[s], em[s] = int(t), True
        seq, _ = eng.decode_steps(nt, em, n_decode)
        streams[impl] = [int(t)] + [int(x) for x in seq[:, s]]
    log(f"  greedy tokens cuda  {streams['cuda']}")
    log(f"  greedy tokens torch {streams['torch']}")
    if streams["cuda"] != streams["torch"]:
        raise AssertionError("greedy tokens differ between attention impls")
    del params, caches, cache
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phase 5: serving
# --------------------------------------------------------------------------- #
def golden_summary(cfg, params, device):
    """The golden-trace setup of tests/test_golden_trace.py on the port."""
    from repro_torch.core import make_scheduler
    from repro_torch.engine import EngineServer, ReplicaEngine
    from repro_torch.traces import TraceConfig, generate_trace
    trace_cfg = TraceConfig(seed=7, first_input_median=40,
                            first_input_sigma=0.3, first_input_max=80,
                            append_median=10, append_sigma=0.3,
                            append_max=20, output_median=6,
                            output_sigma=0.8, output_max=20, mean_turns=2.0,
                            max_turns=3, tool_mean_s=0.0)
    rep = ReplicaEngine(cfg, params, n_slots=8, max_ctx=256, replica_id=0,
                        role="mixed")
    srv = EngineServer(make_scheduler("conserve"), [rep],
                       decode_mode="fused", record_tokens=True,
                       strict_accounting=True)
    finish_order = []
    orig = srv._finish_turn

    def spy(task, t):
        finish_order.append([task.conv.cid, task.turn_idx])
        return orig(task, t)

    srv._finish_turn = spy
    trace = generate_trace(5, 1e9, cfg=trace_cfg,
                           arrival_process="saturation")
    recs = {r.cid: r for r in srv.serve(trace)}
    return {
        "finish_order": finish_order,
        "conversations": {
            str(cid): {
                "turn_output_tokens": [t.n_output_tokens
                                       for t in recs[cid].turns],
                "turn_order": [t.turn_idx for t in recs[cid].turns],
                "n_kv_transfers": recs[cid].n_kv_transfers,
                "n_remote_turns": recs[cid].n_remote_turns,
            } for cid in sorted(recs)},
        "stream_lengths": {f"{cid}:{turn}": len(toks) for (cid, turn), toks
                           in sorted(srv.sampled_tokens.items())},
    }


def serve_main_path(cfg, params, n_conversations=8, n_slots=16,
                    max_ctx=1024):
    """1 prefiller + 2 decoders under ConServe on the launcher's engine
    trace. Returns (summary, replicas)."""
    from repro_torch.core import make_scheduler
    from repro_torch.core.metrics import summarize
    from repro_torch.engine import EngineServer, ReplicaEngine
    from repro_torch.launch.serve import engine_trace
    reps = [ReplicaEngine(cfg, params, n_slots=n_slots, max_ctx=max_ctx,
                          replica_id=i, role="prefill" if i == 0 else "decode",
                          attention_impl="cuda") for i in range(3)]
    srv = EngineServer(make_scheduler("conserve"), reps,
                       strict_accounting=True)
    recs = srv.serve(engine_trace(n_conversations))
    s = summarize(recs)
    if s["n_conversations"] != n_conversations:
        raise AssertionError(f"{s['n_conversations']} of {n_conversations} "
                             "conversations completed")
    if s["kv_transfers_per_conv"] != 1.0:
        raise AssertionError(f"kv_transfers_per_conv "
                             f"{s['kv_transfers_per_conv']} != 1.0")
    srv.check_accounting()
    for r in reps:
        if r.kv.active.any() or r.kv.active_kv_tokens:
            raise AssertionError(f"replica {r.replica_id} did not drain")
    return s, reps


def phase_serve(torch, cfg, device, card):
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    log(f"phase 5: {cfg.name} full width {cfg.dtype}, EngineServer + "
        f"ConServe, strict accounting")
    params = build_model(cfg).init(0, device)
    golden = json.loads(GOLDEN.read_text())
    got = golden_summary(cfg, params, device)
    if got != golden:
        raise AssertionError("golden-trace summary differs from "
                             f"{GOLDEN.relative_to(ROOT)}")
    log("  (a) golden-trace summary equals tests/golden/"
        "decode_golden_trace.json")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    s, reps = serve_main_path(cfg, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    pre_tok = sum(r.n_prefill_tokens for r in reps)
    pre_s = sum(r.prefill_s for r in reps)
    dec_tok = sum(r.n_decode_tokens for r in reps)
    dec_s = sum(r.decode_s for r in reps)
    log(f"  (b) 1 prefiller + 2 decoders, {s['n_conversations']} "
        f"conversations, kv_transfers_per_conv "
        f"{s['kv_transfers_per_conv']}, wall {wall:.2f} s, launches "
        f"{launches}")
    log(f"  [{card}] ttfet_p95 {s['ttfet_p95']:.4f} s, last_tbt_gmean "
        f"{s['last_tbt_gmean'] * 1e3:.3f} ms, last_tbt_p95 "
        f"{s['last_tbt_p95'] * 1e3:.3f} ms, prefill {pre_tok / pre_s:.1f} "
        f"tok/s ({pre_tok} tok), decode {dec_tok / dec_s:.1f} tok/s "
        f"({dec_tok} tok), peak device memory {peak:.3f} GiB, kernel "
        f"build charged to compile_s {sum(r.compile_s for r in reps):.3f} s")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch next to {Path(__file__).name}"
              " — run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import os
    build = ROOT / "build" / "chip_smoke_kernels"
    shutil.rmtree(build, ignore_errors=True)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build)

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    device = torch.device("cuda")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"phase 2: built {len(_build.SOURCES)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, text in _build.BUILD_LOG.items():
        for line in text.strip().splitlines():
            log(f"  [{name}] {line.strip()}")
    _build.ensure_built()

    cfg = get_config("qwen3-0.6b")
    recs = phase_kernels(torch, cfg)
    phase_fp32_parity(torch, cfg, device)
    launches = phase_serve(torch, cfg, device, card)

    sources = {"decode_attention": "src/repro_torch/kernels/csrc/"
                                   "decode_attention.cu",
               "prefill_attention": "src/repro_torch/kernels/csrc/"
                                    "prefill_attention.cu"}
    replaces = {"decode_attention": "src/repro/kernels/decode_attention.py:69",
                "prefill_attention":
                    "src/repro/kernels/prefill_attention.py:71"}
    kernels = [dict(name=n, route="cuda", source=sources[n],
                    replaces=replaces[n], launches=launches[n], **recs[n])
               for n in ("decode_attention", "prefill_attention")]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
