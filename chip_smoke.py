#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's served paths — ConServe over `ReplicaEngine`,
`EngineServer` and `make_scheduler("conserve")`, serving qwen3-0.6b,
rwkv6-3b and recurrentgemma-9b at full width — then qwen3-0.6b under the
paper's baselines, through failures and live through the gateway, then the
reference's dense family (olmo-1b, stablelm-12b, nemotron-4-15b, gemma3-12b)
at full width, then its MoE models (deepseek-v2-lite-16b with MLA,
llama4-scout-17b-a16e at the depth that fits), then its vision-frontend
model (internvl2-26b) and its encoder-decoder (whisper-small) at full
width and depth, then trains full-width olmo-1b in bf16 through
`repro_torch.train` (a training step launches no kernel of the port), and
holds each hand-written
CUDA kernel of those paths against its plain PyTorch version on the card.
Every replica runs its decode chunks, turn-1 prefills and appends through
its programs' CUDA graphs (the default), so the launch counts of the served
phases count replays (each replay adds what its capture recorded), and each
served phase prints its compile_s (kernel builds and program captures, never
in a dt), the programs it captured, their graph pools and peak memory beside
TTFET p95 and TBT.
Phases, each raising on failure:

  1. the card: CUDA present, `nvidia-smi` name and power limit;
  2. build: every kernel from `src/repro_torch/kernels/csrc`, one nvcc per
     source started together, with the seconds and `-Xptxas -v`, and the
     count of tensor-core (`HMMA`) instructions in K2's SASS, which must
     not be 0;
  3. kernels: K1 (flash-decode), K2 (flash-prefill) and K2's append
     instance (bf16, within 1% of the largest output of its plain version
     in fp32, on inputs where a fault moves an output by O(1); SDPA on the
     live keys its yardstick) at the qwen path's shapes, K3 (WKV6) at the
     rwkv6 path's, K4 (RG-LRU scan) at the recurrentgemma path's, against
     their plain versions in fp32 (TF32 off) and with bf16 inputs, with
     kernel, plain and library (SDPA for K1/K2, timed only; none for K3
     and K4) milliseconds from CUDA events after a warm-up (the median of
     five windows), the kernel's and the library's
     device time per call (`device_ms`: 20 or more calls captured in one
     CUDA graph and replayed between events, the median of five replays,
     the calls cycling over enough copies of the inputs that each reads
     them from HBM, not from L2), and each kernel's bound from its shapes;
     then, checked but not timed, K3 under strong decay (the full-width
     init's |cum logw|) at its chunk and pass edges for each head size and
     on a strided view, and K4 at its segment and tile edges, at W = 2560
     and 4095, with every mix of input dtypes — each call one launch;
  4. full-width qwen3-0.6b in fp32 from a seeded torch init: prefill and a
     short decode rollout with attention_impl "cuda" and "torch" — logits
     within tolerance, greedy tokens equal, K1 and K2 each launched once
     per layer (28) by one decode step and one prefill;
  5. full-width qwen3-0.6b in bf16 served with strict accounting: (a) the
     golden-trace setup, whose summary must equal
     tests/golden/decode_golden_trace.json exactly; (b) the qwen path, one
     prefiller + two decoders on 8 conversations of the launcher's engine
     trace — all complete, one KV transfer per conversation, K1's and K2's
     launch counters > 0 (counted from 0 over this run alone);
  6. full-width rwkv6-3b in fp32: prefill (WKV in K3 vs `wkv6_chunked`) and
     an 8-step decode under "cuda" and "torch" — logits within tolerance,
     greedy tokens equal, K3 launched once per layer (32) by the prefill,
     and K3 held against the step recurrence on the first layer's own WKV
     inputs (the chunked form's error printed beside it);
  7. full-width rwkv6-3b in bf16: the rwkv6 path, served as in 5b — all
     complete, one state transfer per conversation, K3's counter > 0 and a
     multiple of 32 (counted from 0 over this run alone);
  8. full-width recurrentgemma-9b in fp32: prefill of 300 tokens (the RG-LRU
     recurrence in K4 under "cuda", in the log-depth scan under "torch") and
     decode steps — logits within tolerance, greedy tokens of a
     ReplicaEngine pair equal;
  9. full-width recurrentgemma-9b in bf16: the recurrentgemma path, served
     as in 5b — all complete, one transfer per conversation, K4's counter
     > 0 and a multiple of 26, and K1's and K2's at 0 (its attention layers
     are all local, which the reference, too, runs outside its attention
     kernels);
 10. full-width qwen3-0.6b, the paper's comparison and the failure
     contract, strict accounting, K1's and K2's counters > 0 over each run:
     (a) bf16, phase 5b's trace under ampd, full_disagg (1 prefiller + 2
     decoders) and collocated (3 mixed replicas) beside 5b's conserve —
     all complete and drain, conserve moves KV once with no remote turn,
     full_disagg has remote turns and more transfers, collocated none;
     each run's serving numbers and its count of streams equal to
     conserve's (measured: bf16 rounds the two build orders of a KV
     differently), with the logits at the first differences recomputed;
     (b) fp32 with TF32 off under conserve: failure-free, decoder 1 killed
     as it begins decoding a turn >= 1 (the replay re-prefills completed
     turns), and killed then recovered 0.5 logical s later (it must rejoin
     cold: 0 KV, 0 slots, an EMA of 0, and end ACTIVE) — the streams must
     be byte-identical to the failure-free run's, or at each first
     difference both tokens must lie within twice the two orders' largest
     logit difference of the top logit, in a band of at most 4 tokens
     (each token's rank and gap printed); (c) bf16, the trace live
     through the gateway with decoder 1 killed the same way — all complete,
     the gateway's counts add up, its `recovery` events equal the server's
     recoveries;
 11. the replica's CUDA graphs against the same bodies run eagerly
     (`cuda_graphs=False`), on one cache from one zeroed start, full width:
     12 slots prefilled, a ragged chunk of up to 32 steps, a slot joining
     and an append between chunks, a kill (every slot invalidated, the
     cache kept) and a rejoin whose chunk is captured after it. In fp32
     with TF32 off (11a qwen3-0.6b on phase 4's weights, 11c rwkv6-3b and
     11d recurrentgemma-9b on the first 8 layers of phase 6's and 8's
     seeded weights) the tokens and the
     caches must be byte-identical after every chunk, and each prints a
     16-step chunk's wall time per step, eager against graph, the graph's
     traced device time, the launches per replay, each decode bucket's
     capture seconds,
     the graph pool and peak memory; in bf16 (11b, phase 5's weights) it
     prints the count of equal tokens. Phase 4 also runs qwen3-0.6b's
     graphed turn-1 prefill and appends against the eager fast path (byte-
     identical caches, gated) and `prefill_mode="reference"` (equal tokens,
     gated; each layer's largest cache difference printed);
 12. the dense family, each model at its published widths and freed before
     the next: (a) K1 and K2 at its (H, Hkv, D) — D = 160 (stablelm-12b),
     G = 6 (nemotron-4-15b), D = 240 (gemma3-12b's global layers), G = 1
     (olmo-1b) — against their plain versions as in phase 3, K1 at 16
     slots of a 1024 buffer through the 64, 256 and 1024 buckets, K2 at
     S = 200, 256, 512 and 1024; (b) fp32 with TF32 off, full depth but
     stablelm-12b's at 20 and nemotron-4-15b's at 16 layers
     (`PARITY_LAYERS`; printed): a 150-token prefill
     and a decode step under "cuda" and "torch" — logits within 1e-3 of
     max(1, max|logit|), K1 and K2 each launched once per global layer —
     and 8 greedy decode steps of a ReplicaEngine pair, equal; (c) bf16 at
     full width and depth, served as in 5b — 8 of 8 complete, one KV
     transfer each, K1's launches a positive multiple of the global
     layers, K2's the global layers times the 8 turn-1 prefills, K3 and
     K4 at 0; (d) gemma3-12b, whose pattern differs: phase 11's graph
     against eager check in fp32, at 6 layers (one repetition of its
     pattern; printed). Prints its wall time;
 13. MLA and MoE, each model freed before the next: (a) K1 and K2 at
     llama4-scout's heads (40 / 8 x 128, G = 5) against their plain
     versions as in phase 12 (a), K2 at S = 256 and 512; deepseek-v2-lite-
     16b in fp32 (TF32 off) at 8 layers (printed), (b) at cf = E/K
     (dropless, a check-only cut, as `reduced_config` makes it): in every
     layer, on the
     same inputs, the absorbed MLA decode of 8 tokens within 1e-3 of
     max(1, max|out|) of the expanded form; a 150-token prefill and 8
     greedy decode steps against one expanded prefill of all 158 tokens —
     tokens equal, or within phase 10's tie band where one differs, the
     logits by position printed beside their noise floor with every
     routing difference and its margin — K1-K4 at 0; and (d) at the
     published cf
     1.25, phase 11's graphs against eager, byte-identical (capacity drops
     inside the graphs); (c) deepseek in bf16 at full depth and cf 1.25,
     served as 5b — 8 of 8, one transfer each of 31,104 B x its first
     input's tokens, K1-K4 at 0; llama4-scout-17b-a16e at the depth that
     fits (printed; 107.77 B parameters do not fit one card), (e) bf16
     served as 5b — K1's launches the layers x the graphed decode steps
     (counted from the replays), K2's the layers x 8 turn-1 prefills, one
     transfer each of kv_bytes_per_token x the tokens — and (f) fp32
     parity between the impls as phase 12 (b), with each router's smallest
     top-1 margin and every routing flip between the impls printed. Prints
     its wall time;
 14. the vision frontend and the encoder-decoder, each model freed before
     the next, the stubs fed seeded (numpy) embeddings — the i-th turn-1
     the same ones in the graph and the eager pass — and the server's
     zeros when served: whisper-small (a) K1 and K2 at its heads (12 / 12
     x 64, G = 1) against their plain versions as in phase 12 (a), K2 at S
     = 256 and 512; (b) fp32 at full width (TF32 off): a 150-token prefill
     and a decode step under "cuda" and "torch" — logits within 1e-3 of
     max(1, max|logit|), K1 and K2 each launched once per decoder layer
     (the encoder and every cross-attention are torch ops) — 8 greedy
     steps of a ReplicaEngine pair equal, the slot at the prompt's length
     (F14), the cross rows byte-identical after an append and 16 decode
     steps, and phase 11's graphs against eager, byte-identical; (c) bf16
     served as 5b — 8 of 8, one transfer each of 55,296,000 B of cross rows
     + 36,864 B x its length, K1 = 12 x the graphed decode steps, K2 = 12 x
     8 eager turn-1 prefills — then a 16-slot step, the device time of its
     12 cross-attentions, and an eager 150-token prefill beside the
     encoder alone; internvl2-26b (d) fp32 at 16 layers (printed; 32 fit
     beside phase 11's cache copies): impls as phase 12 (b) and graphs against
     eager, byte-identical, with seeded patches; (e) bf16 at full width and
     depth served as 5b — transfers of 196,608 B x (256 + the first
     input), K1 = 48 x the graphed decode steps, K2 = 48 x 8 graphed
     turn-1 prefills — then a 16-slot step. Prints its wall time;
 15. training (`repro_torch.train`): a grad-requiring call to
     `ops.prefill_attention` raises before it launches; (a) olmo-1b as
     published (16 x 2048, 1,177,026,560 parameters counted as Python
     ints) in bf16 from a seeded torch init, `SyntheticLM` at 8 x 2048,
     grad_accum 2, remat "group": 4 AdamW steps with flash_vjp off (the
     published config) and 4 with it on — each step's loss (finite, the
     last below the first), the first step traced as the warm-up (device
     busy, kernel launches a step), the median of the others' CUDA-event
     times, tokens/s, peak memory and the bound 6 x N x tokens over 989
     TFLOP/s; K1-K4's counters at 0 after every step; (c) the second
     run's bf16 params and AdamW state saved in the reference's format
     and restored bit-exactly, one more step from each with the same loss;
     (b) fp32 with TF32 off at full width and 2 layers: flash_vjp on
     against off (losses within 1e-6, gradients within 1e-5 of each
     leaf's max |g|), grad_accum=2 against the full batch (1e-5), remat
     "group", "layer" and "both" (losses within 1e-5). Prints its wall
     time;
 16. launch and sharding (`repro_torch.launch`): rank 0 of the 16x16
     production mesh, 256 ranks of torch's fake process group (every
     collective a no-op), full width and depth: (a) qwen3-0.6b decode_32k
     (local batch 8, 2,048 KV rows a rank), (b) olmo-1b train_4k with
     flash_vjp, one AdamW step of a local 16 x 4096 tokens at TP 16. Each
     cell's meta estimate (`dryrun.measure`: argument, output and temp
     bytes, per-device and global FLOPs, collectives, local ops), then
     the same program on the card on seeded shards: its argument bytes
     must equal the estimate's exactly, its measured peak is printed
     beside arguments + temp, and (a)'s logits and (b)'s loss must be
     finite. No kernel runs (the serving program passes
     attention_impl="torch"; training launches none). Prints its wall
     time;
 17. the prefix pool, qwen3-0.6b at full width (seeded weights, CUDA
     graphs, TF32 off), a hit folding the pooled preamble rows into the
     slot and replaying the append graph its miss replays: (a) the fleet
     of the reference's benchmarks/prefix_reuse.py (16 conversations
     sharing one 192-token preamble, a 64-token delta each, 4 slots of
     512, a pool of 768 tokens, each slot released after its turn-1) in
     bf16 and fp32, pooled and pool-less (a warm pass and 3 measured ones
     each) and pooled with `cuda_graphs=False` (a warm pass and one
     measured one) — tokens equal pooled vs pool-less, 1 miss + 15 hits
     then 16 hits a pass, K2 28 a miss and 0 a hit, the median hit no
     slower than the median miss; the turn-1 context tokens/s and the
     eager hit's dt printed; (b) fp32, `shared_preamble_fleet(8, seed=0,
     scale="engine")` under ConServe, 1 prefiller + 2 decoders of 16
     slots of 1024, each replica's pool 1024 tokens, one set of replicas
     for three runs: pool off, pool on, and pool on with decoder 1 killed
     as it begins decoding a turn >= 1 (phase 10's trigger) — streams
     byte-identical off vs on, the killed run's equal to the pool-on
     run's by phase 10's rule, the prefiller hit, K2 28 x each turn-1
     prefill the pool did not serve; TTFET, TBT, prefill tokens/s, hits
     and compile_s printed. Prints its wall time;
 18. the quantized decode tail, qwen3-0.6b with `kv_cache_dtype="int8"`
     (rows stored as int8, read as int8 x 0.05), TF32 off: (a) K1 reading
     the int8 cache itself against its plain version (which dequantizes
     first) at 16 slots of a 1024 buffer, the 256 bucket with phase 3's
     lengths, fp32 and bf16 q (tol 2e-5, 2e-2), timed beside its bound
     (the cache at 1 byte an element) and SDPA on the dequantized rows;
     (b) fp32 at full width: one prefill and one decode step under each
     impl, the prefill's rows quantized into the cache, every K1 call
     handed the int8 cache (recorded through `ops`), logits within
     LOGIT_TOL, served greedy tokens equal, then the CUDA graphs against
     the same bodies run eagerly, byte-identical; (c) bf16 served as in
     5b: one transfer a conversation of exactly 57,344 B x its first
     input's tokens under strict accounting, K1 = 28 x the graphed decode
     steps, K2 = 28 x 8, TTFET and TBT printed, the streams equal to 5b's
     counted (quantization changes tokens; not gated). Prints its wall
     time. Its time is paid for by 11c's and 11d's fp32 graph checks,
     cut to 8 layers (`GRAPH_CHECK_LAYERS`), and by keeping (a)'s 64 and
     1024 buckets and (c)'s graphed decode steps behind `--phase18`.

Every log line starts with the seconds since the script began.

Each model is freed before the next is loaded. Phase 15's, 16's, 17's and
18's records are log lines of their own. The last four lines of standard
output are the script's wall time, the card's name and power limit, one JSON object with a record per kernel (K1's and K2's with their
phase-10 launches and, under "phase12", "phase13" and "phase14", each
dense, MoE and frontend model's served launches and, at its heads, the
bf16 records — internvl2-26b's are nemotron-4-15b's, the same 48 / 8 x
128 — and K1's, under "phase18", its int8 instance's bf16 record at the
256 bucket and its launches in 18 (c)), and `{"ok":
true, "device": {...}}`. Without a card, or without the repository around
it, it exits non-zero before printing any result.

    python3 chip_smoke.py --kernels-only

runs phases 1-3 alone and ends with the card line and the kernels' JSON
line (no ok line): the quick way to time the kernels of a tree.

    python3 chip_smoke.py --phase13

runs phases 1-2 and phase 13 alone and ends with the card line and phase
13's records (no ok line).

    python3 chip_smoke.py --phase14

runs phases 1-2 and phase 14 alone and ends with the card line and phase
14's records (no ok line; internvl2-26b's without phase 12's kernel
records).

    python3 chip_smoke.py --phase15

runs phases 1-2 and phase 15 alone and ends with the card line and phase
15's records (no ok line).

    python3 chip_smoke.py --phase16

runs phases 1-2 and phase 16 alone and ends with the card line and phase
16's records (no ok line).

    python3 chip_smoke.py --phase17

runs phases 1-2 and phase 17 alone and ends with the card line and phase
17's records (no ok line).

    python3 chip_smoke.py --phase18

runs phases 1-2, phase 5b's bf16 serve and phase 18 alone, with (a) at
the 64, 256 and 1024 buckets and (c) followed by the graphed decode step
(`step_times`) of a 16-slot replica with the int8 cache and one with the
bf16 cache on the same weights, and ends with the card line and phase 18's
records (no ok line).

    python3 chip_smoke.py --fp32-gaps

builds the kernels, then runs stablelm-12b, internvl2-26b and
nemotron-4-15b in fp32 at the depth that fits under both attention impls
and prints, layer by layer, K2's and the torch path's attention against
float64 on the same inputs and how far the two runs' hidden states have
parted (no ok line).

    python3 chip_smoke.py --rotation-sweep 4,8,16,32

builds the kernels, then serves phase 5b's run once for each
`rotation_min_chunk` given and prints each run's serving numbers (no ok
line).
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "golden" / "decode_golden_trace.json"

HBM_BYTES_S = 3.35e12          # H100 SXM HBM3
L2_BYTES = 50 * 2**20          # H100 SXM L2
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 CUDA cores; bf16 dense tensor
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# K2's append instance: max|err| over max|plain| against the fp32 plain
# version (bf16 output: at most 1/256 of an output; bf16 P: 1/512)
APPEND_RTOL = 1e-2
LOGIT_TOL = 1e-3               # fp32 full-width logits, cuda vs torch impl
# K3 vs its plain version, relative to max(1, max|plain|): both widen bf16
# inputs exactly to fp32 and accumulate in fp32, so only the order of the
# sums differs — but a long prefill whose decay is near 1 grows the state,
# and an absolute bound would tighten with it
WKV_RTOL = 5e-5
# rwkv6-3b fp32 logits, K3 vs `wkv6_chunked`, relative to max(1, max|logit|):
# the chunked path forms its decay factors as exp(cum_t - cum_j) from
# log-decays summed over a 64-step chunk (|cum| reaches 10^2-10^3 at this
# init), so they carry fp32 rounding of ~|cum| * 2^-24 that the serial
# kernel does not; the WKV states differ by ~1e-4 of their magnitude, which
# 32 layers carry into the logits
RWKV_LOGIT_RTOL = 1e-3
# K4 vs its plain version: 1e-5 absolute in fp32 (the reference's
# test_rglru_sweep); with bf16 inputs (widened exactly) 1e-5 relative to
# max(1, max|plain|)
RGLRU_TOL = 1e-5
# recurrentgemma-9b fp32 logits, K4 vs the log-depth scan, relative to
# max(1, max|logit|): the two scans round differently (a serial FMA chain
# against a tree of products), ~1e-7 of the state per layer, which 38
# layers carry into the logits
RG_LOGIT_RTOL = 1e-3


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, after the seconds since the script began
    (where each phase's time goes)."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# timing helpers
# --------------------------------------------------------------------------- #
def cuda_ms(fn, warmup: int = 5, iters: int = 20, windows: int = 5) -> float:
    """Milliseconds per call: CUDA events around `iters` back-to-back calls,
    the median of `windows` such windows. A short kernel ends before the
    host has enqueued the next, so a window that a host stall lands in
    reads several times slower; the median drops it."""
    import statistics

    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def device_ms(make, inputs, nbytes: float, iters: int = 20,
              windows: int = 5) -> float:
    """Device milliseconds per call of `make(*inputs)()`: back-to-back calls
    captured in one CUDA graph, the graph replayed between CUDA events, the
    median of `windows` replays. No host dispatch lands inside a window, so
    this is the device's time even for a kernel shorter than its wrapper's
    host path (which is what `cuda_ms` times there). The calls take in turn
    enough clones of `inputs` that the others move more than twice the L2's
    bytes (`nbytes` a call) between two uses of one, so each call reads its
    inputs from HBM, as `bound_ms` assumes and as the served step does."""
    import statistics

    import torch
    n_copies = 1 + math.ceil(2 * L2_BYTES / nbytes)
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(n_copies - 1)]
    fns = [make(*c) for c in copies]
    calls = n_copies * math.ceil(iters / n_copies)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as PyTorch asks
        for fn in fns[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % n_copies]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph, fns, copies
    return statistics.median(times)


def sass_count(lib, opcode: str) -> int:
    """How many instructions of `opcode` the SASS of a built library holds
    (`cuobjdump -sass`, from the toolkit that holds nvcc)."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return sum(1 for line in sass.splitlines()
               if re.search(rf"\b{opcode}\b", line))


def bound_ms(nbytes: float, flops: float, dtype: str):
    """dtype names the arithmetic's peak rate (fp32 CUDA cores or bf16
    tensor cores)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
def check_decode(torch, dtype, B, S_buf, S, H, Hkv, D, lens, seed=0,
                 kv_scale=None):
    """K1 on a cache view trimmed from S_buf to S positions (batch stride of
    the full buffer, as the engine passes it), with the new token as the
    second branch. With `kv_scale` the cache is int8 (rows of N(0, 0.6)
    through `quantize_kv`'s rounding), read as int8 x kv_scale, q and the
    new token in `dtype`; the plain version dequantizes first, the bound
    counts a cache element as 1 byte, and the yardstick runs on the
    dequantized rows. Returns the kernel's record (`_record`)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                      dequantize,
                                                      flash_decode_attention)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    rnd = lambda *s: (torch.randn(*s, generator=g, device="cuda") * 0.6).to(dt)  # noqa: E731
    q = rnd(B, H, D)
    if kv_scale is None:
        kb, vb = rnd(B, S_buf, Hkv, D), rnd(B, S_buf, Hkv, D)
    else:
        kb, vb = (torch.clamp(torch.round(
            torch.randn(B, S_buf, Hkv, D, generator=g, device="cuda") * 0.6
            / kv_scale), -127, 127).to(torch.int8) for _ in range(2))
    k, v = kb[:, :S], vb[:, :S]
    kn, vn = rnd(B, Hkv, D), rnd(B, Hkv, D)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = flash_decode_attention(q, k, v, lengths, kn, vn, kv_scale)
    want = decode_attention_plain(q, k, v, lengths, kn, vn, kv_scale)
    torch.cuda.synchronize()
    err = max_err(got, want)
    if not err < TOL[dtype]:
        raise AssertionError(f"K1 {k.dtype} cache, {dtype} B={B} S={S} "
                             f"lens={lens}: max|err| {err} >= {TOL[dtype]}")
    assert ops.decode_attention(q, k, v, lengths, impl="cuda", k_new=kn,
                                v_new=vn, kv_scale=kv_scale).shape == q.shape
    live = lengths.clamp(max=S)
    live_keys = int(live.sum()) + B
    isz = torch.finfo(dt).bits // 8
    nbytes = (2 * B * H * D + 2 * B * Hkv * D) * isz \
        + 2 * (live_keys - B) * Hkv * D * k.element_size() + 4 * B
    flops = 4.0 * live_keys * H * D

    def kern(q, kb, vb, kn, vn):
        return lambda: flash_decode_attention(q, kb[:, :S], vb[:, :S],
                                              lengths, kn, vn, kv_scale)
    inputs = (q, kb, vb, kn, vn)
    k_ms, k_dev = cuda_ms(kern(*inputs)), device_ms(kern, inputs, nbytes)
    p_ms = cuda_ms(lambda: decode_attention_plain(q, k, v, lengths, kn, vn,
                                                  kv_scale))
    # yardstick: one SDPA call over the same live keys (dequantized, KV
    # heads expanded and the new token appended before timing; a boolean
    # length mask)
    if kv_scale is not None:
        k, v = (dequantize(t, kv_scale, dt) for t in (k, v))
    G = H // Hkv
    kc = torch.cat([k, kn[:, None]], 1).repeat_interleave(G, 2).transpose(1, 2)
    vc = torch.cat([v, vn[:, None]], 1).repeat_interleave(G, 2).transpose(1, 2)
    pos = torch.arange(S + 1, device="cuda")
    mask = ((pos[None] < live[:, None]) | (pos[None] == S))[:, None, None]
    q4 = q[:, :, None]

    def sdpa(q4, kc, vc):
        return lambda: F.scaled_dot_product_attention(q4, kc, vc,
                                                      attn_mask=mask)
    return _record(err, k_ms, k_dev, p_ms, cuda_ms(sdpa(q4, kc, vc)),
                   device_ms(sdpa, (q4, kc, vc), nbytes),
                   bound_ms(nbytes, flops, dtype))


def _record(err, k_ms, k_dev, p_ms, l_ms, l_dev, bound):
    return dict(max_abs_err=err, ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                library_ms=l_ms, library_device_ms=l_dev, bound_ms=bound[0],
                bound_by=bound[1])


def _times(r) -> str:
    return (f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f})  plain "
            f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms "
            f"(device {r['library_device_ms']:.4f})  bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")


def check_prefill(torch, dtype, B, S, H, Hkv, D, window, seed=0):
    """K2 at one turn-1 shape. Returns the kernel's record (`_record`)."""
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
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    isz = torch.finfo(dt).bits // 8
    nbytes = B * S * (2 * H + 2 * Hkv) * D * isz
    flops = 4.0 * B * H * pairs * D

    def kern(q, k, v):
        return lambda: flash_prefill_attention(q, k, v, window=window)
    k_ms, k_dev = cuda_ms(kern(q, k, v)), device_ms(kern, (q, k, v), nbytes)
    p_ms = cuda_ms(lambda: prefill_attention_plain(q, k, v, window=window))
    G = H // Hkv
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, 2).transpose(1, 2)
    vt = v.repeat_interleave(G, 2).transpose(1, 2)
    i = torch.arange(S, device="cuda")
    wmask = ((i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
             if window else None)

    def sdpa(qt, kt, vt):
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=wmask, is_causal=not window)
    return _record(err, k_ms, k_dev, p_ms, cuda_ms(sdpa(qt, kt, vt)),
                   device_ms(sdpa, (qt, kt, vt), nbytes),
                   bound_ms(nbytes, flops, dtype))


def append_inputs(torch, lens, S, P, H, Hkv, D, seed=0):
    """bf16 inputs of K2's append instance on which its faults show, as in
    tests/test_torch_gpu.py: q at 8 times the keys' scale, so a query's
    scores spread by ~3 and its output lies near one v row, O(1); at each
    live length L, row L - 1 made the best key of query 0's first head and
    row L (where the buffer has one) that of the last query's last head, so
    a row too few or too many moves an output by O(1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: (torch.randn(*s, generator=g, device="cuda") * 0.6).to(torch.bfloat16)  # noqa: E731
    B = len(lens)
    q = rnd(B, S, H, D) * 8
    pk, pv = rnd(B, P, Hkv, D), rnd(B, P, Hkv, D)
    kn, vn = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    gamma = 1.3 / math.sqrt(D)  # a score of ~30 against the spread's ~3
    for b, L in enumerate(lens):
        if L >= 1:
            pk[b, L - 1, 0] = gamma * q[b, 0, 0]
        if L < P:
            pk[b, L, Hkv - 1] = gamma * q[b, S - 1, H - 1]
    return q, pk, pv, kn, vn


def check_append(torch, S, live, P, H, Hkv, D, seed=0):
    """K2's append instance (bf16) at one shape: S new tokens on a prefix
    buffer of P rows, `live` of them live, held within APPEND_RTOL of the
    largest output against the plain version in fp32 on the same bf16
    inputs (`append_inputs`). Returns the kernel's record (`_record`) with
    that relative error, and the error of the path before the kernel (the
    plain version in bf16: fp32 chunks, P·V in fp32) against the same fp32
    plain; the bound counts the live rows and the causal new pairs."""
    import torch.nn.functional as F
    from repro_torch.kernels.prefill_attention import (append_attention_plain,
                                                       flash_append_attention)
    q, pk, pv, kn, vn = append_inputs(torch, (live,), S, P, H, Hkv, D, seed)
    lens = torch.tensor([live], dtype=torch.int32, device="cuda")
    got = flash_append_attention(q, pk, pv, kn, vn, lens)
    want = append_attention_plain(q.float(), pk.float(), pv.float(),
                                  kn.float(), vn.float(), lens)
    before = append_attention_plain(q, pk, pv, kn, vn, lens)
    torch.cuda.synchronize()
    err, scale = max_err(got, want), float(want.abs().max())
    if not err < APPEND_RTOL * scale:
        raise AssertionError(f"K2 append S={S} live={live} P={P}: max|err| "
                             f"{err} >= {APPEND_RTOL} x max|plain| {scale}")
    nbytes = 2 * (2 * (live + S) * Hkv * D + 2 * S * H * D)
    flops = 4.0 * H * D * S * (live + (S + 1) / 2)

    def kern(q, pk, pv, kn, vn):
        return lambda: flash_append_attention(q, pk, pv, kn, vn, lens)
    inputs = (q, pk, pv, kn, vn)
    k_ms, k_dev = cuda_ms(kern(*inputs)), device_ms(kern, inputs, nbytes)
    p_ms = cuda_ms(lambda: append_attention_plain(q, pk, pv, kn, vn, lens),
                   iters=5)
    # yardstick: one SDPA call on the live prefix and the new keys, KV
    # heads expanded before timing, a boolean causal mask on the new keys
    G = H // Hkv
    qt = q.transpose(1, 2)
    kt, vt = (torch.cat([p[:, :live], n], 1).repeat_interleave(G, 2)
              .transpose(1, 2) for p, n in ((pk, kn), (pv, vn)))
    i = torch.arange(S, device="cuda")
    mask = torch.cat([torch.ones(S, live, dtype=torch.bool, device="cuda"),
                      i[None] <= i[:, None]], 1)

    def sdpa(qt, kt, vt):
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
    rec = _record(err, k_ms, k_dev, p_ms, cuda_ms(sdpa(qt, kt, vt)),
                  device_ms(sdpa, (qt, kt, vt), nbytes),
                  bound_ms(nbytes, flops, "bfloat16"))
    rec.update(max_rel_err=err / scale, max_abs_plain=scale,
               before_max_abs_err=max_err(before, want))
    return rec


def _k1_grid(B, Hkv, S, D, kv_itemsize=2, G=1) -> str:
    """The blocks K1 launches at this shape, from the wrapper's planner."""
    from repro_torch.kernels import decode_attention as k1
    n, length = k1.plan_decode_splits(B, Hkv, S, D, kv_itemsize, G)
    return f"grid {n} x {B * Hkv} = {n * B * Hkv} blocks of {length} keys"


def decode_lengths(S: int):
    """16 slots' live lengths at a ctx bucket of S: 1, exactly S, and an
    idle slot longer than S among them."""
    lens = [1, S, S - 1, max(1, S // 2), 3 * S // 4, 5, S // 3 + 1, S]
    return lens + [min(2 * S, 1024) if S < 1024 else 1024, 17 % S + 1,
                   S // 5 + 2, 1, S, 2, S // 2 + 3, 7]


def phase_kernels(torch, cfg):
    """K1 and K2 at the main path's shapes in fp32 and bf16. Returns the
    bf16 records at the shapes the served path runs most."""
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase 3: kernels vs plain versions (TF32 off; fp32 tol 2e-5, "
        "bf16 tol 2e-2; K2's append instance within 1e-2 of max|plain|)")
    recs = {}
    # decode: 16 slots of a max_ctx=1024 buffer read through ctx buckets;
    # lengths include 1, exactly S, and an idle slot longer than S
    dec_cases = [(16, 1024, S, decode_lengths(S)) for S in (64, 256, 1024)]
    for dtype in ("float32", "bfloat16"):
        for B, S_buf, S, lens in dec_cases:
            r = check_decode(torch, dtype, B, S_buf, S, H, Hkv, D, lens)
            log(f"  K1 {dtype:8s} B={B} S={S:4d} {_k1_grid(B, Hkv, S, D)}: "
                f"max|err| {r['max_abs_err']:.3e}  {_times(r)}")
            if dtype == "bfloat16" and S == 256:
                recs["decode_attention"] = r
    pre_cases = [(1, 64, 0), (1, 200, 0), (1, 256, 0), (1, 512, 0),
                 (1, 1024, 0), (2, 256, 96)]
    for dtype in ("float32", "bfloat16"):
        for B, S, window in pre_cases:
            r = check_prefill(torch, dtype, B, S, H, Hkv, D, window)
            log(f"  K2 {dtype:8s} B={B} S={S:4d} window={window:3d}: "
                f"max|err| {r['max_abs_err']:.3e}  {_times(r)}")
            if dtype == "bfloat16" and S == 512 and not window:
                recs["prefill_attention"] = r
    # K2's append instance: the served shape (a 512-token bucket on a
    # 16,384-row prefix), a prefix short of its bucket, a short append
    for S, live, P in ((512, 16384, 16384), (256, 3000, 4096),
                       (15, 777, 1024)):
        r = check_append(torch, S, live, P, H, Hkv, D)
        log(f"  K2 append bfloat16 S={S:4d} live={live:5d} P={P:5d}: "
            f"max|err| {r['max_abs_err']:.3e} ({r['max_rel_err']:.2e} of "
            f"max|plain| {r['max_abs_plain']:.3f}; bf16 plain, the path "
            f"before the kernel: {r['before_max_abs_err']:.3e})  "
            f"{_times(r)}")
        if S == 512:
            recs["append_attention"] = r
    return recs


def wkv6_errors(got, want):
    """(max|err|, the same relative to max(1, max|plain|)) over K3's two
    outputs."""
    err = max(max_err(a, b) for a, b in zip(got, want))
    rel = max(max_err(a, b) / max(1.0, float(b.abs().max()))
              for a, b in zip(got, want))
    return err, rel


def check_wkv6(torch, dtype, B, S, H, hs, n_live=None, seed=0,
               decay_shift=0.0, strided=False, timed=True):
    """K3 at one prefill shape, r, k, v in `dtype`, the rest fp32, with the
    model's distributions (logw = -exp(x + decay_shift), decay in (0, 1);
    a shift of 1.5 gives |cum logw| of ~330 per 64 tokens, as the
    full-width init does). Heads from n_live on are dead pad heads (r
    zeroed, as the model does); `strided` reads r, k, v, logw as head
    slices of wider tensors. One launch a call. Returns (max|err|, the same
    relative to max(1, max|plain|), kernel_ms, kernel device_ms, plain_ms,
    bound), the times None unless `timed`."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    rnd = lambda *s_, sc=0.5: torch.randn(*s_, generator=g,  # noqa: E731
                                          device="cuda") * sc
    r, k, v = (rnd(B, S, H, hs).to(dt) for _ in range(3))
    if n_live is not None:
        r[:, :, n_live:] = 0
    logw = -torch.exp(rnd(B, S, H, hs) + decay_shift)
    if strided:
        r, k, v, logw = (torch.cat([x, x], dim=2)[:, :, 1:H + 1]
                         for x in (r, k, v, logw))
    u, s0 = rnd(H, hs, sc=0.3), rnd(B, H, hs, hs, sc=0.2)
    args = (r, k, v, logw, u, s0)
    before = wkv6_cuda.launches
    got = wkv6_cuda(*args)
    if wkv6_cuda.launches != before + 1:
        raise AssertionError("K3 did not count one launch for one call")
    want = wkv6_plain(*args)
    torch.cuda.synchronize()
    err, rel = wkv6_errors(got, want)
    if not rel < WKV_RTOL:
        raise AssertionError(f"K3 {dtype} B={B} S={S} H={H} hs={hs} shift="
                             f"{decay_shift} strided={strided}: relative "
                             f"max|err| {rel} >= {WKV_RTOL}")
    assert ops.wkv6(*args)[0].shape == (B, S, H, hs)
    if not timed:
        return err, rel, None, None, None, None
    isz = torch.finfo(dt).bits // 8
    n = B * S * H * hs
    nbytes = 3 * n * isz + 2 * 4 * n + 4 * H * hs + 2 * 4 * B * H * hs * hs
    flops = 5.0 * n * hs
    kern = lambda *a: lambda: wkv6_cuda(*a)  # noqa: E731
    k_ms, k_dev = cuda_ms(kern(*args)), device_ms(kern, args, nbytes)
    p_ms = cuda_ms(lambda: wkv6_plain(*args), warmup=1,
                   iters=2 if S > 100 else 10)
    return err, rel, k_ms, k_dev, p_ms, bound_ms(nbytes, flops, "float32")


def phase_wkv6(torch, cfg):
    """K3 at the rwkv6 path's shapes: one sequence of 40 heads of 64 at
    S = 1, 24 (median append), 150 (median first input) and 512; two
    sequences of 200 with the heads padded 40 -> 48. Returns the bf16
    record at S = 150."""
    H, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    log(f"phase 3: K3 (WKV6) vs plain version (relative tol {WKV_RTOL})")
    rec = {}
    for dtype in ("float32", "bfloat16"):
        for B, S, Hk, live in ((1, 1, H, None), (1, 24, H, None),
                               (1, 150, H, None), (1, 512, H, None),
                               (2, 200, 48, H)):
            err, rel, k_ms, k_dev, p_ms, (bms, by) = check_wkv6(
                torch, dtype, B, S, Hk, hs, live)
            log(f"  K3 {dtype:8s} B={B} S={S:4d} H={Hk}: max|err| "
                f"{err:.3e} (relative {rel:.3e})  kernel {k_ms:.4f} ms "
                f"(device {k_dev:.4f})  plain {p_ms:.4f} ms  library none  "
                f"bound {bms:.5f} ms ({by})")
            if dtype == "bfloat16" and S == 150:
                rec = dict(max_abs_err=err, ms=k_ms, device_ms=k_dev,
                           plain_ms=p_ms, library_ms=None,
                           library_device_ms=None, bound_ms=bms, bound_by=by)
    # strong decay (the full-width init's |cum logw|) at the chunk edges (8
    # tokens) and one past a pass (4 or 5 chunks at hs = 64, 7 or 10 at
    # hs = 32, 12 at hs = 16), each head size, and a strided view: checked,
    # not timed
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        for S, hs_ in ((1, hs), (7, hs), (9, hs), (33, hs), (41, hs),
                       (512, hs), (9, 16), (97, 16), (7, 32), (57, 32),
                       (81, 32), (512, 32)):
            worst = max(worst, check_wkv6(torch, dtype, 2, S, 5, hs_,
                                          decay_shift=1.5, timed=False)[1])
        worst = max(worst, check_wkv6(torch, dtype, 1, 300, H, hs,
                                      decay_shift=1.5, strided=True,
                                      timed=False)[1])
    log(f"  K3 strong decay, S in (1, 7, 9, 33, 41, 57, 81, 97, 512), "
        f"hs 16/32/64, fp32/bf16, a strided view: worst relative max|err| "
        f"{worst:.3e}")
    return {"wkv6": rec}


def check_rglru(torch, dtype, B, S, W, seed=0, b_dtype=None, timed=True):
    """K4 at one prefill shape, log_a in `dtype` and b in `b_dtype` (by
    default the same), h0 fp32, with the reference test's distributions
    (log_a = -exp(0.3 N): decays in (0, 1)). One launch a call. Returns
    (max|err|, kernel_ms, kernel device_ms, plain_ms, bound), the times None
    unless `timed`."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rglru import rglru_cuda, rglru_plain
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    bdt = getattr(torch, b_dtype or dtype)
    rnd = lambda *s_, sc=0.5: torch.randn(*s_, generator=g,  # noqa: E731
                                          device="cuda") * sc
    la = (-torch.exp(rnd(B, S, W, sc=0.3))).to(dt)
    b = rnd(B, S, W).to(bdt)
    h0 = rnd(B, W, sc=0.2)
    args = (la, b, h0)
    before = rglru_cuda.launches
    got = rglru_cuda(*args)
    if rglru_cuda.launches != before + 1:
        raise AssertionError("K4 did not count one launch for one call")
    want = rglru_plain(*args)
    torch.cuda.synchronize()
    err = max(max_err(a, w) for a, w in zip(got, want))
    scale = 1.0 if dt == bdt == torch.float32 else max(
        1.0, max(float(w.abs().max()) for w in want))
    if not err < RGLRU_TOL * scale:
        raise AssertionError(f"K4 {dtype}/{b_dtype or dtype} B={B} S={S} "
                             f"W={W}: max|err| {err} >= {RGLRU_TOL * scale}")
    assert ops.rglru_scan(*args)[0].shape == (B, S, W)
    if not timed:
        return err, None, None, None, None
    isz = torch.finfo(dt).bits // 8
    n = B * S * W
    nbytes = 2 * n * isz + 4 * n + 2 * 4 * B * W
    ops_ = 3.0 * n  # exp, multiply, add per element
    kern = lambda *a: lambda: rglru_cuda(*a)  # noqa: E731
    k_ms, k_dev = cuda_ms(kern(*args)), device_ms(kern, args, nbytes)
    p_ms = cuda_ms(lambda: rglru_plain(*args), warmup=1,
                   iters=2 if S > 100 else 10)
    return err, k_ms, k_dev, p_ms, bound_ms(nbytes, ops_, "float32")


def phase_rglru(torch, cfg):
    """K4 at the recurrentgemma path's shapes: one sequence of lru_width
    4096 at S = 1, 24 (median append), 150 (median first input) and 512; two
    sequences of 200 at W = 2560 (not a power of two). Returns the fp32
    record at S = 150 (the model's log_a and b are fp32)."""
    W = cfg.lru_width
    log(f"phase 3: K4 (RG-LRU scan) vs plain version (fp32 tol {RGLRU_TOL} "
        f"absolute; bf16 inputs {RGLRU_TOL} x max(1, max|plain|))")
    rec = {}
    for dtype in ("float32", "bfloat16"):
        for B, S, Wk in ((1, 1, W), (1, 24, W), (1, 150, W), (1, 512, W),
                         (2, 200, 2560)):
            err, k_ms, k_dev, p_ms, (bms, by) = check_rglru(torch, dtype, B,
                                                            S, Wk)
            log(f"  K4 {dtype:8s} B={B} S={S:4d} W={Wk}: max|err| {err:.3e}"
                f"  kernel {k_ms:.4f} ms (device {k_dev:.4f})  plain "
                f"{p_ms:.4f} ms  library none  bound {bms:.5f} ms ({by})")
            if dtype == "float32" and S == 150:
                rec = dict(max_abs_err=err, ms=k_ms, device_ms=k_dev,
                           plain_ms=p_ms, library_ms=None,
                           library_device_ms=None, bound_ms=bms, bound_by=by)
    # segment and tile edges (segments of up to 16 steps, tiles of 16), W not
    # a power of two and not a multiple of 32, every mix of input dtypes:
    # checked, not timed
    worst = 0.0
    for a_dt, b_dt in (("float32", "float32"), ("bfloat16", "bfloat16"),
                       ("float32", "bfloat16"), ("bfloat16", "float32")):
        for S in (1, 15, 257, 512):
            for Wk in (2560, 4095):
                worst = max(worst, check_rglru(torch, a_dt, 1, S, Wk,
                                               b_dtype=b_dt, timed=False)[0])
    log(f"  K4 S in (1, 15, 257, 512), W 2560/4095, log_a/b dtypes mixed: "
        f"worst max|err| {worst:.3e}")
    return {"rglru": rec}


# --------------------------------------------------------------------------- #
# phase 4: full-width fp32, cuda vs torch attention
# --------------------------------------------------------------------------- #
class recording_k1:
    """While open, record the cache dtype of every call of K1's wrapper
    through `ops` (eager calls: a graph's replay calls no wrapper)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.orig = ops.flash_decode_attention
        seen = self.seen = []
        orig = self.orig

        def call(q, k, v, *a, **kw):
            seen.append(k.dtype)
            return orig(q, k, v, *a, **kw)
        ops.flash_decode_attention = call
        return seen

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_decode_attention = self.orig
        return False


def impl_parity(torch, cfg, params, device, n_decode=8):
    """One 300-token prefill under each impl (K2 / torch), its rows put
    into a cache 64 rows longer as the fold puts them (quantized for an
    int8 cache), one decode step under each impl (K1, handed the cache in
    its own dtype, recorded by `recording_k1` / torch), the logits within
    LOGIT_TOL and one K1 and one K2 launch a layer; then the greedy tokens
    of a replica under each impl, equal. Returns the tokens."""
    import numpy as np
    from repro_torch.engine import ReplicaEngine
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.attention import quantize_kv
    model = build_model(cfg)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, 300)
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=device)[None]
    logits, caches = {}, {}
    ops.reset_launch_counts()
    for impl in ("cuda", "torch"):
        logits[impl], caches[impl] = model.prefill(params, toks,
                                                   attention_impl=impl)
    err_p = max_err(logits["cuda"], logits["torch"])
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device=device)
    nxt = logits["torch"][:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    cache = {k: {kk: {n: quantize_kv(torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, 64)), cfg) for n, t in vv.items()}
        for kk, vv in v.items()} for k, v in caches["torch"].items()}
    with recording_k1() as seen:
        dl = {impl: model.decode_step(params, nxt, cache, pos, kv_lens=pos,
                                      attention_impl=impl)[0]
              for impl in ("cuda", "torch")}
    counts = ops.launch_counts()
    want = {"decode_attention": cfg.n_layers,
            "prefill_attention": cfg.n_layers, "append_attention": 0,
            "wkv6": 0, "rglru": 0}
    if counts != want or seen != [cfg.kv_torch_dtype] * cfg.n_layers:
        raise AssertionError(f"one prefill and one decode step launched "
                             f"{counts}, not {want}; K1 was handed "
                             f"{set(seen)} caches")
    err_d = max_err(dl["cuda"], dl["torch"])
    log(f"  launches of one prefill + one decode step {counts}; each K1 "
        f"call handed the {cfg.kv_torch_dtype} cache itself")
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
    return streams["cuda"]


def phase_fp32_parity(torch, cfg, device, card):
    from repro_torch.models import build_model
    cfg = cfg.scaled(dtype="float32")
    log(f"phase 4: {cfg.name} full width fp32 ({cfg.n_layers} layers), "
        f"attention_impl cuda vs torch")
    params = build_model(cfg).init(0, device)
    impl_parity(torch, cfg, params, device)
    phase_graphs(torch, cfg, params, card, "11a")
    phase_prefill_reference(torch, cfg, params)
    del params
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
                    max_ctx=1024, scheduler="conserve", server_cls=None,
                    live=False, server_kw=None, trace=None, reps=None):
    """The launcher's engine deployment under `scheduler` (1 prefiller + 2
    decoders, or 3 mixed replicas under collocated) on its engine trace (or
    `trace()`, a function of n_conversations), tokens recorded, each
    replica through its CUDA graphs (the default), or on the replicas
    `reps` given. `live` serves it through the gateway
    (`serve_scenario_live`); `server_kw` goes to the server. Returns
    (summary, server, replicas, gateway or None)."""
    from repro_torch.core import make_scheduler
    from repro_torch.core.metrics import summarize
    from repro_torch.engine import EngineServer, ReplicaEngine
    from repro_torch.launch.serve import engine_roles, engine_trace
    if reps is None:
        reps = [ReplicaEngine(cfg, params, n_slots=n_slots, max_ctx=max_ctx,
                              replica_id=i, role=role, attention_impl="cuda")
                for i, role in enumerate(engine_roles(scheduler))]
    srv = (server_cls or EngineServer)(make_scheduler(scheduler), reps,
                                       record_tokens=True,
                                       strict_accounting=True,
                                       **(server_kw or {}))
    convs = (trace or engine_trace)(n_conversations)
    gw = None
    if live:
        from repro_torch.serve import serve_scenario_live
        recs, gw, _ = serve_scenario_live(srv, convs)
    else:
        recs = srv.serve(convs)
    s = summarize(recs)
    if s["n_conversations"] != n_conversations:
        raise AssertionError(f"{s['n_conversations']} of {n_conversations} "
                             "conversations completed")
    if (scheduler == "conserve" and server_cls is None
            and s["kv_transfers_per_conv"] != 1.0):
        raise AssertionError(f"kv_transfers_per_conv "
                             f"{s['kv_transfers_per_conv']} != 1.0")
    srv.check_accounting()
    for r in reps:
        if r.kv.active.any() or r.kv.active_kv_tokens:
            raise AssertionError(f"replica {r.replica_id} did not drain")
    return s, srv, reps, gw


def serve_and_count(torch, cfg, params, card, path_kernels, label,
                    absent=(), **serve_kw):
    """Serve the main path with every launch count set to 0 just before
    and read just after; fail unless each kernel of `path_kernels` ran and
    each of `absent` did not. Where K2's append instance is on the path, it
    launches once a global layer for every append and pool hit (the
    replicas' (append-)prefills against a slot's prefix, graphed or eager).
    Returns (this path's counts, the run: summary, server, gateway,
    streams, remote turns, launches, appends)."""
    import gc

    from repro_torch.kernels import ops
    gc.collect()  # a finished server's reference cycles hold its caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with counting_appends() as appends:
        s, srv, reps, gw = serve_main_path(cfg, params, **serve_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name in path_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{cfg.name} path")
    for name in absent:
        if launches[name] != 0:
            raise AssertionError(f"kernel {name} launched {launches[name]} "
                                 f"times on the {cfg.name} path")
    if ("append_attention" in path_kernels
            and launches["append_attention"] != n_global(cfg) * appends["n"]):
        raise AssertionError(f"K2's append instance launched "
                             f"{launches['append_attention']} times for "
                             f"{appends['n']} appends and pool hits of "
                             f"{n_global(cfg)} global layers")
    pre_tok = sum(r.n_prefill_tokens for r in reps)
    pre_s = sum(r.prefill_s for r in reps)
    dec_tok = sum(r.n_decode_tokens for r in reps)
    dec_s = sum(r.decode_s for r in reps)
    remote = sum(r.n_remote_turns for r in srv.records.values())
    per_transfer = (f"{srv.transfer_bytes / srv.n_transfers:.0f} B per "
                    f"transfer" if srv.n_transfers else "no transfer")
    layout = ("3 mixed replicas" if reps[0].role == "mixed"
              else "1 prefiller + 2 decoders")
    log(f"  {label}{layout}, {s['n_conversations']} "
        f"conversations, kv_transfers_per_conv "
        f"{s['kv_transfers_per_conv']}, remote turns {remote}, appends "
        f"and pool hits {appends['n']}, wall {wall:.2f} s, launches "
        f"{launches}")
    progs = [p for r in reps for p in r.programs().values()]
    log(f"  [{card}] ttfet_p95 {s['ttfet_p95']:.4f} s, last_tbt_gmean "
        f"{s['last_tbt_gmean'] * 1e3:.3f} ms, last_tbt_p95 "
        f"{s['last_tbt_p95'] * 1e3:.3f} ms, prefill {pre_tok / pre_s:.1f} "
        f"tok/s ({pre_tok} tok), decode {dec_tok / dec_s:.1f} tok/s "
        f"({dec_tok} tok), peak device memory {peak:.3f} GiB, "
        f"{per_transfer} (nbytes_of)")
    log(f"  [{card}] compile_s {sum(r.compile_s for r in reps):.3f} s "
        f"(kernels and programs, out of every dt); programs captured "
        f"{sum(p.graph is not None for p in progs)} of {len(progs)} "
        f"({sum(k[0] == 'decode' for r in reps for k in r.programs())} "
        f"decode), capture {sum(p.capture_s for p in progs):.3f} s; graph "
        f"pools {sum(r.graph_pool_bytes() for r in reps) / 2**20:.1f} MiB")
    streams = {k: [int(t) for t in v] for k, v in srv.sampled_tokens.items()}
    run = dict(summary=s, srv=srv, gw=gw, streams=streams, remote=remote,
               launches=dict(launches), appends=appends["n"])
    return {n: launches[n] for n in path_kernels}, run


def phase_serve(torch, cfg, device, card):
    from repro_torch.models import build_model
    log(f"phase 5: {cfg.name} full width {cfg.dtype}, EngineServer + "
        f"ConServe, strict accounting")
    params = build_model(cfg).init(0, device)
    phase_graphs(torch, cfg, params, card, "11b", gate=False)
    golden = json.loads(GOLDEN.read_text())
    got = golden_summary(cfg, params, device)
    if got != golden:
        raise AssertionError("golden-trace summary differs from "
                             f"{GOLDEN.relative_to(ROOT)}")
    log("  (a) golden-trace summary equals tests/golden/"
        "decode_golden_trace.json")
    launches, run = serve_and_count(torch, cfg, params, card,
                                    BF16_PATH_KERNELS, "(b) ")
    del params
    torch.cuda.empty_cache()
    # phase 10 compares against this run; the replicas and their caches go
    return launches, {k: v for k, v in run.items() if k not in ("srv", "gw")}


# --------------------------------------------------------------------------- #
# phases 6-7: rwkv6-3b
# --------------------------------------------------------------------------- #
def phase_rwkv_fp32_parity(torch, cfg, device, card, n_decode=8):
    """Full width in fp32: the prefill's WKV in K3 ("cuda") and in
    `wkv6_chunked` ("torch"), then decode steps from each one's state."""
    import numpy as np
    from repro_torch.engine import ReplicaEngine
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain
    from repro_torch.models import build_model
    from repro_torch.models.recurrent import wkv6_chunked
    cfg = cfg.scaled(dtype="float32")
    log(f"phase 6: {cfg.name} full width fp32 ({cfg.n_layers} layers), "
        f"WKV in K3 (cuda) vs wkv6_chunked (torch)")
    model = build_model(cfg)
    params = model.init(0, device)
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, 300)
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=device)[None]
    logits, caches = {}, {}
    # the first RWKV6 layer's WKV inputs, as the cuda prefill hands them on
    first_call = []
    wkv6 = ops.wkv6

    def spy(*a, **kw):
        if not first_call:
            first_call.append(tuple(t.clone() for t in a))
        return wkv6(*a, **kw)

    ops.reset_launch_counts()
    ops.wkv6 = spy
    try:
        logits["cuda"], caches["cuda"] = model.prefill(params, toks,
                                                       attention_impl="cuda")
    finally:
        ops.wkv6 = wkv6
    k3 = ops.launch_counts()["wkv6"]
    if k3 != cfg.n_layers:
        raise AssertionError(f"K3 launched {k3} times in one prefill, not "
                             f"{cfg.n_layers}")
    logits["torch"], caches["torch"] = model.prefill(params, toks,
                                                     attention_impl="torch")
    err_p = max_err(logits["cuda"], logits["torch"])
    # K3 on the model's own inputs (S = 300): against the step recurrence,
    # and the chunked form's error beside it
    args = first_call[0]
    want = wkv6_plain(*args)
    _, rel_k3 = wkv6_errors(wkv6_cuda(*args), want)
    _, rel_ch = wkv6_errors(wkv6_chunked(*args), want)
    cum = args[3][:, :64].sum(1).abs().max()
    log(f"  layer 0's WKV inputs (S = 300, max|cum logw| over 64 tokens "
        f"{float(cum):.1f}): relative max|err| vs the step recurrence, K3 "
        f"{rel_k3:.3e} (tol {WKV_RTOL}), wkv6_chunked {rel_ch:.3e}; K3 "
        f"launched {k3} times by the cuda prefill")
    if not rel_k3 < WKV_RTOL:
        raise AssertionError(f"K3 on layer 0's inputs: relative max|err| "
                             f"{rel_k3} >= {WKV_RTOL}")
    s_c, s_t = (caches[i]["groups"]["p0"]["s"] for i in ("cuda", "torch"))
    err_s = max_err(s_c, s_t) / max(1.0, float(s_t.abs().max()))
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device=device)
    nxt = logits["torch"][:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    dl = {impl: model.decode_step(params, nxt, caches[impl], pos,
                                  attention_impl=impl)[0]
          for impl in ("cuda", "torch")}
    err_d = max_err(dl["cuda"], dl["torch"])
    scale = max(1.0, float(logits["torch"].abs().max()))
    log(f"  logits max|err| prefill {err_p:.3e}, decode {err_d:.3e}, "
        f"max|logit| {scale:.3f} (tol {RWKV_LOGIT_RTOL} x max(1, max|logit|)"
        f"); WKV state relative max|err| {err_s:.3e}")
    if not (err_p < RWKV_LOGIT_RTOL * scale
            and err_d < RWKV_LOGIT_RTOL * scale):
        raise AssertionError("fp32 rwkv6 logits differ between impls")
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
        raise AssertionError("rwkv6 greedy tokens differ between impls")
    del caches, eng, params
    torch.cuda.empty_cache()
    graphs_at_depth(torch, cfg, device, card, "11c")


def phase_rwkv_serve(torch, cfg, device, card):
    from repro_torch.models import build_model
    log(f"phase 7: {cfg.name} full width {cfg.dtype}, EngineServer + "
        f"ConServe, strict accounting")
    params = build_model(cfg).init(0, device)
    launches, _ = serve_and_count(torch, cfg, params, card, ("wkv6",), "")
    if launches["wkv6"] % cfg.n_layers:
        raise AssertionError(f"{launches['wkv6']} K3 launches are not "
                             f"{cfg.n_layers} per prefill")
    del params
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# phases 8-9: recurrentgemma-9b
# --------------------------------------------------------------------------- #
def phase_rg_fp32_parity(torch, cfg, device, card, n_decode=8):
    """Full width in fp32: the prefill's RG-LRU recurrence in K4 ("cuda")
    and in the log-depth scan ("torch"), then decode steps from each one's
    caches (folded by merge_decode_cache), then greedy tokens through a
    ReplicaEngine pair."""
    import numpy as np
    from repro_torch.engine import ReplicaEngine
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.model import merge_decode_cache
    cfg = cfg.scaled(dtype="float32")
    log(f"phase 8: {cfg.name} full width fp32 ({cfg.n_layers} layers), "
        f"RG-LRU in K4 (cuda) vs the log-depth scan (torch)")
    model = build_model(cfg)
    params = model.init(0, device)
    prompt = np.random.RandomState(2).randint(0, cfg.vocab_size, 300)
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=device)[None]
    logits, caches = {}, {}
    ops.reset_launch_counts()
    for impl in ("cuda", "torch"):
        logits[impl], caches[impl] = model.prefill(params, toks,
                                                   attention_impl=impl)
    k4 = ops.launch_counts()["rglru"]
    if k4 != 26:
        raise AssertionError(f"K4 launched {k4} times in one prefill, not 26")
    scale = max(1.0, float(logits["torch"].abs().max()))
    errs = [max_err(logits["cuda"], logits["torch"])]
    h_c, h_t = (caches[i]["groups"]["p0"]["h"] for i in ("cuda", "torch"))
    err_h = max_err(h_c, h_t) / max(1.0, float(h_t.abs().max()))
    nxt = logits["torch"][:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    for i in range(4):
        pos = torch.tensor([len(prompt) + i], dtype=torch.int32,
                           device=device)
        step = {}
        for impl in ("cuda", "torch"):
            step[impl], up = model.decode_step(params, nxt, caches[impl], pos,
                                               attention_impl=impl)
            caches[impl] = merge_decode_cache(caches[impl], up)
        errs.append(max_err(step["cuda"], step["torch"]))
        nxt = step["torch"][:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    log(f"  logits max|err| prefill {errs[0]:.3e}, decode steps "
        f"{', '.join(f'{e:.3e}' for e in errs[1:])}, max|logit| {scale:.3f} "
        f"(tol {RG_LOGIT_RTOL} x max(1, max|logit|)); RG-LRU h relative "
        f"max|err| {err_h:.3e}")
    if not max(errs) < RG_LOGIT_RTOL * scale:
        raise AssertionError("fp32 recurrentgemma logits differ between "
                             "impls")
    del caches
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
        del eng
    log(f"  greedy tokens cuda  {streams['cuda']}")
    log(f"  greedy tokens torch {streams['torch']}")
    if streams["cuda"] != streams["torch"]:
        raise AssertionError("recurrentgemma greedy tokens differ between "
                             "impls")
    del params
    torch.cuda.empty_cache()
    graphs_at_depth(torch, cfg, device, card, "11d")


def phase_rg_serve(torch, cfg, device, card):
    from repro_torch.models import build_model
    log(f"phase 9: {cfg.name} full width {cfg.dtype}, EngineServer + "
        f"ConServe, strict accounting")
    params = build_model(cfg).init(0, device)
    launches, _ = serve_and_count(torch, cfg, params, card, ("rglru",), "",
                                  absent=("decode_attention",
                                          "prefill_attention", "wkv6"))
    if launches["rglru"] % 26:
        raise AssertionError(f"{launches['rglru']} K4 launches are not 26 "
                             "per prefill")
    del params
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# phase 11: the replica's CUDA graphs against the same bodies run eagerly
# --------------------------------------------------------------------------- #
GRAPH_SLOTS = 16
# the depths of the fp32 graph checks 12 (d), 13 (d) and 14 (d): whole-depth
# checks of these patterns (30 of gemma3's 48 layers, all 27 of deepseek's)
# ran before phase 15 was added, whose time they pay for; gemma3's one
# repetition of its pattern (12 before) and internvl2's 16 layers (32, all
# that fit, before) pay for phase 17
GRAPH_CHECK_LAYERS = {"gemma3-12b": 6, "deepseek-v2-lite-16b": 8,
                      "internvl2-26b": 16,
                      # 11c and 11d (32 and 38 layers before) pay for
                      # phase 18: rwkv6's first 8 layers, and
                      # recurrentgemma's two repetitions and its two "rem"
                      # layers
                      "rwkv6-3b": 8, "recurrentgemma-9b": 8}
# phase 12 (b)'s fp32 parity of the two deepest dense models at half depth
# (of 40 and 32 layers): the time it saves pays for phase 16
PARITY_LAYERS = {"stablelm-12b": 20, "nemotron-4-15b": 16}


def graphs_at_depth(torch, cfg, device, card, tag):
    """`phase_graphs` (fp32 gate, then `step_times`) on fresh seeded
    weights cut to GRAPH_CHECK_LAYERS[cfg.name] layers: the first layers of
    the full model's own (each leaf is seeded by its name)."""
    from repro_torch.models import build_model
    cfg = cut_depth(cfg, GRAPH_CHECK_LAYERS[cfg.name], tag)
    params = build_model(cfg).init(0, device)
    phase_graphs(torch, cfg, params, card, tag)
    del params
    torch.cuda.empty_cache()


def cache_copy(eng):
    from repro_torch.engine.kvcache import leaves
    return [t.clone() for _, t in leaves(eng.kv.caches)]


def graph_script(eng, seed, front=None):
    """The chunks a served decoder meets, at full width: 12 slots
    prefilled, a ragged chunk of up to 32 steps with two live slots idle, a
    slot joining and an append between chunks (the split-chunk contract), a
    chunk of 16, a kill (every slot invalidated and the cache kept, as
    `EngineServer` fails a replica), a rejoin and a chunk of 4. `front(i)`
    gives the i-th turn-1 prefill its frontend embeddings (a vision model's
    patches, an encoder-decoder's frames). Yields (label, sampled tokens)
    after each chunk."""
    import numpy as np
    rs = np.random.RandomState(seed)
    n, V = eng.kv.n_slots, eng.cfg.vocab_size
    nt = np.zeros(n, np.int32)
    em = np.zeros(n, bool)
    admitted = []

    def admit(length):
        s = eng.kv.acquire()
        fe = front and front(len(admitted))
        admitted.append(s)
        nt[s] = int(eng.prefill_conversation(
            s, rs.randint(0, V, length), fe)[0])
        em[s] = True

    for length in rs.randint(40, 400, 12):
        admit(int(length))
    em[[3, 7]] = False
    rem = np.where(em, rs.randint(1, 33, n), 0).astype(np.int32)
    rem[0] = 32
    seq, _ = eng.decode_steps(nt, em, rem)
    yield "ragged chunk (remaining 1-32, 2 slots idle)", seq
    live = np.flatnonzero(em)
    nt[live] = seq[rem[live] - 1, live]
    admit(150)
    nt[0] = int(eng.append_prefill(0, rs.randint(0, V, 24))[0])
    seq, _ = eng.decode_steps(nt, em, 16)
    yield "a slot joined and an append, chunk of 16", seq
    eng.kv.invalidate_all()
    nt[:], em[:] = 0, False
    for length in (77, 260):
        admit(length)
    seq, _ = eng.decode_steps(nt, em, 4)
    yield "killed and rejoined, chunk of 4", seq


def phase_graphs(torch, cfg, params, card, tag, gate=True, front=None,
                 times=True):
    """On the caller's weights: `graph_script` through the CUDA graphs and
    through the same bodies run eagerly (`cuda_graphs=False`), on the same
    cache from the same zeroed start, the buckets of the last chunk
    captured after the kill. `gate` (fp32 with TF32 off): the tokens equal
    and the caches byte-identical after every chunk, then (with `times`)
    `step_times`.
    Without `gate` (bf16) the count of equal tokens and the largest cache
    difference are printed. `front(i)`: the i-th turn-1's frontend
    embeddings."""
    import gc

    from repro_torch.engine import ReplicaEngine
    from repro_torch.engine.kvcache import leaves
    log(f"phase {tag}: {cfg.name} full width {cfg.dtype}, the CUDA graphs "
        f"against the same bodies run eagerly, on one cache")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ReplicaEngine(cfg, params, n_slots=GRAPH_SLOTS, max_ctx=1024,
                        attention_impl="cuda")
    want = []
    for graphs in (False, True):
        for _, t in leaves(eng.kv.caches):
            t.zero_()
        eng.kv.invalidate_all()
        eng.cuda_graphs = graphs
        for i, (label, seq) in enumerate(graph_script(eng, seed=11,
                                                      front=front)):
            if not graphs:
                want.append((seq, cache_copy(eng)))
                continue
            w_seq, w_caches = want[i]
            n_eq = int((seq == w_seq).sum())
            diff = max(max_err(a, b) for (_, a), b in
                       zip(leaves(eng.kv.caches), w_caches))
            log(f"  {label}: {n_eq} of {seq.size} tokens equal, cache "
                f"max|diff| {diff:.3e}")
            if gate and not (n_eq == seq.size and diff == 0.0):
                raise AssertionError(f"{cfg.name}: graph and eager differ "
                                     f"after: {label}")
    del want
    if gate and times:
        step_times(torch, eng, card, front)
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def step_times(torch, eng, card, front=None):
    """Every slot of `eng` filled with a 300-token conversation (after its
    frontend embeddings, `front(slot)`), then one 16-step chunk eager and one
    through the graph — wall time per step, and for the graph the device
    time per step and the kernel launches per replay (`traced`: the eager
    chunk runs the same kernels, and tracing its host ops costs tens of
    seconds), the capture seconds of each decode bucket, the graph pool,
    peak memory. Returns {"eager" | "graph": wall seconds a step}."""
    import numpy as np
    from repro_torch.launch.profile import traced
    cfg = eng.cfg
    n = eng.kv.n_slots
    rs = np.random.RandomState(12)
    eng.kv.invalidate_all()
    nt = np.zeros(n, np.int32)
    for _ in range(n):
        s = eng.kv.acquire()
        nt[s] = int(eng.prefill_conversation(
            s, rs.randint(0, cfg.vocab_size, 300), front and front(s))[0])
    em = np.ones(n, bool)
    step = {}
    for graphs, label in ((False, "eager"), (True, "graph")):
        eng.cuda_graphs = graphs
        eng.decode_steps(nt, em, 16)  # builds (and captures) the bucket
        _, dt = eng.decode_steps(nt, em, 16)
        step[label] = dt / 16
        if not graphs:
            log(f"  [{card}] decode step, eager: wall {dt * 1e3 / 16:.3f} ms")
            continue
        (_, dt_t), rows = traced(lambda: eng.decode_steps(nt, em, 16))
        busy = sum(r[1] for r in rows) / 1e3
        n_k = sum(r[2] for r in rows)
        log(f"  [{card}] decode step, graph: wall {dt * 1e3 / 16:.3f} ms, "
            f"device busy {busy / 16:.3f} ms ({100 * busy / (dt_t * 1e3):.1f}"
            f"% of the traced chunk's wall {dt_t * 1e3 / 16:.3f} ms a step), "
            f"{n_k} kernel launches in the chunk ({n_k / 16:.1f} a step)")
    caps = {k: round(p.capture_s, 3) for k, p in sorted(eng._fused.items())
            if p.graph is not None}
    free, total = torch.cuda.mem_get_info()
    outside = (total - free - torch.cuda.memory_reserved()) / 2**30
    log(f"  [{card}] graph {step['eager'] / step['graph']:.2f}x faster a "
        f"step; decode buckets captured (n_steps, ctx): seconds {caps}; "
        f"programs {len(eng.programs())}, compile_s {eng.compile_s:.3f} s, "
        f"graph pool {eng.graph_pool_bytes() / 2**20:.1f} MiB, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, device memory "
        f"outside the caching allocator {outside:.3f} GiB")
    return step


def phase_prefill_reference(torch, cfg, params):
    """qwen3-0.6b in fp32, TF32 off: a turn-1 prefill and two appends (the
    prefix crossing a ctx bucket) through the graphed programs, through the
    same bodies eagerly, and through `prefill_mode="reference"`, at
    max_ctx 256 (the CPU test's) and 1024: equal tokens and byte-identical
    caches, gated. The reference's append attends over the whole max_ctx
    buffer, the fast path's over the prefix's ctx bucket; each layer's
    largest difference is printed, and the first differing layer."""
    import numpy as np
    from repro_torch.engine import ReplicaEngine
    from repro_torch.engine.kvcache import leaves
    for max_ctx, lengths in ((256, (45, 31, 15)), (1024, (300, 120, 40))):
        toks, caches = {}, {}
        for mode, kw in (("graph", {}), ("eager", {"cuda_graphs": False}),
                         ("reference", {"prefill_mode": "reference"})):
            eng = ReplicaEngine(cfg, params, n_slots=2, max_ctx=max_ctx,
                                attention_impl="cuda", **kw)
            rs = np.random.RandomState(5)
            slot = eng.kv.acquire()
            got = [eng.prefill_conversation(
                slot, rs.randint(0, cfg.vocab_size, lengths[0]))[0]]
            for n in lengths[1:]:
                got.append(eng.append_prefill(
                    slot, rs.randint(0, cfg.vocab_size, n))[0])
            toks[mode] = [int(t) for t in got]
            caches[mode] = {"/".join(p): t.clone()
                            for p, t in leaves(eng.kv.caches)}
            del eng
        same_tok = toks["graph"] == toks["eager"] == toks["reference"]
        same = all(torch.equal(caches["graph"][k], caches["eager"][k])
                   for k in caches["graph"])
        per_layer = {k: [max_err(a, b) for a, b in
                         zip(caches["graph"][k], caches["reference"][k])]
                     for k in caches["graph"]}
        first = {k: next((i for i, e in enumerate(v) if e), None)
                 for k, v in per_layer.items()}
        log(f"  prefill + 2 appends, max_ctx {max_ctx}: tokens equal "
            f"{same_tok} {toks['graph']}; graphed caches byte-identical to "
            f"eager {same}; against the reference path, max|diff| by layer "
            + "; ".join(f"{k} {max(v):.3e} (first differing layer "
                        f"{first[k]})" for k, v in per_layer.items()))
        if not (same_tok and same and all(
                max(v) == 0.0 for v in per_layer.values())):
            raise AssertionError("graphed prefill and appends differ from "
                                 "the eager fast path or the reference "
                                 "path")
        del caches


# --------------------------------------------------------------------------- #
# phase 10: the paper's comparison and the failure contract, qwen3-0.6b
# --------------------------------------------------------------------------- #
COMPARED = ("conserve", "ampd", "full_disagg", "collocated")
PATH_KERNELS = ("decode_attention", "prefill_attention")
# qwen's bf16 runs attend their appends and pool hits in K2's append
# instance; its fp32 runs and an int8 cache keep them in torch ops
BF16_PATH_KERNELS = PATH_KERNELS + ("append_attention",)
REJOIN_AFTER_S = 0.5  # logical seconds from the kill to recover_replica


def kill_when_decoding(rejoin_after_s=None):
    """An `EngineServer` that kills decoder 1 the first time it begins
    decoding a turn with turn_idx >= 1 (a condition, not a clock, so the
    replay must re-prefill completed turns) and, with `rejoin_after_s`,
    recovers it that many logical seconds after the kill: the port's
    `chaos.triggers.FailWhen`. Its `killed` and `at_rejoin` keep what it
    killed and the node's state at the rejoin."""
    import functools

    from repro_torch.chaos.triggers import FailWhen
    from repro_torch.engine import EngineServer

    class KillWhenDecoding(FailWhen, EngineServer):
        pass

    return functools.partial(KillWhenDecoding, victim_node=1, min_turn=1,
                             rejoin_after_s=rejoin_after_s)


def first_divergences(want, got):
    """Per conversation, the first (cid, turn, position) where `got`'s
    streams leave `want`'s, in turn order: a flipped token changes the
    rest of that turn and the context of every later turn, so only the
    first is a fact about the numerics."""
    if set(want) != set(got):
        raise AssertionError(f"stream keys differ: "
                             f"{sorted(set(want) ^ set(got))[:6]}")
    out = []
    for cid in sorted({k[0] for k in want}):
        for turn in sorted(k[1] for k in want if k[0] == cid):
            a, b = want[(cid, turn)], got[(cid, turn)]
            if a != b:
                if len(a) != len(b):
                    raise AssertionError(f"stream ({cid}, {turn}) has "
                                         f"{len(b)} tokens, not {len(a)}")
                out.append((cid, turn, next(i for i, (x, y) in
                                            enumerate(zip(a, b)) if x != y)))
                break
    return out


def two_order_logits(torch, model, params, segments, device):
    """The logits after `segments` ("prefill" or "decode", tokens) in two
    orders: as the serving engine built them (a fresh prefill, then each
    fed token through a decode step and each later input through an
    append-prefill) and in one prefill of the whole context (how a replay
    rebuilds it). Attention through K1 and K2 where the engine uses them."""
    import numpy as np
    from repro_torch.models.model import merge_decode_cache

    def tens(toks):
        return torch.as_tensor(np.asarray(toks, np.int32), device=device)

    whole = np.concatenate([np.asarray(t, np.int32) for _, t in segments])
    one, _ = model.prefill(params, tens(whole)[None], attention_impl="cuda")
    caches, pos, logits = None, 0, None
    for kind, toks in segments:
        if kind == "prefill" and len(toks):
            if caches is None:
                logits, caches = model.prefill(params, tens(toks)[None],
                                               attention_impl="cuda")
            else:
                logits, new = model.prefill(params, tens(toks)[None],
                                            caches=caches, start_pos=pos,
                                            attention_impl="cuda")
                caches = merge_decode_cache(caches, new)
            pos += len(toks)
        elif kind == "decode":
            for t in toks:
                p = tens([pos])
                logits, up = model.decode_step(params, tens([t]), caches, p,
                                               kv_lens=p,
                                               attention_impl="cuda")
                caches = merge_decode_cache(caches, up)
                pos += 1
    V = model.cfg.vocab_size
    return logits[0, :V].float(), one[0, :V].float()


NEAR_TIE_BAND_MAX = 4  # fp32: the most tokens the band may hold


def tie_report(torch, cfg, params, srv, want, got, cid, turn, pos, device,
               trace=None):
    """Recompute the logits at the first position where `got` leaves
    `want`, in both orders, and print for each order the two tokens' ranks
    and gaps to the top logit, the orders' largest logit difference delta,
    and how many tokens lie within 2 delta of the top (the band). Returns
    (both tokens lie in the band in both orders, the larger band count).
    The recompute runs at batch 1, so K1's split plan and the projection
    shapes need not be the engine's: delta is the two orders' difference
    at batch 1, not the difference the engine saw. `trace` is the served
    trace's function of n_conversations (the engine trace by default)."""
    from repro_torch.launch.serve import engine_trace
    from repro_torch.models import build_model
    conv = next(c for c in (trace or engine_trace)(8) if c.cid == cid)
    segments = []
    for t in range(turn):
        segments += [("prefill", srv._turn_tokens(conv, t)),
                     ("decode", want[(cid, t)][:-1])]
    segments += [("prefill", srv._turn_tokens(conv, turn)),
                 ("decode", want[(cid, turn)][:pos])]
    inc, one = two_order_logits(torch, build_model(cfg), params, segments,
                                device)
    ta, tb = want[(cid, turn)][pos], got[(cid, turn)][pos]
    delta = float((inc - one).abs().max())
    in_band, band, desc = True, 0, []
    for name, lg in (("incremental", inc), ("one prefill", one)):
        top = float(lg.max())
        n_close = int((lg >= top - 2 * delta).sum())
        band = max(band, n_close)
        facts = []
        for tok in (ta, tb):
            gap = top - float(lg[tok])
            in_band &= gap <= 2 * delta
            facts.append(f"{tok} rank {1 + int((lg > lg[tok]).sum())} gap "
                         f"{gap:.6f}")
        desc.append(f"{name}: {', '.join(facts)}, {n_close} tokens in the "
                    f"band")
    log(f"    first difference at conversation {cid} turn {turn} token "
        f"{pos} ({ta} vs {tb}, {sum(len(t) for _, t in segments)} tokens "
        f"of context, recomputed at batch 1): {'; '.join(desc)}; "
        f"max|difference| of the two orders' logits delta {delta:.3e} at "
        f"max|logit| {float(one.abs().max()):.3f}, band 2 delta")
    return in_band, band


def count_equal(want, got):
    return sum(1 for k in want if got.get(k) == want[k]), len(want)


def phase_compare(torch, cfg, device, card, conserve):
    """(a) the four schedulers in bf16 on phase 5b's trace, (b) the failure
    contract in fp32, (c) the live gateway under a failure. Returns the
    launches of K1 and K2 in each run."""
    from repro_torch.core.signals import NODE_ACTIVE
    from repro_torch.models import build_model
    log(f"phase 10: {cfg.name} full width, the paper's comparison and the "
        f"failure contract, strict accounting")
    launches = {"conserve": conserve["launches"]}

    # (a) bf16, the four schedulers; ConServe is phase 5b's run
    params = build_model(cfg).init(0, device)
    log(f"  (a) {cfg.dtype}: conserve is phase 5b's run (transfers per "
        f"conversation {conserve['summary']['kv_transfers_per_conv']}, "
        f"remote turns {conserve['remote']})")
    runs = {"conserve": conserve}
    for sched in COMPARED[1:]:
        launches[sched], run = serve_and_count(
            torch, cfg, params, card, BF16_PATH_KERNELS, f"(a) {sched}: ",
            scheduler=sched)
        n_eq, n = count_equal(conserve["streams"], run["streams"])
        log(f"    {n_eq} of {n} (cid, turn) streams equal to conserve's "
            f"(bf16: measured, not gated)")
        for cid, turn, pos in first_divergences(conserve["streams"],
                                                run["streams"])[:2]:
            _, band = tie_report(torch, cfg, params, run["srv"],
                                 conserve["streams"], run["streams"], cid,
                                 turn, pos, device)
            log(f"    bf16: the band holds {band} tokens, so a token in it "
                f"says nothing of a tie (reported, not a verdict)")
        runs[sched] = {k: v for k, v in run.items() if k not in ("srv", "gw")}
        del run
    tpc = {k: r["summary"]["kv_transfers_per_conv"] for k, r in runs.items()}
    if tpc["conserve"] != 1.0 or runs["conserve"]["remote"]:
        raise AssertionError("conserve moved KV more than once")
    if not (runs["full_disagg"]["remote"] > 0
            and tpc["full_disagg"] > tpc["conserve"]):
        raise AssertionError(f"full_disagg: {runs['full_disagg']['remote']}"
                             f" remote turns, {tpc['full_disagg']} "
                             f"transfers per conversation")
    if tpc["collocated"] != 0.0:
        raise AssertionError("collocated moved KV")
    log(f"  (a) transfers per conversation {tpc}; remote turns "
        + ", ".join(f"{k} {r['remote']}" for k, r in runs.items()))
    del params
    torch.cuda.empty_cache()

    # (b) fp32 with TF32 off: failure replay and a cold rejoin
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.scaled(dtype="float32")
    params = build_model(cfg32).init(0, device)
    launches["fp32"], base = serve_and_count(
        torch, cfg32, params, card, PATH_KERNELS, "(b) fp32 failure-free: ",
        absent=("append_attention",))
    base = base["streams"]
    for label, rejoin in (("killed", None), ("killed + rejoin",
                                             REJOIN_AFTER_S)):
        cls = kill_when_decoding(rejoin)
        _, run = serve_and_count(torch, cfg32, params, card, PATH_KERNELS,
                                 f"(b) fp32 {label}: ", server_cls=cls,
                                 absent=("append_attention",))
        srv = run["srv"]
        if srv.killed is None:
            raise AssertionError("decoder 1 never decoded a turn >= 1")
        replayed = sum(st.replayed_prefill_tokens
                       for st in srv.states.values())
        cid, turn, _, t_kill = srv.killed
        log(f"    killed decoder 1 at {t_kill:.4f} s as conversation {cid} "
            f"began decoding turn {turn}; recoveries {srv.n_recoveries}, "
            f"replayed prefill tokens {replayed}")
        if srv.n_recoveries < 1 or not srv.records[cid].recovered \
                or replayed <= 0:
            raise AssertionError("no recovery recorded")
        if rejoin is not None:
            st = srv.states[1]
            want = dict(node_id=1, reason="from_dead", alive=True,
                        lifecycle=NODE_ACTIVE, kv=0, slots=0, convs=0,
                        ema=0.0)
            log(f"    rejoin {REJOIN_AFTER_S} s after the kill: at the "
                f"rejoin {srv.at_rejoin}; at the end alive {st.alive}, "
                f"{st.lifecycle}, in view "
                f"{any(n.node_id == 1 for n in srv.view.nodes())}")
            if srv.at_rejoin != want:
                raise AssertionError(f"decoder 1 did not rejoin cold: "
                                     f"{srv.at_rejoin}")
            if not (st.alive and st.lifecycle == NODE_ACTIVE and any(
                    n.node_id == 1 for n in srv.view.nodes())):
                raise AssertionError("decoder 1 did not end ACTIVE")
        n_eq, n = count_equal(base, run["streams"])
        log(f"    {n_eq} of {n} (cid, turn) streams byte-identical to the "
            f"failure-free run")
        for cid, turn, pos in first_divergences(base, run["streams"]):
            in_band, band = tie_report(torch, cfg32, params, srv, base,
                                       run["streams"], cid, turn, pos,
                                       device)
            ok = in_band and band <= NEAR_TIE_BAND_MAX
            log(f"    fp32 gate: both tokens in the band {in_band}, the "
                f"band holds {band} tokens (at most {NEAR_TIE_BAND_MAX}) "
                f"-> {'a near-tie' if ok else 'NOT a near-tie'}")
            if not ok:
                raise AssertionError("fp32 replay diverged, not at a "
                                     "near-tie")
        launches[f"fp32 {label}"] = run["launches"]
        del run, srv
    del params
    torch.cuda.empty_cache()

    # (c) bf16, live through the gateway with a decoder failure
    params = build_model(cfg).init(0, device)
    _, run = serve_and_count(torch, cfg, params, card, BF16_PATH_KERNELS,
                             "(c) live, killed: ", live=True,
                             server_cls=kill_when_decoding())
    srv, gw = run["srv"], run["gw"]
    h = gw.health()
    ev = h["events_seen"]
    log(f"    gateway: {h['n_submitted']} submitted, {h['n_done']} done, "
        f"{h['n_shed']} shed; node_failure {ev.get('node_failure', 0)}, "
        f"recovery {ev.get('recovery', 0)}, n_recoveries "
        f"{srv.n_recoveries}")
    if not (h["n_submitted"] == h["n_done"] == 8 and h["n_shed"] == 0
            and ev.get("node_failure") == 1
            and ev.get("recovery", 0) == srv.n_recoveries >= 1
            and gw.streams == srv.sampled_tokens):
        raise AssertionError("the live run's gateway counts do not add up")
    n_eq, n = count_equal(conserve["streams"], run["streams"])
    log(f"  (c) {n_eq} of {n} (cid, turn) streams equal to the offline "
        f"conserve run's (bf16: measured, not gated)")
    launches["live"] = run["launches"]
    del params, run, srv, gw
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# phase 12: the reference's dense family at full width
# --------------------------------------------------------------------------- #
DENSE = ("olmo-1b", "stablelm-12b", "nemotron-4-15b", "gemma3-12b")
# fp32 full-width logits, K1/K2 against the torch path, relative to
# max(1, max|logit|): the kernels and the plain path sum the same fp32
# products in another order, and 16-48 layers carry that into the logits
DENSE_LOGIT_RTOL = 1e-3
DENSE_PROMPT = 150  # the fp32 parity's prefill, then 8 decode steps


def n_global(cfg) -> int:
    """The layers that reach K1 and K2: the global-attention ones."""
    return sum(k == "attn_global" for k in cfg.layer_kinds())


def dense_kernels(torch, cfg, k2_lengths=(200, 256, 512, 1024)):
    """(a) K1 and K2 at the model's (H, Hkv, D) in fp32 and bf16 against
    their plain versions, as phase 3 at qwen's: K1 over 16 slots of a 1024
    buffer through the 64, 256 and 1024 buckets, K2 at S in `k2_lengths`.
    Returns the bf16 records at the served shapes (K1 at the 256 bucket, K2
    at S = 256 and 512)."""
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  (a) K1, K2 at H={H} Hkv={Hkv} D={D} (G = {H // Hkv}) vs plain "
        f"(fp32 tol 2e-5, bf16 tol 2e-2)")
    recs = {"decode_attention": {}, "prefill_attention": {}}
    for dtype in ("float32", "bfloat16"):
        for S in (64, 256, 1024):
            r = check_decode(torch, dtype, 16, 1024, S, H, Hkv, D,
                             decode_lengths(S))
            log(f"  K1 {dtype:8s} B=16 S={S:4d} {_k1_grid(16, Hkv, S, D)}: "
                f"max|err| {r['max_abs_err']:.3e}  {_times(r)}")
            if dtype == "bfloat16" and S == 256:
                recs["decode_attention"]["bf16 B=16 S=256"] = r
        for S in k2_lengths:
            r = check_prefill(torch, dtype, 1, S, H, Hkv, D, 0)
            log(f"  K2 {dtype:8s} B=1 S={S:4d}: max|err| "
                f"{r['max_abs_err']:.3e}  {_times(r)}")
            if dtype == "bfloat16" and S in (256, 512):
                recs["prefill_attention"][f"bf16 B=1 S={S}"] = r
    return recs


def fit_depth(torch, cfg, per_layer_extra: float = 0.0,
              reserve_bytes: float = 4 * 2**30):
    """cfg at full width, its depth cut (whole pattern repetitions) only if
    its weights, plus `per_layer_extra` bytes a layer (cache copies), would
    not fit the card beside `reserve_bytes` and a tenth of the card;
    counted from the LM's parameters on the meta device. Prints either."""
    from repro_torch.models.transformer import LM
    lm = LM(cfg, "meta")
    isz = cfg.torch_dtype.itemsize
    per_layer = [sum(p.numel() for p in b.parameters()) * isz
                 + per_layer_extra for b in lm.blocks]
    fixed = (sum(p.numel() for p in lm.parameters()) * isz
             - sum(per_layer) + per_layer_extra * len(per_layer))
    room = 0.9 * torch.cuda.mem_get_info()[1] - reserve_bytes - fixed
    rep = len(cfg.block_pattern)
    n = cfg.n_layers
    while n > rep and sum(per_layer[:n]) > room:
        n -= rep
    need = (fixed + sum(per_layer[:n])) / 1e9
    if n == cfg.n_layers:
        log(f"  {cfg.name} {cfg.dtype}: {need:.2f} GB of weights and "
            f"caches, all {n} layers fit")
        return cfg
    log(f"  {cfg.name} {cfg.dtype}: depth cut from {cfg.n_layers} to {n} "
        f"layers (widths unchanged) to fit {need:.2f} GB of weights and "
        f"caches on the card")
    return cfg.scaled(n_layers=n)


def dense_fp32_parity(torch, cfg, device, card, n_decode=8, front=None):
    """(b) full width in fp32, TF32 off: a 150-token prefill and one decode
    step through K2/K1 ("cuda") and the torch path on the same weights —
    logits within DENSE_LOGIT_RTOL x max(1, max|logit|), K1 and K2 each
    launched once per global layer — then greedy tokens of a ReplicaEngine
    pair over 8 decode steps, equal. Depth is cut if the weights do not
    fit (printed), and by the caller as `PARITY_LAYERS` says. In a MoE model each router's choices in the prefill
    and the decode step are recorded under both impls and compared
    (`routing_report`). `front(0)`: a vision model's patch embeddings,
    before the prompt in every prefill."""
    import numpy as np
    from repro_torch.engine import ReplicaEngine
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = fit_depth(torch, cfg.scaled(dtype="float32"))
    fe = front and front(0)
    n_front = 0 if fe is None else fe.shape[1]
    log(f"  (b) {cfg.name} full width fp32 ({cfg.n_layers} layers, "
        f"{n_global(cfg)} global), attention_impl cuda vs torch")
    model = build_model(cfg)
    params = model.init(0, device)
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                              DENSE_PROMPT)
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=device)[None]
    logits, caches, routes = {}, {}, {}
    ops.reset_launch_counts()
    for impl in ("cuda", "torch"):
        with recording_routers() as routes[impl]:
            logits[impl], caches[impl] = model.prefill(
                params, toks, frontend_embeds=fe, attention_impl=impl)
    pos = torch.tensor([n_front + len(prompt)], dtype=torch.int32,
                       device=device)
    nxt = logits["torch"][:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    cache = {k: {kk: {n: torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, 64)) for n, t in vv.items()}
        for kk, vv in v.items()} for k, v in caches["torch"].items()}
    dl = {}
    for impl in ("cuda", "torch"):
        with recording_routers() as rec:
            dl[impl] = model.decode_step(params, nxt, cache, pos,
                                         kv_lens=pos, attention_impl=impl)[0]
        routes[impl] += rec
    if cfg.n_experts:
        routing_report(cfg, routes)
    counts = ops.launch_counts()
    want = {"decode_attention": n_global(cfg),
            "prefill_attention": n_global(cfg), "append_attention": 0,
            "wkv6": 0, "rglru": 0}
    if counts != want:
        raise AssertionError(f"one prefill and one decode step launched "
                             f"{counts}, not {want}")
    scale = max(1.0, float(logits["torch"].abs().max()))
    err_p = max_err(logits["cuda"], logits["torch"])
    err_d = max_err(dl["cuda"], dl["torch"])
    log(f"  launches of one prefill + one decode step {counts}")
    log(f"  logits max|err| prefill {err_p:.3e}, decode {err_d:.3e}, "
        f"max|logit| {scale:.3f} (tol {DENSE_LOGIT_RTOL} x max(1, "
        f"max|logit|))")
    if not (err_p < DENSE_LOGIT_RTOL * scale
            and err_d < DENSE_LOGIT_RTOL * scale):
        raise AssertionError(f"{cfg.name}: fp32 logits differ between "
                             "attention impls")
    del caches, cache, logits, dl
    streams = {}
    for impl in ("cuda", "torch"):
        eng = ReplicaEngine(cfg, params, n_slots=2, max_ctx=512,
                            attention_impl=impl)
        s = eng.kv.acquire()
        t, _ = eng.prefill_conversation(s, prompt, fe)
        nt = np.zeros(2, np.int32)
        em = np.zeros(2, bool)
        nt[s], em[s] = int(t), True
        seq, _ = eng.decode_steps(nt, em, n_decode)
        streams[impl] = [int(t)] + [int(x) for x in seq[:, s]]
        del eng
    log(f"  greedy tokens cuda  {streams['cuda']}")
    log(f"  greedy tokens torch {streams['torch']}")
    if streams["cuda"] != streams["torch"]:
        raise AssertionError(f"{cfg.name}: greedy tokens differ between "
                             "attention impls")
    del params
    torch.cuda.empty_cache()


def cut_depth(cfg, n_layers: int, tag: str):
    """cfg at full width cut to `n_layers` layers (whole pattern
    repetitions), printed."""
    log(f"  {tag}: {cfg.name} {cfg.dtype} cut from {cfg.n_layers} to "
        f"{n_layers} layers (widths unchanged)")
    return cfg.scaled(n_layers=n_layers)


def dense_serve(torch, cfg, device, card):
    """(c) full width and depth in bf16 under ConServe, through the CUDA
    graphs, strict accounting (`serve_and_count`): 8 of 8 conversations,
    one KV transfer each, K1's launches a positive multiple of the global
    layers, K2's the global layers times the 8 turn-1 prefills, K3 and K4
    at 0."""
    from repro_torch.models import build_model
    log(f"  (c) {cfg.name} full width {cfg.dtype} ({cfg.n_layers} layers), "
        f"EngineServer + ConServe, strict accounting")
    params = build_model(cfg).init(0, device)
    n_conv = 8
    launches, run = serve_and_count(torch, cfg, params, card, PATH_KERNELS,
                                    "", absent=("wkv6", "rglru"),
                                    n_conversations=n_conv)
    L = n_global(cfg)
    k1, k2 = launches["decode_attention"], launches["prefill_attention"]
    if k1 % L:
        raise AssertionError(f"{k1} K1 launches are not {L} a decode step")
    if k2 != L * n_conv:
        raise AssertionError(f"{k2} K2 launches != {L} global layers x "
                             f"{n_conv} turn-1 prefills")
    del params, run
    torch.cuda.empty_cache()
    return launches


def dense_records(recs, launches):
    """Phase 12's numbers for the kernels' JSON line: for K1 and K2, each
    model's served launches and its bf16 records at the served shapes."""
    return {name: {arch: dict(launches=launches[arch][name],
                              **recs[arch][name])
                   for arch in DENSE}
            for name in PATH_KERNELS}


def phase_dense(torch, device, card):
    """Phase 12: for each of the reference's dense family, (a) K1 and K2 at
    its heads, (b) fp32 parity at full width, (d) for gemma3-12b the graphs
    against eager in fp32, (c) served in bf16 at full width and depth; each
    model freed before the next. Returns ({arch: bf16 kernel records},
    {arch: served launches})."""
    import gc

    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    log("phase 12: the dense family at full width — "
        + ", ".join(DENSE))
    recs, launches = {}, {}
    for arch in DENSE:
        cfg = get_config(arch)
        log(f" {arch}: {cfg.n_layers} layers ({n_global(cfg)} global), "
            f"d_model {cfg.d_model}, H {cfg.n_heads} / Hkv {cfg.n_kv_heads}"
            f" of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
            f"norm {cfg.norm}, {cfg.activation}, gated {cfg.gated_mlp}")
        recs[arch] = dense_kernels(torch, cfg)
        dense_fp32_parity(torch, cut_depth(
            cfg.scaled(dtype="float32"), PARITY_LAYERS[arch], "12 (b)")
            if arch in PARITY_LAYERS else cfg, device, card)
        gc.collect()
        if arch == "gemma3-12b":  # the pattern that differs
            graphs_at_depth(torch, cfg.scaled(dtype="float32"), device,
                            card, "12 (d)")
            gc.collect()
        launches[arch] = dense_serve(torch, cfg, device, card)
        gc.collect()
    log(f"phase 12 wall {time.perf_counter() - t0:.1f} s")
    return recs, launches


# --------------------------------------------------------------------------- #
# phase 13: MLA and MoE — deepseek-v2-lite-16b and llama4-scout-17b-a16e
# --------------------------------------------------------------------------- #
MOE_ARCHS = ("deepseek-v2-lite-16b", "llama4-scout-17b-a16e")
# fp32, MLA's absorbed decode against its expanded prefill in each layer on
# the same inputs, relative to max(1, max|out|): the two forms sum the same
# fp32 products in another order (the latent scores against per-head keys)
MLA_LOGIT_RTOL = 1e-3
MLA_PROMPT = 150   # (b): prefill, then MLA_STEPS decode steps
MLA_STEPS = 8
ALL_KERNELS = ("decode_attention", "prefill_attention", "wkv6", "rglru")


class recording_routers:
    """While open, every `apply_moe` call of the model records its router's
    choices: per call (in layer order) the chosen experts (N, K) and the
    gap between the K-th and the (K+1)-th probability (N,) of each token,
    into the list it yields. Off, the model is untouched."""

    def __enter__(self):
        import torch
        from repro_torch.models import blocks
        self.rec, self.orig = [], blocks.apply_moe

        def spy(m, cfg, x, *a, **kw):
            K = cfg.top_k
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ m.router, dim=-1)
            top = torch.topk(probs, min(K + 1, cfg.n_experts), dim=-1)
            gap = (top.values[:, K - 1] - top.values[:, K]
                   if K < cfg.n_experts else top.values[:, -1])
            self.rec.append((top.indices[:, :K].cpu(), gap.cpu()))
            return self.orig(m, cfg, x, *a, **kw)
        blocks.apply_moe = spy
        return self.rec

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        blocks.apply_moe = self.orig
        return False


def routing_report(cfg, routes):
    """Print each router's smallest top-K margin (the gap between its K-th
    and (K+1)-th expert, over the tokens of the prefill and the decode
    step, under the torch impl) and every token whose experts differ
    between the impls, with its margin: a flip is reported, not hidden."""
    flips = []
    margins = []
    for i, ((ec, _), (et, gt)) in enumerate(zip(routes["cuda"],
                                                routes["torch"])):
        margins.append(float(gt.min()))
        for j in (ec != et).any(-1).nonzero().flatten().tolist():
            flips.append((i, j, float(gt[j])))
    n = len(routes["torch"])
    log(f"  routers ({n} calls: the prefill's, then the decode step's, by "
        f"layer): smallest top-{cfg.top_k} margin by call "
        + " ".join(f"{m:.2e}" for m in margins)
        + f"; smallest of all {min(margins):.3e}")
    log(f"  routing flips between impls: {len(flips)}"
        + "".join(f"; call {i} token {j} (margin {g:.3e})"
                  for i, j, g in flips[:20]))


def mla_layers(torch, cfg, params, seq, device):
    """(b), layer by layer on the same inputs: in each layer, the hidden
    state of all of `seq` entering it (the expanded run's), the expanded
    prefill's attention output at the last MLA_STEPS positions against the
    absorbed decode of each of those tokens over the cache of the tokens
    before it. Returns (the largest error relative to max(1, max|out|), by
    layer)."""
    from repro_torch.models.attention import mla_decode, mla_prefill
    from repro_torch.models.blocks import block_prefill
    from repro_torch.models.layers import embed
    errs = []
    with torch.no_grad():
        h = embed(params.embed.w, cfg, seq).to(cfg.torch_dtype)
        for block in params.blocks:
            x = block.ln1(h)
            out, c = mla_prefill(block.attn, cfg, x, 0)
            worst = 0.0
            for p in range(MLA_PROMPT, MLA_PROMPT + MLA_STEPS):
                pos = torch.tensor([p], dtype=torch.int32, device=device)
                got, _ = mla_decode(block.attn, cfg, x[:, p:p + 1], pos,
                                    {n: t[:, :p] for n, t in c.items()})
                want = out[:, p:p + 1]
                worst = max(worst, max_err(got, want)
                            / max(1.0, float(want.abs().max())))
            errs.append(worst)
            h, _ = block_prefill(block, cfg, h, 0)
    return errs


def mla_absorbed_vs_expanded(torch, cfg, params, device):
    """(b) fp32, TF32 off, cf = E/K (dropless, a check-only cut as
    `reduced_config` makes it, so that grouping cannot change routing):
    a 150-token prefill and 8 greedy decode steps through the absorbed
    MLA decode, against one prefill of all 158 tokens through the
    expanded form, K1-K4 launched 0 times (MLA is torch ops under
    "cuda"). Gated: in every layer, on the same inputs, the absorbed
    decode within MLA_LOGIT_RTOL x max(1, max|out|) of the expanded form
    (`mla_layers`); and the rollout's greedy tokens equal the expanded
    run's, or where one differs both tokens lie within twice that
    position's logit difference of the top logit (phase 10's rule). The
    rollout's logits are printed by position beside their noise floor —
    the prefill's position, where both runs take the expanded form and
    differ only in the products' shapes (150 or 158 rows) — and every
    token whose experts differ between the two runs, with its margin: a
    randomly initialised model this deep carries fp32 rounding, and the
    routing's discrete choices, a long way."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.model import merge_decode_cache
    from repro_torch.models.transformer import lm_hidden, lm_logits
    cfg = cfg.scaled(capacity_factor=cfg.n_experts / cfg.top_k)
    log(f"  (b) {cfg.name} fp32 ({cfg.n_layers} layers), cf "
        f"{cfg.capacity_factor:.4f} = E/K (dropless, check only): "
        f"{MLA_PROMPT}-token prefill + {MLA_STEPS} absorbed decode steps "
        f"against one expanded prefill of {MLA_PROMPT + MLA_STEPS}")
    model = build_model(cfg)
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size, MLA_PROMPT)
    ops.reset_launch_counts()
    with recording_routers() as split:
        logits, caches = model.prefill(
            params, torch.as_tensor(prompt, dtype=torch.int32,
                                    device=device)[None],
            attention_impl="cuda")
        first = logits
        nxt = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
        fed, dec = [], []
        for i in range(MLA_STEPS):
            fed.append(int(nxt))
            pos = torch.tensor([MLA_PROMPT + i], dtype=torch.int32,
                               device=device)
            lg, up = model.decode_step(params, nxt, caches, pos,
                                       attention_impl="cuda")
            caches = merge_decode_cache(caches, up)
            dec.append(lg[0])
            nxt = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    del caches
    seq = torch.as_tensor(np.concatenate([prompt, fed]), dtype=torch.int32,
                          device=device)[None]
    with torch.no_grad(), recording_routers() as whole:
        h, _ = lm_hidden(params, cfg, seq, attention_impl="cuda")
        full = lm_logits(params, h[0, MLA_PROMPT - 1:])  # (1 + 8, V)
    dec = torch.stack([first[0]] + dec)
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"an MLA model launched {counts}")
    layer_err = mla_layers(torch, cfg, params, seq, device)
    log(f"  by layer, absorbed decode against the expanded form on the same "
        f"inputs, max|err| / max(1, max|out|): largest {max(layer_err):.3e}"
        f" (tol {MLA_LOGIT_RTOL}); " + " ".join(f"{e:.1e}"
                                             for e in layer_err))
    # each layer's router, token by token: the split run's calls are the
    # prefill's L, then L for each decode step
    L = cfg.n_layers
    flips = []
    for layer in range(L):
        e_full, gap = whole[layer]
        e_split = torch.cat([split[layer][0]] + [
            split[L * (1 + i) + layer][0] for i in range(MLA_STEPS)])
        for t in (e_split != e_full).any(-1).nonzero().flatten().tolist():
            flips.append((layer, t, float(gap[t])))
    V = cfg.vocab_size
    t_dec = dec[:, :V].argmax(-1).tolist()
    t_full = full[:, :V].argmax(-1).tolist()
    per_pos = [max_err(a, b) for a, b in zip(dec, full)]
    scale = max(1.0, float(full.abs().max()))
    log(f"  rollout: logits max|err| by position (the first is the "
        f"prefill's, both runs expanded: the noise floor) "
        + " ".join(f"{e:.2e}" for e in per_pos)
        + f", max|logit| {scale:.3f}; launches {counts}")
    log(f"  routing differences between the split and the whole run: "
        f"{len(flips)}" + "".join(f"; layer {la} token {t} (margin "
                                  f"{g:.3e})" for la, t, g in flips[:20]))
    log(f"  greedy tokens, absorbed decode {t_dec}")
    log(f"  greedy tokens, expanded prefill {t_full}")
    for i, (a, b) in enumerate(zip(t_dec, t_full)):
        if a != b:
            top = float(full[i, :V].max())
            gaps = (top - float(full[i, a]), top - float(full[i, b]))
            log(f"  position {MLA_PROMPT - 1 + i}: tokens {a} / {b}, "
                f"{gaps[0]:.3e} / {gaps[1]:.3e} below the top logit (band "
                f"{2 * per_pos[i]:.3e})")
            if max(gaps) > 2 * per_pos[i]:
                raise AssertionError(f"{cfg.name}: a rollout token differs "
                                     "outside its position's tie band")
    if not max(layer_err) < MLA_LOGIT_RTOL:
        raise AssertionError(f"{cfg.name}: the absorbed MLA decode differs "
                             "from the expanded form")


def deepseek_fp32(torch, cfg, device, card):
    """(b) and (d) on one set of fp32 weights (TF32 off) at
    GRAPH_CHECK_LAYERS[arch] layers (printed; the cut pays for phase 15's
    time): (b) the absorbed decode against the expanded prefill, (d) the
    CUDA graphs against the same bodies run eagerly at the published cf
    (capacity drops inside the graphs), byte-identical."""
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cut_depth(cfg.scaled(dtype="float32"),
                    GRAPH_CHECK_LAYERS[cfg.name], "13 (b, d)")
    params = build_model(cfg).init(0, device)
    mla_absorbed_vs_expanded(torch, cfg, params, device)
    phase_graphs(torch, cfg, params, card, "13 (d)")
    del params
    torch.cuda.empty_cache()


class counting_replays:
    """While open, tally what the replicas' CUDA graphs ran: decode steps
    (a decode program's replay runs its n_steps), turn-1 prefills and
    appends, by program kind."""

    def __enter__(self):
        from repro_torch.engine import programs
        self.orig = programs.Program.replay
        tally = self.tally = {"decode": 0, "prefill": 0, "append": 0}
        orig = self.orig

        def replay(prog, bound):
            orig(prog, bound)
            tally[prog.key[0]] += prog.steps
        programs.Program.replay = replay
        return tally

    def __exit__(self, *exc):
        from repro_torch.engine import programs
        programs.Program.replay = self.orig
        return False


def moe_serve(torch, cfg, device, card, tag):
    """(c) / (e) bf16 under ConServe through the CUDA graphs, strict
    accounting (`serve_and_count`): 8 of 8 conversations, one KV transfer
    each of kv_bytes_per_token x the first input's tokens. deepseek (MLA):
    K1-K4 at 0. llama4-scout (global GQA at G = 5): K1's launches the
    layers x the graphed decode steps, K2's the layers x 8 turn-1
    prefills."""
    from repro_torch.models import build_model
    n_conv = 8
    cache_layer = 3 * GRAPH_SLOTS * 1024 * (
        cfg.kv_bytes_per_token() // cfg.n_layers)
    cfg = fit_depth(torch, cfg, per_layer_extra=cache_layer)
    L = n_global(cfg)
    log(f"  ({tag}) {cfg.name} full width {cfg.dtype} ({cfg.n_layers} "
        f"layers, cf {cfg.capacity_factor}), EngineServer + ConServe, "
        f"strict accounting")
    params = build_model(cfg).init(0, device)
    path = ("decode_attention", "prefill_attention") if L else ()
    with counting_replays() as tally:
        launches, run = serve_and_count(
            torch, cfg, params, card, path, f"({tag}) ",
            absent=tuple(k for k in ALL_KERNELS if k not in path),
            n_conversations=n_conv)
    k1, k2 = check_served(cfg, run, tally, n_conv, L)
    del params, run
    torch.cuda.empty_cache()
    return {"decode_attention": k1, "prefill_attention": k2,
            "layers": cfg.n_layers, "decode_steps": tally["decode"]}


def check_served(cfg, run, tally, n_conv, L):
    """A ConServe run of `n_conv` conversations of the engine trace under
    strict accounting: one transfer a conversation of kv_bytes_per_token
    x its first input's tokens, K1 = `L` layers x the graphed decode
    steps (`tally` of `counting_replays`), K2 = L x n_conv turn-1
    prefills. Returns (K1, K2) launches."""
    from repro_torch.launch.serve import engine_trace
    srv = run["srv"]
    tokens = sum(c.first_input_len for c in engine_trace(n_conv))
    per_tok = cfg.kv_bytes_per_token()
    log(f"  graphs ran {tally['decode']} decode steps, {tally['prefill']} "
        f"turn-1 prefills and {tally['append']} appends; {srv.n_transfers} "
        f"transfers of {srv.transfer_bytes:.0f} B = {per_tok} B x "
        f"{srv.transfer_bytes / per_tok:.0f} tokens (first inputs: "
        f"{tokens} tokens)")
    if srv.n_transfers != n_conv or srv.transfer_bytes != per_tok * tokens:
        raise AssertionError(f"{srv.n_transfers} transfers of "
                             f"{srv.transfer_bytes} B, not {n_conv} of "
                             f"{per_tok} B x {tokens} tokens")
    k1 = run["launches"]["decode_attention"]
    k2 = run["launches"]["prefill_attention"]
    if (k1, k2) != (L * tally["decode"], L * n_conv):
        raise AssertionError(f"K1 {k1} / K2 {k2} launches, not {L} layers x "
                             f"{tally['decode']} graphed decode steps / "
                             f"{L} x {n_conv} turn-1 prefills")
    return k1, k2


def moe_records(recs, launches):
    """Phase 13's numbers for the kernels' JSON line: for K1 and K2, each
    MoE model's served launches, and at llama4-scout's heads (G = 5) the
    bf16 records at the served shapes."""
    return {name: {arch: dict(launches=launches[arch][name],
                              **(recs[name] if arch ==
                                 "llama4-scout-17b-a16e" else {}))
                   for arch in MOE_ARCHS}
            for name in PATH_KERNELS}


def phase_moe(torch, device, card):
    """Phase 13: (a) K1 and K2 at llama4-scout's heads (40 / 8 x 128, G =
    5); deepseek-v2-lite-16b's (b) absorbed MLA decode against the
    expanded prefill and (d) graphs against eager, in fp32, (c) served in
    bf16 at full depth; llama4-scout-17b-a16e (e) served in bf16 and (f)
    fp32 impl parity, each at the depth that fits. Returns (llama4-scout's
    bf16 kernel records, {arch: served launches})."""
    import gc

    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    log("phase 13: MLA and MoE at full width — " + ", ".join(MOE_ARCHS))
    cfgs = {a: get_config(a) for a in MOE_ARCHS}
    for arch, cfg in cfgs.items():
        attn = (f"MLA, {cfg.n_heads} heads, latent {cfg.kv_lora_rank} + "
                f"rope {cfg.qk_rope_dim}" if cfg.kv_lora_rank else
                f"H {cfg.n_heads} / Hkv {cfg.n_kv_heads} of {cfg.head_dim}")
        log(f" {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, {attn}, "
            f"{cfg.n_experts} experts top-{cfg.top_k} of {cfg.d_expert} + "
            f"{cfg.n_shared_experts} shared, cf {cfg.capacity_factor}, "
            f"vocab {cfg.vocab_size}, {cfg.kv_bytes_per_token()} KV bytes "
            f"a token")
    l4, ds = cfgs["llama4-scout-17b-a16e"], cfgs["deepseek-v2-lite-16b"]
    recs = dense_kernels(torch, l4, k2_lengths=(256, 512))
    deepseek_fp32(torch, ds, device, card)
    gc.collect()
    launches = {ds.name: moe_serve(torch, ds, device, card, "c")}
    gc.collect()
    launches[l4.name] = moe_serve(torch, l4, device, card, "e")
    gc.collect()
    log("  (f) llama4-scout fp32, attention_impl cuda vs torch")
    dense_fp32_parity(torch, l4, device, card)
    gc.collect()
    log(f"phase 13 wall {time.perf_counter() - t0:.1f} s")
    return recs, launches


# --------------------------------------------------------------------------- #
# phase 14: the vision frontend and the encoder-decoder — internvl2-26b and
# whisper-small
# --------------------------------------------------------------------------- #
VLM, ENCDEC = "internvl2-26b", "whisper-small"
FRONT_ARCHS = (ENCDEC, VLM)


def front_maker(torch, cfg, device, seed=21):
    """`front(i)`: the i-th seeded (numpy) stub embeddings (1, F, d_model)
    in cfg's dtype, the same at every call with i: F = encoder_seq frames
    for an encoder-decoder, frontend_len patches for a vision model."""
    import numpy as np
    n = cfg.encoder_seq if cfg.is_encoder_decoder else cfg.frontend_len

    def front(i):
        x = np.random.RandomState(seed + i).standard_normal(
            (1, n, cfg.d_model)).astype(np.float32)
        return torch.from_numpy(x).to(device, cfg.torch_dtype)
    return front


def cross_leaves(torch, eng):
    from repro_torch.engine.kvcache import cross, leaves
    return [t.clone() for p, t in leaves(eng.kv.caches) if cross(p)]


def encdec_fp32(torch, cfg, device, card, n_decode=8):
    """(b) whisper-small at full width in fp32 (TF32 off), on seeded
    frames: a 150-token prefill and one decode step under "cuda" and
    "torch" — logits within DENSE_LOGIT_RTOL x max(1, max|logit|), K2 and
    K1 each launched once per decoder layer (the encoder and every
    cross-attention are torch ops) — and 8 greedy decode steps of a
    ReplicaEngine pair, equal; the slot's length the prompt's (F14); the
    cross rows byte-identical before and after an append and a 16-step
    chunk; then phase 11's graphs against eager, byte-identical."""
    import numpy as np
    from repro_torch.engine import ReplicaEngine
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.scaled(dtype="float32")
    log(f"  (b) {cfg.name} full width fp32 ({cfg.n_encoder_layers} encoder "
        f"layers over {cfg.encoder_seq} frames, {cfg.n_layers} decoder "
        f"layers), attention_impl cuda vs torch")
    model = build_model(cfg)
    params = model.init(0, device)
    front = front_maker(torch, cfg, device)
    fe = front(0)
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                              DENSE_PROMPT)
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=device)[None]
    logits, caches = {}, {}
    ops.reset_launch_counts()
    for impl in ("cuda", "torch"):
        logits[impl], caches[impl] = model.prefill(
            params, toks, frontend_embeds=fe, attention_impl=impl)
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device=device)
    nxt = logits["torch"][:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    c = caches["torch"]
    cache = {"self": {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 64))
                      for n, t in c["self"].items()}, "cross": c["cross"]}
    dl = {impl: model.decode_step(params, nxt, cache, pos, kv_lens=pos,
                                  attention_impl=impl)[0]
          for impl in ("cuda", "torch")}
    counts = ops.launch_counts()
    L = cfg.n_layers
    want = {"decode_attention": L, "prefill_attention": L,
            "append_attention": 0, "wkv6": 0, "rglru": 0}
    if counts != want:
        raise AssertionError(f"one prefill and one decode step launched "
                             f"{counts}, not {want}")
    scale = max(1.0, float(logits["torch"].abs().max()))
    err_p = max_err(logits["cuda"], logits["torch"])
    err_d = max_err(dl["cuda"], dl["torch"])
    log(f"  launches of one prefill + one decode step {counts}")
    log(f"  logits max|err| prefill {err_p:.3e}, decode {err_d:.3e}, "
        f"max|logit| {scale:.3f} (tol {DENSE_LOGIT_RTOL} x max(1, "
        f"max|logit|))")
    if not (err_p < DENSE_LOGIT_RTOL * scale
            and err_d < DENSE_LOGIT_RTOL * scale):
        raise AssertionError(f"{cfg.name}: fp32 logits differ between "
                             "attention impls")
    del caches, cache, c, logits, dl
    streams = {}
    for impl in ("cuda", "torch"):
        eng = ReplicaEngine(cfg, params, n_slots=2, max_ctx=512,
                            attention_impl=impl)
        s = eng.kv.acquire()
        t, _ = eng.prefill_conversation(s, prompt, fe)
        if int(eng.kv.lengths[s]) != len(prompt):
            raise AssertionError(f"slot length {int(eng.kv.lengths[s])} != "
                                 f"the prompt's {len(prompt)} (F14)")
        nt = np.zeros(2, np.int32)
        em = np.zeros(2, bool)
        nt[s], em[s] = int(t), True
        seq, _ = eng.decode_steps(nt, em, n_decode)
        streams[impl] = [int(t)] + [int(x) for x in seq[:, s]]
        if impl == "cuda":  # the cross rows stay as the prefill left them
            before = cross_leaves(torch, eng)
            nt[s] = int(eng.append_prefill(s, prompt[:24])[0])
            eng.decode_steps(nt, em, 16)
            same = all(torch.equal(a, b) for a, b in
                       zip(before, cross_leaves(torch, eng)))
            log(f"  cross rows ({sum(t.numel() for t in before)} values) "
                f"byte-identical after an append and 16 decode steps: "
                f"{same}")
            if not same:
                raise AssertionError("an append or a decode step wrote the "
                                     "cross rows")
            del before
        del eng
    log(f"  greedy tokens cuda  {streams['cuda']}")
    log(f"  greedy tokens torch {streams['torch']}")
    if streams["cuda"] != streams["torch"]:
        raise AssertionError(f"{cfg.name}: greedy tokens differ between "
                             "attention impls")
    phase_graphs(torch, cfg, params, card, "14 (b)", front=front,
                 times=False)  # (c) times the bf16 step
    del params
    torch.cuda.empty_cache()


class recording_transfers:
    """While open, record (bytes, length) of every package a slot cache
    measures (`SlotKVCache.nbytes_of`: each KV transfer's bytes)."""

    def __enter__(self):
        from repro_torch.engine.kvcache import SlotKVCache
        self.orig = SlotKVCache.nbytes_of
        rec = self.rec = []
        orig = self.orig

        def nbytes_of(kv, package):
            n = orig(kv, package)
            rec.append((n, package["length"]))
            return n
        SlotKVCache.nbytes_of = nbytes_of
        return rec

    def __exit__(self, *exc):
        from repro_torch.engine.kvcache import SlotKVCache
        SlotKVCache.nbytes_of = self.orig
        return False


def front_serve(torch, cfg, params, card, tag):
    """(c) / (e) bf16 under ConServe through the CUDA graphs (the server
    sends each turn-1 its stub embeddings), strict accounting: 8 of 8
    conversations, one transfer each of kv_bytes_per_token x its length
    plus, for the encoder-decoder, the cross rows; K1's launches the layers
    x the graphed decode steps, K2's the layers x 8 turn-1 prefills (a
    vision model's through their graphs, an encoder-decoder's eagerly).
    Returns the launches."""
    from repro_torch.launch.serve import engine_trace
    n_conv = 8
    L = cfg.n_layers
    per_tok = cfg.kv_bytes_per_token()
    cross_b = (2 * L * cfg.encoder_seq * cfg.n_kv_heads * cfg.head_dim
               * cfg.torch_dtype.itemsize if cfg.is_encoder_decoder else 0)
    n_front = 0 if cfg.is_encoder_decoder else cfg.frontend_len
    with counting_replays() as tally, recording_transfers() as sizes:
        launches, run = serve_and_count(
            torch, cfg, params, card, PATH_KERNELS, f"({tag}) ",
            absent=("wkv6", "rglru"), n_conversations=n_conv)
    srv = run["srv"]
    firsts = sorted(c.first_input_len for c in engine_trace(n_conv))
    lens = sorted(n for _, n in sizes)
    log(f"  graphs ran {tally['decode']} decode steps, {tally['prefill']} "
        f"turn-1 prefills and {tally['append']} appends; {srv.n_transfers} "
        f"transfers of {srv.transfer_bytes:.0f} B: each {cross_b} B of "
        f"cross rows + {per_tok} B x its length (lengths {lens}; first "
        f"inputs {firsts} + {n_front} frontend positions)")
    bad = [(n, k) for n, k in sizes if n != cross_b + per_tok * k]
    if (srv.n_transfers != n_conv or len(sizes) != n_conv or bad
            or lens != [n_front + f for f in firsts]):
        raise AssertionError(f"{srv.n_transfers} transfers {sizes}, not "
                             f"{n_conv} of {cross_b} + {per_tok} B x "
                             f"({n_front} + first input)")
    k1 = run["launches"]["decode_attention"]
    k2 = run["launches"]["prefill_attention"]
    if (k1, k2) != (L * tally["decode"], L * n_conv):
        raise AssertionError(f"K1 {k1} / K2 {k2} launches, not {L} layers x "
                             f"{tally['decode']} graphed decode steps / "
                             f"{L} x {n_conv} turn-1 prefills")
    del run, srv
    return {"decode_attention": k1, "prefill_attention": k2,
            "layers": L, "decode_steps": tally["decode"]}


def encdec_costs(torch, cfg, params, card, front):
    """whisper's share of a graphed step in cross-attention, and its eager
    turn-1 prefill: (1) the 12 layers' cross-attention of 16 slots (one
    query each over the 1500 cross rows) captured in one graph, device
    time, against `step_times`' graphed step; (2) a 150-token turn-1
    prefill's wall time, and the encoder's alone (CUDA events)."""
    import numpy as np
    from repro_torch.engine import ReplicaEngine
    from repro_torch.models.attention import cross_attention
    from repro_torch.models.encdec import run_encoder
    eng = ReplicaEngine(cfg, params, n_slots=GRAPH_SLOTS, max_ctx=1024,
                        attention_impl="cuda")
    step = step_times(torch, eng, card, front)
    caches = eng.kv.caches["cross"]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(GRAPH_SLOTS, 1, cfg.d_model, generator=g,
                    device="cuda").to(cfg.torch_dtype)
    layers = [(blk.cross, {"k": caches["k"][i], "v": caches["v"][i]})
              for i, blk in enumerate(params.decoder)]

    def make(x):
        return lambda: [cross_attention(a, cfg, x, kv) for a, kv in layers]
    nbytes = 2 * caches["k"].numel() * caches["k"].element_size()
    cross_ms = device_ms(make, (x,), nbytes)
    log(f"  [{card}] cross-attention of {cfg.n_layers} layers, "
        f"{GRAPH_SLOTS} slots over {cfg.encoder_seq} rows: {cross_ms:.3f} "
        f"ms device a step, {100 * cross_ms / (step['graph'] * 1e3):.1f}% "
        f"of the graphed step's {step['graph'] * 1e3:.3f} ms wall")
    eng.kv.invalidate_all()
    rs = np.random.RandomState(4)
    fe = front(0)
    walls = []
    for _ in range(3):
        s = eng.kv.acquire()
        walls.append(eng.prefill_conversation(
            s, rs.randint(0, cfg.vocab_size, DENSE_PROMPT), fe)[1])
    enc_ms = cuda_ms(lambda: run_encoder(params, cfg, fe), warmup=2,
                     iters=5, windows=3)
    log(f"  [{card}] eager turn-1 prefill of {DENSE_PROMPT} tokens: wall "
        f"{min(walls) * 1e3:.3f} ms (best of 3), the encoder alone "
        f"{enc_ms:.3f} ms (events)")
    del eng, caches, layers
    torch.cuda.empty_cache()
    return dict(step_ms=step["graph"] * 1e3, cross_ms=cross_ms,
                prefill_ms=min(walls) * 1e3, encoder_ms=enc_ms)


def phase_front(torch, device, card):
    """Phase 14: whisper-small — (a) K1 and K2 at its heads (12 / 12 x 64,
    G = 1), (b) fp32 impl parity, F14 and the cross rows, graphs against
    eager, (c) served in bf16, with its cross-attention's share of the
    step and its eager prefill; internvl2-26b — (d) fp32 impls and graphs
    against eager at the depth that fits, (e) served in bf16 at full width
    and depth. Each model freed before the next. Returns (whisper's bf16
    kernel records, {arch: served launches})."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    log("phase 14: the vision frontend and the encoder-decoder at full "
        "width — " + ", ".join(FRONT_ARCHS))
    w, v = get_config(ENCDEC), get_config(VLM)
    log(f" {ENCDEC}: {w.n_encoder_layers} encoder layers over "
        f"{w.encoder_seq} frames, {w.n_layers} decoder layers with "
        f"cross-attention, d_model {w.d_model}, H {w.n_heads} / Hkv "
        f"{w.n_kv_heads} of {w.head_dim}, vocab {w.vocab_size}")
    log(f" {VLM}: {v.n_layers} layers, d_model {v.d_model}, H {v.n_heads} "
        f"/ Hkv {v.n_kv_heads} of {v.head_dim}, d_ff {v.d_ff}, vocab "
        f"{v.vocab_size}, {v.frontend_len} patch embeddings before the text")
    recs = dense_kernels(torch, w, k2_lengths=(256, 512))
    encdec_fp32(torch, w, device, card)
    gc.collect()
    log(f"  (c) {w.name} full width {w.dtype}, EngineServer + ConServe, "
        f"strict accounting")
    params = build_model(w).init(0, device)
    launches = {w.name: front_serve(torch, w, params, card, "c")}
    costs = encdec_costs(torch, w, params, card, front_maker(torch, w, device))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    f32 = v.scaled(dtype="float32")
    cache_layer = 2 * f32.n_kv_heads * f32.head_dim * 4 * 1024 * GRAPH_SLOTS
    f32 = fit_depth(torch, f32, per_layer_extra=4 * cache_layer)
    f32 = cut_depth(f32, min(f32.n_layers, GRAPH_CHECK_LAYERS[v.name]),
                    "14 (d)")
    log(f"  (d) {v.name} fp32 at {f32.n_layers} layers: impls, then graphs")
    dense_fp32_parity(torch, f32, device, card,
                      front=front_maker(torch, f32, device))
    gc.collect()
    params = build_model(f32).init(0, device)
    phase_graphs(torch, f32, params, card, "14 (d)",
                 front=front_maker(torch, f32, device),
                 times=False)  # (e) times the bf16 step
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (e) {v.name} full width {v.dtype} ({v.n_layers} layers), "
        f"EngineServer + ConServe, strict accounting")
    params = build_model(v).init(0, device)
    launches[v.name] = front_serve(torch, v, params, card, "e")
    from repro_torch.engine import ReplicaEngine
    eng = ReplicaEngine(v, params, n_slots=GRAPH_SLOTS, max_ctx=1024,
                        attention_impl="cuda")
    step_times(torch, eng, card, front_maker(torch, v, device))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 14 wall {time.perf_counter() - t0:.1f} s")
    return recs, launches, costs


def front_records(recs, launches, costs, vlm_recs=None):
    """Phase 14's numbers for the kernels' JSON line: for K1 and K2, each
    model's served launches, whisper's bf16 records at its heads and
    internvl2's at nemotron-4-15b's (48 / 8 x 128: phase 12 (a)) when that
    phase ran; whisper's step, cross-attention and prefill costs."""
    out = {}
    for name in PATH_KERNELS:
        out[name] = {ENCDEC: dict(launches=launches[ENCDEC][name],
                                  **recs[name])}
        vr = (vlm_recs or {}).get(name, {})
        out[name][VLM] = dict(launches=launches[VLM][name], **vr)
    out["whisper_costs_ms"] = costs
    return out


# --------------------------------------------------------------------------- #
# phase 15: training — full-width olmo-1b steps in bf16 (`repro_torch.train`)
# --------------------------------------------------------------------------- #
TRAIN_ARCH = "olmo-1b"
# the reference skeleton's parameters, as Python ints (F10)
TRAIN_PARAMS = 1_177_026_560
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 2048, 8, 2, 4
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
# (b), fp32 with TF32 off at full width and 2 layers: the reference's own
# invariants at its tolerances — flash_vjp on against off (losses 1e-6, as
# tests/test_perf_variants.py; gradients 1e-5 of each leaf's max |g|),
# grad_accum=2 against the full batch (loss relative and gradients 1e-5),
# the remat granularities (losses 1e-5, as tests/test_perf_variants.py)
INV_LAYERS, INV_SEQ, INV_BATCH = 2, 2048, 2
FLASH_LOSS_TOL, FLASH_GRAD_RTOL = 1e-6, 1e-5
ACCUM_RTOL, REMAT_TOL = 1e-5, 1e-5


def train_bound_s(n_params: int, tokens: int) -> float:
    """A step's least time: 6 x N x tokens over the bf16 peak (the model's
    forward and backward matmuls, before remat's extra forward)."""
    return 6 * n_params * tokens / PEAK_FLOPS["bfloat16"]


def refuse_grad_launch(torch, device):
    """A grad-requiring call to a kernel raises before it launches."""
    from repro_torch.kernels import ops
    q = torch.zeros(1, 64, 16, 128, device=device, dtype=torch.bfloat16,
                    requires_grad=True)
    before = ops.launch_counts()
    try:
        ops.prefill_attention(q, q.detach(), q.detach(), impl="cuda")
    except RuntimeError as e:
        log(f"  guard: a grad-requiring ops.prefill_attention raised: {e}")
    else:
        raise AssertionError("ops.prefill_attention launched with an input "
                             "that requires grad")
    if ops.launch_counts() != before:
        raise AssertionError("the refused call moved a launch counter")


def traced_step(torch, fn):
    """Run `fn()` once under `torch.profiler` (CUDA activity only): (its
    result, device-busy seconds, kernel launches, seconds the trace's
    processing took)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile import kernel_rows
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = kernel_rows(prof)
    return (out, sum(r[1] for r in rows) / 1e6, sum(r[2] for r in rows),
            time.perf_counter() - t0)


def train_run(torch, cfg, device, card, flash: bool):
    """(a) TRAIN_STEPS AdamW steps of full-width cfg in bf16 from a seeded
    torch init on `SyntheticLM` at TRAIN_SEQ x TRAIN_BATCH, grad_accum
    TRAIN_ACCUM, remat at the config's "group": each step's loss (finite,
    falling from the first to the last), the first step traced (device
    busy, kernel launches) as the warm-up, the later ones timed by CUDA
    events (median), tokens/s, peak memory, the bound; K1-K4's counters
    still at 0 after every step. Returns (model, params, state, data, the
    step function) for (c)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                                   adamw_init, make_train_step)
    cfg = cfg.scaled(flash_vjp=flash)
    tag = f"flash_vjp {'on' if flash else 'off'}"
    model = build_model(cfg)
    params = model.init(0, device)
    opt = adamw_init(params)
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT),
                           grad_accum=TRAIN_ACCUM)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    tokens = TRAIN_SEQ * TRAIN_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        batch = data.batch(i)
        if i == 0:
            t0 = time.perf_counter()
            (params, opt, m), busy, n_k, t_proc = traced_step(
                torch, lambda: step(params, opt, batch))
            wall = time.perf_counter() - t0 - t_proc
            log(f"  [{card}] (a) {tag} step 1 (warm-up, traced): wall "
                f"{wall:.3f} s, device busy {busy:.3f} s, {n_k} kernel "
                f"launches a step (the trace's processing {t_proc:.1f} s)")
        else:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            params, opt, m = step(params, opt, batch)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1) / 1e3)
        losses.append(float(m["loss"]))
        log(f"  [{card}] (a) {tag} step {i + 1}: loss {losses[-1]:.6f}, "
            f"grad_norm {float(m['grad_norm']):.4f}, lr "
            f"{float(m['lr']):.3e}"
            + (f", {times[-1] * 1e3:.1f} ms" if i else ""))
        if any(ops.launch_counts().values()):
            raise AssertionError(f"a training step launched a port kernel: "
                                 f"{ops.launch_counts()}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"(a) {tag}: losses {losses} are not finite "
                             "and falling")
    med = float(np.median(times))
    bound = train_bound_s(TRAIN_PARAMS, tokens)
    log(f"  [{card}] (a) {tag}: step {med * 1e3:.1f} ms (median of steps "
        f"2-{TRAIN_STEPS}, CUDA events), {tokens / med:.1f} tokens/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; bound "
        f"6 x {TRAIN_PARAMS:,} x {tokens:,} = "
        f"{6 * TRAIN_PARAMS * tokens:.3e} FLOP over 989 TFLOP/s = "
        f"{bound * 1e3:.1f} ms ({med / bound:.2f}x); K1-K4 launches "
        f"{ops.launch_counts()}")
    return model, params, opt, data, step, {
        "flash_vjp": flash, "losses": losses, "step_ms": med * 1e3,
        "tokens_per_s": tokens / med, "bound_ms": bound * 1e3,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": n_k, "device_busy_s_step1": busy}


def train_checkpoint(torch, model, params, opt, data, step, card):
    """(c) a bf16 checkpoint of (a)'s params and AdamW state, saved and
    restored (into an uninitialised module and the state's meta skeleton)
    bit-exactly, then one more step from each with the same loss."""
    from repro_torch.train import (adamw_state_skeleton, restore_checkpoint,
                                   save_checkpoint)
    d = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    log(f"  (c) checkpoint under {d.relative_to(ROOT)}: "
        f"{shutil.disk_usage(d).free / 2**30:.1f} GiB free on its disk")
    t0 = time.perf_counter()
    path = save_checkpoint(d, TRAIN_STEPS, params, opt)
    n_bytes = sum(f.stat().st_size for f in Path(path).iterdir())
    t1 = time.perf_counter()
    sk = model.module(params.embed.w.device)
    p2, o2, _ = restore_checkpoint(d, TRAIN_STEPS, sk,
                                   adamw_state_skeleton(sk))
    t2 = time.perf_counter()

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    same = all(torch.equal(bits(a), bits(b)) for a, b in
               zip(params.parameters(), p2.parameters()))
    for sec in ("mu", "nu"):
        same &= all(torch.equal(opt[sec][n], o2[sec][n]) for n in opt[sec])
    same &= int(opt["step"]) == int(o2["step"])
    log(f"  [{card}] (c) saved {n_bytes / 1e9:.3f} GB in {t1 - t0:.1f} s, "
        f"restored in {t2 - t1:.1f} s: bit-exact {same}")
    if not same:
        raise AssertionError("(c) the restored checkpoint differs")
    batch = data.batch(TRAIN_STEPS)
    _, _, m1 = step(params, opt, batch)
    _, _, m2 = step(p2, o2, batch)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    log(f"  [{card}] (c) step {TRAIN_STEPS + 1}: loss {l1:.6f} without the "
        f"round trip, {l2:.6f} from the restored checkpoint")
    if l1 != l2:
        raise AssertionError("(c) the step from the restored checkpoint "
                             "has another loss")
    shutil.rmtree(d, ignore_errors=True)


def leaf_gap(g1, g2):
    """The largest gap of two gradient dicts, each leaf's relative to its
    max |g1|."""
    return max(float((g1[n].float() - g2[n].float()).abs().max())
               / max(float(g1[n].float().abs().max()), 1e-30) for n in g1)


def train_invariants(torch, cfg, device, card):
    """(b) fp32 with TF32 off at full width and INV_LAYERS layers, one
    seeded batch of INV_BATCH x INV_SEQ: flash_vjp on against off, then
    grad_accum=2 against the full batch, then the remat granularities,
    each at its tolerance (module constants)."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.train import DataConfig, SyntheticLM
    from repro_torch.train.train_step import make_grad_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.scaled(dtype="float32", n_layers=INV_LAYERS)
    log(f"  (b) fp32 at full width, {INV_LAYERS} layers, batch {INV_BATCH} "
        f"x {INV_SEQ}")
    params = build_model(cfg).init(0, device)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=INV_SEQ,
                                   global_batch=INV_BATCH)).batch(0)

    def grads(**over):
        c = dataclasses.replace(cfg, **{k: v for k, v in over.items()
                                        if k != "grad_accum"})
        return make_grad_fn(build_model(c),
                            grad_accum=over.get("grad_accum", 1))(params,
                                                                  batch)

    l0, g0 = grads()
    l1, g1 = grads(flash_vjp=True)
    gap_l, gap_g = abs(float(l1) - float(l0)), leaf_gap(g0, g1)
    log(f"  [{card}] (b) flash_vjp on vs off: loss {float(l0):.7f} vs "
        f"{float(l1):.7f} (|diff| {gap_l:.3e}, tol {FLASH_LOSS_TOL}), "
        f"gradients {gap_g:.3e} of each leaf's max |g| (tol "
        f"{FLASH_GRAD_RTOL})")
    if gap_l > FLASH_LOSS_TOL or gap_g > FLASH_GRAD_RTOL:
        raise AssertionError("(b) flash_vjp changes the loss or gradients")
    la, ga = grads(grad_accum=2)
    gap_l = abs(float(la) - float(l0)) / abs(float(l0))
    gap_g = leaf_gap(g0, ga)
    log(f"  [{card}] (b) grad_accum=2 vs the full batch: loss {float(la):.7f}"
        f" ({gap_l:.3e} relative), gradients {gap_g:.3e} of each leaf's "
        f"max |g| (tol {ACCUM_RTOL})")
    if gap_l > ACCUM_RTOL or gap_g > ACCUM_RTOL:
        raise AssertionError("(b) grad_accum=2 differs from the full batch")
    del g1, ga
    losses = {g: float(grads(remat_granularity=g)[0])
              for g in ("group", "layer", "both")}
    spread = max(losses.values()) - min(losses.values())
    log(f"  [{card}] (b) remat granularities: losses {losses}, spread "
        f"{spread:.3e} (tol {REMAT_TOL})")
    if spread > REMAT_TOL:
        raise AssertionError("(b) the remat granularities disagree")
    del params, g0
    torch.cuda.empty_cache()


def phase_train(torch, device, card):
    """Phase 15: training — (a) full-width olmo-1b in bf16, TRAIN_STEPS
    AdamW steps with flash_vjp off (the published config) and on, (c) the
    second run's checkpoint round trip, (b) the fp32 invariants. Returns
    each (a) run's record."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    n = sum(p.numel() for p in build_model(cfg).module("meta").parameters())
    log(f"phase 15: training {cfg.name} at full width in {cfg.dtype}: "
        f"{cfg.n_layers} x {cfg.d_model}, {cfg.n_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n:,} parameters, remat "
        f"{cfg.remat_granularity}; SyntheticLM {TRAIN_BATCH} x {TRAIN_SEQ},"
        f" grad_accum {TRAIN_ACCUM}, AdamW {TRAIN_OPT}")
    if n != TRAIN_PARAMS:
        raise AssertionError(f"{n} parameters, not {TRAIN_PARAMS}")
    refuse_grad_launch(torch, device)
    recs = []
    for flash in (False, True):
        model, params, opt, data, step, rec = train_run(torch, cfg, device,
                                                        card, flash)
        recs.append(rec)
        if flash:
            train_checkpoint(torch, model, params, opt, data, step, card)
        del model, params, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    train_invariants(torch, cfg, device, card)
    gc.collect()
    from repro_torch.kernels import ops
    if any(ops.launch_counts().values()):
        raise AssertionError(f"phase 15 launched a port kernel: "
                             f"{ops.launch_counts()}")
    log(f"phase 15 wall {time.perf_counter() - t0:.1f} s")
    return recs


# --------------------------------------------------------------------------- #
# phase 16: launch and sharding
# --------------------------------------------------------------------------- #
# (tag, arch, shape, config overrides): rank 0 of the 16x16 production mesh
LAUNCH_CELLS = (("a", "qwen3-0.6b", "decode_32k", {}),
                ("b", "olmo-1b", "train_4k", {"flash_vjp": True}))


def launch_cell(torch, tag, arch, shape, overrides, card):
    """One cell's meta estimate and rank 0's run on the card under the fake
    group, full width and depth: the argument bytes must agree exactly and
    the output must be finite. Returns the cell's record."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import measure, run_on_card
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell
    cfg = get_config(arch).scaled(**overrides) if overrides else None
    t0 = time.perf_counter()
    fn, args = build_cell(arch, shape, make_production_mesh(device="meta"),
                          cfg=cfg)
    _, est = measure(fn, args)
    del fn, args
    mem = est["memory"]
    log(f"  16 ({tag}) {arch} {shape} meta estimate in {est['trace_s']} s: "
        f"{mem}; flops/device {est['flops']:.4e} (global "
        f"{est['flops_global']:.4e}), bytes accessed {est['bytes_accessed']}"
        f", collectives {est['collective_total']} B "
        f"{est['collective_counts']}, {est['local_ops']} local ops")
    out, dev = run_on_card(arch, shape, False, cfg)
    if dev["argument_bytes"] != mem["argument_bytes"]:
        raise AssertionError(f"16 ({tag}): {dev['argument_bytes']} argument "
                             f"bytes on the card, {mem['argument_bytes']} "
                             f"in the estimate")
    if tag == "a":
        logits = out[0].to_local()
        shown = f"logits local {tuple(logits.shape)} of {tuple(out[0].shape)}"
        finite = bool(torch.isfinite(logits.float()).all())
    else:
        loss = out[2]["loss"]
        loss = float(loss.to_local() if hasattr(loss, "to_local") else loss)
        shown = f"loss {loss:.6f}"
        finite = math.isfinite(loss)
    est_bytes = mem["argument_bytes"] + mem["temp_bytes"]
    peak = dev["measured_peak_bytes"]
    log(f"  16 ({tag}) on the card ({card}) in {dev['run_s']} s: arguments "
        f"{dev['argument_bytes']} B (= the estimate's), measured peak {peak}"
        f" B beside arguments + temp {est_bytes} B (ratio "
        f"{peak / est_bytes:.4f}); {shown}")
    if not finite:
        raise AssertionError(f"16 ({tag}): non-finite output ({shown})")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "shape": shape, "overrides": overrides,
            "memory": mem, "measured_peak_bytes": peak,
            "peak_over_estimate": peak / est_bytes, "flops": est["flops"],
            "flops_global": est["flops_global"],
            "bytes_accessed": est["bytes_accessed"],
            "collective_bytes": est["collective_bytes"],
            "collective_counts": est["collective_counts"],
            "local_ops": est["local_ops"], "trace_s": est["trace_s"],
            "card_run_s": dev["run_s"], "output": shown,
            "wall_s": round(time.perf_counter() - t0, 2)}


def phase_launch(torch, card):
    """Phase 16: launch and sharding — rank 0 of two cells of the 16x16
    production mesh (256 ranks of torch's fake process group, every
    collective a no-op): (a) qwen3-0.6b decode_32k, (b) olmo-1b train_4k
    with flash_vjp. Returns the cells' records."""
    from repro_torch.launch.mesh import world
    t0 = time.perf_counter()
    log("phase 16: launch and sharding on the 16x16 mesh (fake process "
        "group, rank 0)")
    with world(256):
        recs = {tag: launch_cell(torch, tag, arch, shape, over, card)
                for tag, arch, shape, over in LAUNCH_CELLS}
    recs["wall_s"] = round(time.perf_counter() - t0, 2)
    log(f"phase 16 wall {recs['wall_s']:.1f} s")
    return recs


# --------------------------------------------------------------------------- #
# phase 17: the prefix pool on the card, qwen3-0.6b
# --------------------------------------------------------------------------- #
# (a) the fleet of benchmarks/prefix_reuse.py in its non-quick form
POOL_CONVS, POOL_PREAMBLE, POOL_DELTA = 16, 192, 64
POOL_SLOTS, POOL_MAX_CTX, POOL_PASSES = 4, 512, 3
# (b) each served replica's pool
SERVED_POOL_TOKENS = 1024


def pool_fleet(vocab):
    """The reference benchmark's fleet (its `_fleet`): one shared preamble
    and a delta each, from RandomState(7)."""
    import numpy as np
    rng = np.random.RandomState(7)
    pre = rng.randint(0, vocab, size=POOL_PREAMBLE).astype(np.int32)
    return pre, [rng.randint(0, vocab, size=POOL_DELTA).astype(np.int32)
                 for _ in range(POOL_CONVS)]


def pool_pass(eng, pre, deltas):
    """Each conversation's turn-1 split at the preamble, its slot released
    at once (the fleet outnumbers the slots: pool reuse, not slot reuse, is
    under test). Returns per conversation (token, dt, hit, K2 launches)."""
    import numpy as np
    from repro_torch.kernels import ops
    out = []
    pool = eng.prefix_pool
    for delta in deltas:
        hits = pool.total_hits if pool is not None else 0
        k2 = ops.launch_counts()["prefill_attention"]
        slot = eng.kv.acquire()
        tok, dt = eng.prefill_conversation(
            slot, np.concatenate([pre, delta]), prefix_len=len(pre))
        eng.kv.release(slot)
        out.append((int(tok), dt,
                    pool is not None and pool.total_hits > hits,
                    ops.launch_counts()["prefill_attention"] - k2))
    return out


def pool_replica(torch, cfg, params, card):
    """Phase 17 (a) in one dtype: the fleet through a pooled and a
    pool-less replica (CUDA graphs), a warm pass and POOL_PASSES measured
    ones each, and a pooled one with `cuda_graphs=False` (the hit's body
    run eagerly, for its time), a warm pass and one measured one. Gates: tokens equal pooled vs
    pool-less in every pass; 1 miss + 15 hits in the warm pass, 16 hits in
    each measured one; K2 launched once a layer by each miss and never by
    a hit; the median hit dt <= the median miss dt (the reference's CI gate
    pooled >= no-pool, per prefill). Returns its record."""
    import numpy as np
    from repro_torch.engine import ReplicaEngine
    L = cfg.n_layers
    pre, deltas = pool_fleet(cfg.vocab_size)
    ctx_tokens = POOL_CONVS * (POOL_PREAMBLE + POOL_DELTA)
    runs = {}
    for name, pool, graphs, n in (("no_pool", 0, True, POOL_PASSES),
                                  ("pooled", 4 * POOL_PREAMBLE, True,
                                   POOL_PASSES),
                                  ("pooled_eager", 4 * POOL_PREAMBLE, False,
                                   1)):
        eng = ReplicaEngine(cfg, params, n_slots=POOL_SLOTS,
                            max_ctx=POOL_MAX_CTX, attention_impl="cuda",
                            prefix_pool_tokens=pool, cuda_graphs=graphs)
        passes = [pool_pass(eng, pre, deltas) for _ in range(1 + n)]
        runs[name] = dict(passes=passes, compile_s=eng.compile_s)
        del eng
    toks = {n: [[p[0] for p in ps] for ps in r["passes"]]
            for n, r in runs.items()}
    if toks["pooled"] != toks["no_pool"]:
        raise AssertionError(f"{cfg.dtype}: pool on/off changed the "
                             f"sampled turn-1 tokens")
    for n in ("pooled", "pooled_eager"):
        got = [[p[2] for p in ps] for ps in runs[n]["passes"]]
        want = [[False] + [True] * (POOL_CONVS - 1)] + \
            [[True] * POOL_CONVS] * (len(got) - 1)
        if got != want:
            raise AssertionError(f"{cfg.dtype} {n}: hits by pass {got}")
    for n, r in runs.items():
        bad = [p for ps in r["passes"] for p in ps
               if p[3] != (0 if p[2] else L)]
        if bad:
            raise AssertionError(f"{cfg.dtype} {n}: K2 launched {bad[0][3]}"
                                 f" times by a {'hit' if bad[0][2] else 'miss'}"
                                 f", not {0 if bad[0][2] else L}")

    def measured(n, hit):
        return [p[1] for ps in runs[n]["passes"][1:] for p in ps
                if p[2] == hit]
    miss_ms = 1e3 * float(np.median(measured("no_pool", False)))
    hit_ms = 1e3 * float(np.median(measured("pooled", True)))
    eager_ms = 1e3 * float(np.median(measured("pooled_eager", True)))
    tok_s = {n: [ctx_tokens / sum(p[1] for p in ps)
                 for ps in r["passes"][1:]] for n, r in runs.items()}
    n_eq = sum(a == b for ps, qs in zip(toks["pooled_eager"],
                                        toks["pooled"])
               for a, b in zip(ps, qs))
    log(f"  (a) {cfg.dtype}: {POOL_CONVS} conversations x ({POOL_PREAMBLE}"
        f" shared + {POOL_DELTA}) tokens, {POOL_SLOTS} slots of "
        f"{POOL_MAX_CTX}, pool {4 * POOL_PREAMBLE} tokens: tokens equal "
        f"pooled vs no-pool in all {1 + POOL_PASSES} passes; 1 miss + "
        f"{POOL_CONVS - 1} hits, then {POOL_CONVS} hits a pass; K2 {L} a "
        f"miss, 0 a hit; the eager run's tokens equal the graphed ones' "
        f"{n_eq} of {2 * POOL_CONVS}")
    log(f"  [{card}] (a) {cfg.dtype}: turn-1 context tok/s by measured "
        f"pass: no-pool {', '.join(f'{x:.1f}' for x in tok_s['no_pool'])}"
        f"; pooled {', '.join(f'{x:.1f}' for x in tok_s['pooled'])}; "
        f"pooled, eager hits "
        f"{', '.join(f'{x:.1f}' for x in tok_s['pooled_eager'])}")
    log(f"  [{card}] (a) {cfg.dtype}: median dt, miss (no-pool) "
        f"{miss_ms:.3f} ms, graphed hit {hit_ms:.3f} ms, eager hit "
        f"(cuda_graphs=False) {eager_ms:.3f} ms; compile_s "
        + ", ".join(f"{n} {r['compile_s']:.3f} s" for n, r in runs.items()))
    if not hit_ms <= miss_ms:
        raise AssertionError(f"{cfg.dtype}: the median hit {hit_ms:.3f} ms "
                             f"is slower than the median miss "
                             f"{miss_ms:.3f} ms")
    return {"miss_ms": round(miss_ms, 4), "hit_ms": round(hit_ms, 4),
            "eager_hit_ms": round(eager_ms, 4),
            "tok_s": {n: [round(x, 1) for x in v] for n, v in tok_s.items()},
            "compile_s": {n: round(r["compile_s"], 3)
                          for n, r in runs.items()}}


def fleet_trace(n):
    """`shared_preamble_fleet` at engine scale: 3 preambles of 64 tokens,
    share 0.8, bursts of 4, first inputs up to 400."""
    from repro_torch.traces import make_scenario
    return make_scenario("shared_preamble_fleet", n, seed=0, scale="engine")


@contextlib.contextmanager
def counting_appends():
    """Count the replicas' appends and pool hits: the (append-)prefills
    against a slot's prefix (`ReplicaEngine._run_prefill` with a ctx),
    through a graph or eagerly."""
    from repro_torch.engine import ReplicaEngine
    orig = ReplicaEngine._run_prefill
    state = {"n": 0}

    def counted(self, prog, host, ctx, *args, **kw):
        state["n"] += ctx is not None
        return orig(self, prog, host, ctx, *args, **kw)
    ReplicaEngine._run_prefill = counted
    try:
        yield state
    finally:
        ReplicaEngine._run_prefill = orig


@contextlib.contextmanager
def counting_turn1_prefills():
    """Count the server's turn-1 prefills, arrivals and replays: the calls
    of `ReplicaEngine.prefill_conversation` from outside it (a miss calls
    it once more, on its preamble)."""
    from repro_torch.engine import ReplicaEngine
    orig = ReplicaEngine.prefill_conversation
    state = {"depth": 0, "n": 0}

    def counted(self, *args, **kw):
        state["n"] += state["depth"] == 0
        state["depth"] += 1
        try:
            return orig(self, *args, **kw)
        finally:
            state["depth"] -= 1
    ReplicaEngine.prefill_conversation = counted
    try:
        yield state
    finally:
        ReplicaEngine.prefill_conversation = orig


def pool_served(torch, cfg, params, card):
    """Phase 17 (b), fp32: `fleet_trace(8)` under ConServe, 1 prefiller +
    2 decoders of 16 slots of 1024, pool off, pool on (every replica
    SERVED_POOL_TOKENS) and pool on with decoder 1 killed as it begins
    decoding a turn >= 1. One set of replicas serves the three runs (their
    graphs captured as the first needs them, the time paid once), each run
    from counters at 0 and new pools. Gates: streams byte-identical off vs
    on; the killed run's equal to the pool-on run's by phase 10's rule;
    the prefiller hit; K2 launched once a layer by each turn-1 prefill the
    pool did not serve. Returns each run's record."""
    from repro_torch.core.runtime import PrefixKVPool
    from repro_torch.engine import ReplicaEngine
    from repro_torch.launch.serve import engine_roles
    L = cfg.n_layers
    reps = [ReplicaEngine(cfg, params, n_slots=16, max_ctx=1024,
                          replica_id=i, role=role, attention_impl="cuda")
            for i, role in enumerate(engine_roles("conserve"))]
    recs, runs = {}, {}
    for label, pool, cls in (("pool off", 0, None),
                             ("pool on", SERVED_POOL_TOKENS, None),
                             ("pool on, killed", SERVED_POOL_TOKENS,
                              kill_when_decoding())):
        for r in reps:
            r.prefix_pool = PrefixKVPool(pool) if pool else None
            r.compute_s = r.compile_s = r.decode_s = r.prefill_s = 0.0
            r.n_prefill_tokens = r.n_decode_tokens = 0
            r.n_pooled_prefix_tokens = 0
        with counting_turn1_prefills() as turn1:
            _, run = serve_and_count(
                torch, cfg, params, card, PATH_KERNELS, f"(b) {label}: ",
                server_cls=cls, trace=fleet_trace, reps=reps)
        srv = run["srv"]
        hits = sum(r.prefix_pool.total_hits for r in reps
                   if r.prefix_pool is not None)
        k2 = run["launches"]["prefill_attention"]
        pre_tok = sum(r.n_prefill_tokens for r in reps)
        pre_s = sum(r.prefill_s for r in reps)
        log(f"    {turn1['n']} turn-1 prefills, {hits} pool hits (the "
            f"prefiller's {srv.states[0].pooled_prefix_hits}), "
            f"{sum(r.n_pooled_prefix_tokens for r in reps)} pooled prefix "
            f"tokens, K2 {k2} = {L} x {k2 / L:g}")
        if k2 != L * (turn1["n"] - hits):
            raise AssertionError(f"{label}: K2 launched {k2} times, not "
                                 f"{L} x ({turn1['n']} turn-1 prefills - "
                                 f"{hits} hits)")
        if pool and srv.states[0].pooled_prefix_hits <= 0:
            raise AssertionError(f"{label}: the prefiller's pool was never "
                                 f"hit")
        s = run["summary"]
        recs[label] = {
            "ttfet_p95_s": round(s["ttfet_p95"], 4),
            "last_tbt_gmean_ms": round(s["last_tbt_gmean"] * 1e3, 3),
            "last_tbt_p95_ms": round(s["last_tbt_p95"] * 1e3, 3),
            "prefill_tok_s": round(pre_tok / pre_s, 1),
            "turn1_prefills": turn1["n"], "pool_hits": hits,
            "compile_s": round(sum(r.compile_s for r in reps), 3),
            "launches": run["launches"]}
        if cls is not None:
            if srv.killed is None or srv.n_recoveries < 1:
                raise AssertionError("decoder 1 never decoded a turn >= 1")
            cid, turn, _, t_kill = srv.killed
            log(f"    killed decoder 1 at {t_kill:.4f} s as conversation "
                f"{cid} began decoding turn {turn}; recoveries "
                f"{srv.n_recoveries}")
            recs[label]["recoveries"] = srv.n_recoveries
        runs[label] = run
    off, on = runs["pool off"]["streams"], runs["pool on"]["streams"]
    n_eq, n = count_equal(off, on)
    log(f"  (b) {n_eq} of {n} (cid, turn) streams byte-identical pool off "
        f"vs on")
    if on != off:
        for cid, turn, pos in first_divergences(off, on):
            tie_report(torch, cfg, params, runs["pool on"]["srv"], off, on,
                       cid, turn, pos, params.device, trace=fleet_trace)
        raise AssertionError("fp32 streams differ pool off vs on")
    killed = runs["pool on, killed"]
    n_eq, n = count_equal(on, killed["streams"])
    log(f"  (b) {n_eq} of {n} (cid, turn) streams of the killed run "
        f"byte-identical to the pool-on run's")
    for cid, turn, pos in first_divergences(on, killed["streams"]):
        in_band, band = tie_report(torch, cfg, params, killed["srv"], on,
                                   killed["streams"], cid, turn, pos,
                                   params.device, trace=fleet_trace)
        if not (in_band and band <= NEAR_TIE_BAND_MAX):
            raise AssertionError("fp32 replay with the pool on diverged, "
                                 "not at a near-tie")
    recs["streams_equal"] = {"off_vs_on": count_equal(off, on),
                             "killed_vs_on": (n_eq, n)}
    return recs


def phase_pool(torch, device, card):
    """Phase 17: the prefix pool on the card — qwen3-0.6b at full width,
    seeded weights, CUDA graphs, TF32 off: (a) the replica level in bf16
    and fp32, (b) served in fp32. Returns its records."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    log(f"phase 17: {cfg.name} full width, the prefix pool: a hit folds "
        f"the pooled rows and replays the append graph of its miss")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs = {}
    for dtype in ("bfloat16", "float32"):
        c = cfg.scaled(dtype=dtype)
        params = build_model(c).init(0, device)
        recs[f"a_{dtype}"] = pool_replica(torch, c, params, card)
        if dtype == "float32":
            recs["b"] = pool_served(torch, c, params, card)
        del params
        torch.cuda.empty_cache()
    recs["wall_s"] = round(time.perf_counter() - t0, 2)
    log(f"phase 17 wall {recs['wall_s']:.1f} s")
    return recs


# --------------------------------------------------------------------------- #
# phase 18: the quantized decode tail (an int8 KV cache)
# --------------------------------------------------------------------------- #
INT8 = {"kv_cache_dtype": "int8"}


def int8_fp32_parity(torch, cfg, device, card):
    """(b) phase 4's `impl_parity` with the int8 cache (every K1 call
    handed the int8 rows), then the CUDA graphs against the same bodies
    run eagerly, byte-identical (gate)."""
    from repro_torch.models import build_model
    log(f"  (b) {cfg.name} full width fp32 ({cfg.n_layers} layers), int8 "
        f"cache, attention_impl cuda vs torch")
    params = build_model(cfg).init(0, device)
    tokens = impl_parity(torch, cfg, params, device)
    phase_graphs(torch, cfg, params, card, "18 (b)", times=False)
    del params
    torch.cuda.empty_cache()
    return {"tokens": tokens}


def int8_serve(torch, cfg, device, card, bf16_streams, steps=False):
    """(c) bf16 with an int8 cache under ConServe on phase 5b's trace
    (`serve_and_count`): 8 of 8 conversations, one transfer each of
    kv_bytes_per_token (57,344 B) x its first input's tokens, K1 = layers
    x the graphed decode steps, K2 = layers x 8 turn-1 prefills; the
    streams equal to 5b's counted, not gated (quantization changes
    tokens). With `steps`, `step_times` of a 16-slot replica with the int8
    cache and of one with the bf16 cache, on the same weights."""
    from repro_torch.engine import ReplicaEngine
    from repro_torch.models import build_model
    n_conv, L = 8, cfg.n_layers
    log(f"  (c) {cfg.name} full width {cfg.dtype}, int8 cache, "
        f"EngineServer + ConServe, strict accounting")
    params = build_model(cfg).init(0, device)
    with counting_replays() as tally:
        launches, run = serve_and_count(
            torch, cfg, params, card, PATH_KERNELS, "(c) ",
            absent=("append_attention", "wkv6", "rglru"),
            n_conversations=n_conv)
    if cfg.kv_bytes_per_token() != 57_344:
        raise AssertionError(f"{cfg.kv_bytes_per_token()} KV bytes a token "
                             "with an int8 cache, not 57,344")
    k1, k2 = check_served(cfg, run, tally, n_conv, L)
    n_eq, n_all = count_equal(bf16_streams, run["streams"])
    log(f"  {n_eq} of {n_all} streams equal to 5b's (bf16 cache; "
        f"quantization changes tokens, not gated)")
    s = run["summary"]
    rec = {"decode_attention": k1, "prefill_attention": k2,
           "decode_steps": tally["decode"], "transfer_bytes":
           run["srv"].transfer_bytes, "streams_equal_to_5b": [n_eq, n_all],
           "ttfet_p95_s": s["ttfet_p95"],
           "last_tbt_gmean_ms": s["last_tbt_gmean"] * 1e3,
           "last_tbt_p95_ms": s["last_tbt_p95"] * 1e3}
    del run
    if steps:
        for c, label in ((cfg, "int8 cache"),
                         (cfg.scaled(kv_cache_dtype=""), "bf16 cache")):
            log(f"  (c) the graphed decode step, {label}:")
            eng = ReplicaEngine(c, params, n_slots=GRAPH_SLOTS, max_ctx=1024,
                                attention_impl="cuda")
            rec[f"step_{label.split()[0]}"] = step_times(torch, eng, card)
            del eng
            torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return rec


def phase_int8(torch, cfg, device, card, bf16_streams, full=False):
    """Phase 18 on qwen3-0.6b with `kv_cache_dtype="int8"`: (a) K1 reading
    the int8 cache against its plain version at phase 3's cases (the 256
    bucket; all three with `full`), (b) `int8_fp32_parity`, (c)
    `int8_serve` (with the graphed decode steps when `full`). Returns (the
    bf16 record at the 256 bucket, the records)."""
    t0 = time.perf_counter()
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = cfg.kv_quant_scale
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 18: {cfg.name} with an int8 KV cache (int8 x {scale}): K1 "
        f"reads the int8 rows (TF32 off; fp32 tol 2e-5, bf16 tol 2e-2)")
    recs, k1 = {}, None
    for dtype in ("float32", "bfloat16"):
        for S in ((64, 256, 1024) if full else (256,)):
            r = check_decode(torch, dtype, 16, 1024, S, H, Hkv, D,
                             decode_lengths(S), kv_scale=scale)
            log(f"  (a) K1 int8 {dtype:8s} B=16 S={S:4d} "
                f"{_k1_grid(16, Hkv, S, D, 1, H // Hkv)}: max|err| "
                f"{r['max_abs_err']:.3e}  {_times(r)}")
            recs[f"a_{dtype}_{S}"] = r
            if dtype == "bfloat16" and S == 256:
                k1 = r
    recs["b"] = int8_fp32_parity(torch, cfg.scaled(dtype="float32", **INT8),
                                 device, card)
    recs["c"] = int8_serve(torch, cfg.scaled(**INT8), device, card,
                           bf16_streams, steps=full)
    recs["wall_s"] = round(time.perf_counter() - t0, 2)
    log(f"phase 18 wall {recs['wall_s']:.1f} s")
    return k1, recs


# --------------------------------------------------------------------------- #
# --fp32-gaps: where the fp32 impls of the dense models part
# --------------------------------------------------------------------------- #
GAP_ARCHS = ("stablelm-12b", "internvl2-26b", "nemotron-4-15b")


def attention_errors(torch, cfg, q, k, v):
    """One layer's attention on the same fp32 inputs q (1, S, H, D), k, v
    (1, S, Hkv, D): K2, the torch path `gqa_prefill` takes under "torch"
    (`online_attention`) and K2's plain version, each against the causal
    softmax in float64; errors relative to max|reference|, and the largest
    |q.k| / sqrt(D) (the attention logit)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.prefill_attention import prefill_attention_plain
    from repro_torch.models.attention import _repeat_kv, online_attention
    S, H, D = q.shape[1], q.shape[2], q.shape[3]
    pos = torch.arange(S, device=q.device)
    kf, vf = _repeat_kv(k, H), _repeat_kv(v, H)
    ch = (1 << 30) if cfg.attn_block_full else 256
    outs = {"k2": ops.prefill_attention(q, k, v, impl="cuda"),
            "torch": online_attention(q, kf, vf, pos, pos, causal=True,
                                      q_chunk=ch, kv_chunk=ch),
            "plain": prefill_attention_plain(q, k, v)}
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kf.double()) \
        / math.sqrt(D)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    ref = torch.einsum("bhqk,bkhd->bqhd",
                       s.masked_fill(~causal, float("-inf")).softmax(-1),
                       vf.double())
    scale = float(ref.abs().max())
    errs = {n: float((o.double() - ref).abs().max()) / scale
            for n, o in outs.items()}
    errs["k2_vs_torch"] = float((outs["k2"] - outs["torch"]).abs().max()) \
        / scale
    errs["max_logit"] = float(s.masked_fill(~causal, 0).abs().max())
    return errs


def locate_fp32_gap(torch, arch, device, card):
    """fp32 (TF32 off) at full width, at the depth that fits: phase 12
    (b)'s 150-token prefill under "cuda" and "torch" (internvl2-26b after
    its 256 seeded patches), recording each layer's output under both and
    the q, k, v K2 receives under "cuda". Prints, layer by layer, the
    attention's errors on the same inputs (`attention_errors`) and how far
    the two runs' hidden states have parted, then the logits' gap: the op
    that parts them, and how much the layers after it grow the part."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = fit_depth(torch, get_config(arch).scaled(dtype="float32"))
    model = build_model(cfg)
    params = model.init(0, device)
    fe = (front_maker(torch, cfg, device)(0) if cfg.frontend != "none"
          else None)
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                              DENSE_PROMPT)
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=device)[None]
    hidden, qkv, logits = {"cuda": [], "torch": []}, [], {}
    block, attn = transformer.block_prefill, ops.prefill_attention

    def rec_block(*args, **kw):
        h, c = block(*args, **kw)
        hidden[kw["attention_impl"]].append(h)
        return h, c

    def rec_attn(q, k, v, **kw):
        qkv.append((q, k, v))
        return attn(q, k, v, **kw)
    transformer.block_prefill, ops.prefill_attention = rec_block, rec_attn
    try:
        with torch.no_grad():
            for impl in ("cuda", "torch"):
                logits[impl] = model.prefill(params, toks, frontend_embeds=fe,
                                             attention_impl=impl)[0]
    finally:
        transformer.block_prefill, ops.prefill_attention = block, attn
    with torch.no_grad():
        layers = [attention_errors(torch, cfg, *t) for t in qkv]
    parted = [max_err(a, b) / max(1.0, float(b.abs().max()))
              for a, b in zip(hidden["cuda"], hidden["torch"])]
    scale = max(1.0, float(logits["torch"].abs().max()))
    gap = max_err(logits["cuda"], logits["torch"])
    S = qkv[0][0].shape[1]
    log(f"  {arch} fp32, {cfg.n_layers} layers, S = {S}, (H, Hkv, D) = "
        f"({cfg.n_heads}, {cfg.n_kv_heads}, {cfg.head_dim}), norm "
        f"{cfg.norm}, qk_norm {cfg.qk_norm}: logits gap {gap:.3e} at "
        f"max|logit| {scale:.3f} ({gap / scale:.2e} relative)")
    for i, (e, p) in enumerate(zip(layers, parted)):
        log(f"    layer {i:2d}: attention vs float64 K2 {e['k2']:.2e}, "
            f"torch {e['torch']:.2e}, plain {e['plain']:.2e}; K2 vs torch "
            f"{e['k2_vs_torch']:.2e}; max|logit| {e['max_logit']:.2f}; "
            f"hidden states parted {p:.2e}")
    rec = {"n_layers": cfg.n_layers, "S": S, "logits_gap": gap,
           "max_logit": scale,
           "k2_vs_f64_max": max(e["k2"] for e in layers),
           "torch_vs_f64_max": max(e["torch"] for e in layers),
           "k2_vs_torch_median": float(np.median([e["k2_vs_torch"]
                                                  for e in layers])),
           "attn_logit_max": max(e["max_logit"] for e in layers),
           "parted_first": parted[0], "parted_last": parted[-1]}
    rec["growth"] = rec["parted_last"] / max(rec["k2_vs_torch_median"],
                                             1e-30)
    log(f"  [{card}] {arch}: " + json.dumps(rec))
    del params, model, qkv, hidden, logits
    torch.cuda.empty_cache()
    return rec


def rotation_sweep(torch, cfg, device, card, values):
    """Phase 5b's run (qwen3-0.6b, bf16, 1 prefiller + 2 decoders through
    the CUDA graphs) once per `rotation_min_chunk` — the shortest chunk a
    refill cut may dispatch (`EngineServer`; the default 16 was tuned to
    eager dispatch on a CPU). Prints each run's serving numbers."""
    from repro_torch.models import build_model
    log(f"rotation sweep: {cfg.name} full width {cfg.dtype}, phase 5b's "
        f"trace, rotation_min_chunk in {values}")
    params = build_model(cfg).init(0, device)
    for v in values:
        serve_and_count(torch, cfg, params, card, BF16_PATH_KERNELS,
                        f"rotation_min_chunk {v}: ",
                        server_kw={"rotation_min_chunk": v})
    del params
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1-3 alone (build, check and time the "
                    "kernels) and print their JSON line, without the "
                    "served paths and without the ok line")
    ap.add_argument("--phase13", action="store_true",
                    help="run phases 1-2 and phase 13 (MLA and MoE) alone "
                    "and print its records, without the ok line")
    ap.add_argument("--phase14", action="store_true",
                    help="run phases 1-2 and phase 14 (the vision frontend "
                    "and the encoder-decoder) alone and print its records, "
                    "without the ok line")
    ap.add_argument("--phase15", action="store_true",
                    help="run phases 1-2 and phase 15 (training) alone and "
                    "print its records, without the ok line")
    ap.add_argument("--phase16", action="store_true",
                    help="run phases 1-2 and phase 16 (launch and sharding) "
                    "alone and print its records, without the ok line")
    ap.add_argument("--phase17", action="store_true",
                    help="run phases 1-2 and phase 17 (the prefix pool) "
                    "alone and print its records, without the ok line")
    ap.add_argument("--phase18", action="store_true",
                    help="run phases 1-2, phase 5b's bf16 run and phase 18 "
                    "(the int8 KV cache) alone, with K1's int8 instance at "
                    "all three buckets and the graphed decode steps, and "
                    "print its records, without the ok line")
    ap.add_argument("--fp32-gaps", action="store_true",
                    help="after phases 1-2, locate where the fp32 'cuda' and "
                    "'torch' impls of stablelm-12b, internvl2-26b and "
                    "nemotron-4-15b part, layer by layer, and stop (no ok "
                    "line)")
    ap.add_argument("--rotation-sweep", metavar="N,N,...",
                    help="after phases 1-2, serve phase 5b's trace once for "
                    "each rotation_min_chunk given, print each run's "
                    "serving numbers, and stop (no ok line)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
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
    hmma = sass_count(_build.lib_path("prefill_attention"), "HMMA")
    log(f"  [prefill_attention] {hmma} HMMA (tensor-core) instructions in "
        f"the SASS (cuobjdump -sass)")
    if hmma == 0:
        raise AssertionError("K2's library has no tensor-core instruction")

    cfg = get_config("qwen3-0.6b")
    rcfg = get_config("rwkv6-3b")
    gcfg = get_config("recurrentgemma-9b")
    if args.rotation_sweep:
        rotation_sweep(torch, cfg, device, card,
                       [int(v) for v in args.rotation_sweep.split(",")])
        log(f"chip_smoke --rotation-sweep wall "
            f"{time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    if args.phase13:
        moe = phase_moe(torch, device, card)
        log(f"chip_smoke --phase13 wall {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"phase13": moe_records(*moe)}))
        return 0
    if args.phase14:
        front = front_records(*phase_front(torch, device, card))
        log(f"chip_smoke --phase14 wall {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"phase14": front}))
        return 0
    if args.phase15:
        train = phase_train(torch, device, card)
        log(f"chip_smoke --phase15 wall {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"phase15": train}))
        return 0
    if args.phase16:
        launch = phase_launch(torch, card)
        log(f"chip_smoke --phase16 wall {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"phase16": launch}))
        return 0
    if args.fp32_gaps:
        log("fp32 gaps: the 'cuda' and 'torch' impls layer by layer")
        gaps = {a: locate_fp32_gap(torch, a, device, card) for a in GAP_ARCHS}
        log(f"chip_smoke --fp32-gaps wall {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"fp32_gaps": gaps}))
        return 0
    if args.phase17:
        pool = phase_pool(torch, device, card)
        log(f"chip_smoke --phase17 wall {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"phase17": pool}))
        return 0
    if args.phase18:
        from repro_torch.models import build_model
        params = build_model(cfg).init(0, device)
        _, bf16 = serve_and_count(torch, cfg, params, card,
                                  BF16_PATH_KERNELS, "(5b, bf16 cache) ")
        del params
        torch.cuda.empty_cache()
        _, int8 = phase_int8(torch, cfg, device, card, bf16["streams"],
                             full=True)
        log(f"chip_smoke --phase18 wall {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"phase18": int8}))
        return 0
    recs = phase_kernels(torch, cfg)
    recs.update(phase_wkv6(torch, rcfg))
    recs.update(phase_rglru(torch, gcfg))
    if args.kernels_only:
        log(f"chip_smoke --kernels-only wall "
            f"{time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"kernels": recs}))
        return 0
    phase_fp32_parity(torch, cfg, device, card)
    launches, conserve_run = phase_serve(torch, cfg, device, card)
    phase_rwkv_fp32_parity(torch, rcfg, device, card)
    launches.update(phase_rwkv_serve(torch, rcfg, device, card))
    phase_rg_fp32_parity(torch, gcfg, device, card)
    launches.update(phase_rg_serve(torch, gcfg, device, card))
    t10 = time.perf_counter()
    compared = phase_compare(torch, cfg, device, card, conserve_run)
    log(f"phase 10 wall {time.perf_counter() - t10:.1f} s")
    dense_recs, dense_launches = phase_dense(torch, device, card)
    dense = dense_records(dense_recs, dense_launches)
    moe = moe_records(*phase_moe(torch, device, card))
    front = front_records(*phase_front(torch, device, card),
                          vlm_recs=dense_recs["nemotron-4-15b"])
    train = phase_train(torch, device, card)
    log("phase 15 records: " + json.dumps(train))
    launch = phase_launch(torch, card)
    log("phase 16 records: " + json.dumps(launch))
    pool = phase_pool(torch, device, card)
    log("phase 17 records: " + json.dumps(pool))
    k1_int8, int8 = phase_int8(torch, cfg, device, card,
                               conserve_run["streams"])
    log("phase 18 records: " + json.dumps(int8))

    csrc = "src/repro_torch/kernels/csrc/"
    replaces = {"decode_attention": "src/repro/kernels/decode_attention.py:69",
                "prefill_attention":
                    "src/repro/kernels/prefill_attention.py:71",
                "wkv6": "src/repro/kernels/rwkv6_kernel.py:68",
                "rglru": "src/repro/kernels/rglru_kernel.py:43"}
    kernels = [dict(name=n, route="cuda", source=f"{csrc}{n}.cu",
                    replaces=replaces[n], launches=launches[n], **recs[n])
               for n in ("decode_attention", "prefill_attention", "wkv6",
                         "rglru")]
    for k in kernels[:2]:  # K1 and K2: their launches in each phase-10 run
        k["phase10_launches"] = {run: c[k["name"]]
                                 for run, c in compared.items()}
        k["phase12"] = dense[k["name"]]  # and at each dense model's heads
        k["phase13"] = moe[k["name"]]  # and at the MoE models' (G = 5)
        k["phase14"] = front[k["name"]]  # whisper's (G = 1), internvl2's
    # K2's append instance, beside K2: it replaces no Pallas kernel (the
    # reference attends an append in jnp ops); its launches in phase 5b's
    # served run (a global layer's per append and pool hit) and in phase
    # 10's, 0 in the fp32 ones
    kernels.insert(2, dict(
        name="append_attention", route="cuda",
        source=f"{csrc}prefill_attention.cu", replaces=None,
        launches=launches["append_attention"],
        appends=conserve_run["appends"],
        phase10_launches={run: c.get("append_attention", 0)
                          for run, c in compared.items()},
        **recs["append_attention"]))
    # K1 reading an int8 cache: its bf16 record at the 256 bucket and its
    # served launches
    kernels[0]["phase18"] = dict(
        k1_int8, launches=int8["c"]["decode_attention"],
        decode_steps=int8["c"]["decode_steps"])
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
