"""A replica's compiled programs: the port's counterpart of the JAX
package's AOT-compiled, donated programs, one per bucket key
(src/repro/engine/replica.py: `_get_fused` for the decode chunk,
`_get_prefill` for turn-1 prefill, `_get_append` for appends).

A `Program` owns static device buffers: one int32 input vector, which the
host fills with ONE copy before each run, and the outputs its body writes.
The body reads and writes only those buffers, the replica's weights and its
slot cache (in place). On a CUDA replica the body is captured once into a
CUDA graph and every later run replays it, so the host's dispatch of the
eager model — thousands of launches a decode step — leaves the measured
time. On the CPU (or with the replica's `cuda_graphs=False`) the same body
runs eagerly on the same buffers.

What a replay needs, and what this module does about it:

* A graph binds addresses. A program records the `data_ptr()` of every
  weight and cache leaf it captured and checks them before each replay; a
  tensor that moved raises, naming it. The slot cache is allocated once and
  written in place (`kvcache`), so a failed and rejoined replica replays
  its old graphs.
* A replay calls no kernel wrapper. A program keeps what its capture added
  to each of the port's launch counters (`kernels.ops.launch_counts`) and
  adds that on every replay; building a program (its warm-up pass and the
  capture) counts nothing, as its seconds go to `compile_s`, not to a dt,
  and to the program's own `build_s`.
* No fallback: a capture or a replay that fails raises, naming the
  program's key.
* The cycle collector stays off during a capture. A dead replica's
  programs wait in reference cycles, and collecting them mid-capture
  destroys their graphs, which CUDA refuses while a stream captures and
  answers by voiding the capture (ROADMAP queue 3, F12).

A replica's programs share one graph memory pool: they never run at once,
and each run's outputs are read before the next run starts.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Leave the port's launch counters as they were before the block."""
    counts = ops.launch_counts()
    try:
        yield
    finally:
        ops.set_launch_counts(counts)


@contextlib.contextmanager
def no_cycle_collection() -> Iterator[None]:
    """Keep Python's cycle collector off for the block (F12): nothing it
    could free, a dead replica's CUDA graphs among them, is destroyed while
    a stream captures."""
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


@contextlib.contextmanager
def side_stream(device: torch.device) -> Iterator[None]:
    """Run the block on a fresh stream ordered after the current one, as
    PyTorch asks of the warm-up before a capture (a no-op on the CPU)."""
    if device.type != "cuda":
        yield
        return
    cur = torch.cuda.current_stream(device)
    s = torch.cuda.Stream(device)
    s.wait_stream(cur)
    with torch.cuda.stream(s):
        yield
    cur.wait_stream(s)


class Program:
    """One bucket's program: its input buffer `ins` (int32, n_inputs), its
    output buffer `out`, `body(ins, out)` and, once captured, `graph`.
    `steps` is how many calls of the body one run makes: the capture
    records that many, and an eager run makes that many unless the caller
    asks for fewer."""

    def __init__(self, key: Tuple, n_inputs: int, out: torch.Tensor,
                 body: Callable[[torch.Tensor, torch.Tensor], None],
                 steps: int = 1):
        self.key = key
        self.device = out.device
        self.ins = torch.zeros(n_inputs, dtype=torch.int32,
                               device=self.device)
        self.out = out
        self.body = body
        self.steps = steps
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}  # of the port's kernels a replay
        self.capture_s = 0.0
        self.build_s = 0.0  # warm-up pass and capture, as charged to compile_s
        self._names: List[str] = []  # what the graph binds, and where
        self._ptrs: List[int] = []

    def load(self, host: np.ndarray) -> None:
        """The one host-to-device copy of a run's inputs."""
        self.ins.copy_(torch.from_numpy(np.ascontiguousarray(host,
                                                             np.int32)))

    def capture(self, bound: List[Tuple[str, torch.Tensor]], pool,
                stream: torch.cuda.Stream) -> None:
        """Record `steps` calls of the body into a CUDA graph from `pool` on
        `stream`. `bound` names the weights and cache leaves the graph
        reads and writes; their addresses are checked before each replay.
        The body must have run once eagerly first (the warm-up pass)."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        with uncounted(), no_cycle_collection():
            before = ops.launch_counts()
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool)
                try:
                    for _ in range(self.steps):
                        self.body(self.ins, self.out)
                except Exception as e:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is void; the body's error says why
                    raise RuntimeError(f"capture of program {self.key} "
                                       f"failed: {e}") from e
                graph.capture_end()
            after = ops.launch_counts()
        cur.wait_stream(stream)
        self.launches = {n: after[n] - before[n] for n in after
                         if after[n] != before[n]}
        self._names = [name for name, _ in bound]
        self._ptrs = [t.data_ptr() for _, t in bound]
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def replay(self, bound: List[Tuple[str, torch.Tensor]]) -> None:
        """Replay the graph once after checking that every tensor it binds
        is where the capture found it; count its kernels' launches."""
        ptrs = [t.data_ptr() for _, t in bound]
        if ptrs != self._ptrs:
            for i, (name, t) in enumerate(bound):
                if (i >= len(self._ptrs) or name != self._names[i]
                        or ptrs[i] != self._ptrs[i]):
                    raise RuntimeError(
                        f"program {self.key}: {name} moved since the "
                        f"capture (data_ptr {ptrs[i]:#x}); a CUDA graph "
                        f"replays fixed addresses, so weights and caches "
                        f"must be written in place")
            raise RuntimeError(f"program {self.key}: captured against "
                               f"{len(self._ptrs)} weights and cache leaves,"
                               f" replayed against {len(bound)}")
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"replay of program {self.key} failed: "
                               f"{e}") from e
        ops.add_launches(self.launches)

    def run_eager(self, steps: Optional[int] = None) -> None:
        for _ in range(self.steps if steps is None else steps):
            self.body(self.ins, self.out)


def pool_bytes(pool) -> int:
    """Device bytes the caching allocator holds in graph memory pool
    `pool` (its segments in `torch.cuda.memory_snapshot()`)."""
    want = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == want)
