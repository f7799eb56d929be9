"""The engine's spans: intervals it measured, published on the runtime's
event bus as ``span`` events (`repro_torch.core.events`).

Two clocks, one path:

* The server's spans lie on its LOGICAL clock (``server.*``: a
  conversation, a turn, and the admission, waits, prefill, append and
  transfers that stage the turn). `Tracer.emit` publishes one whose
  interval is known; `Tracer.call` brackets a replica call (``with``), so
  the spans the call makes name it as their parent, and `OpenSpan.close`
  publishes it once the call's logical interval is known.
* The replica's spans lie on the HOST clock (``replica.prefill``,
  ``replica.append``, ``replica.decode``): `Tracer.host` opens one over a
  call's timed interval (``with``), `HostSpan.begin` / `HostSpan.end`
  bracket its one child, the program's run (``programs.replay`` or
  ``programs.eager``), and `HostSpan.close` publishes both. Inside a
  replica's timed interval a child costs two `perf_counter_ns` reads;
  everything is published after the call's time was taken, so the logical
  clocks move the same with tracing on or off. While `torch.profiler`
  records (and only then), each host-clock span and its child also open
  ``record_function("conserve.<name>")``, so the program's spans lie on the
  device trace's clock too.

Each site checks `Tracer.on` — one `EventBus.wants` lookup — before it
builds anything: with no ``span`` subscriber `call` and `host` hand back
one shared no-op context whose value is None, and no payload, id or span is
made. Leaving a ``with`` block by an exception restores the tracer's
context and closes the profiler ranges, and publishes nothing. A replica
outside a server holds `NO_TRACER`, which is never on.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.events import EV_SPAN, EventBus, ServeEvent

# (span id, cid, turn_idx, node_id) of the server span whose call runs now
Context = Tuple[Optional[int], Optional[int], Optional[int], Optional[int]]
NO_CONTEXT: Context = (None, None, None, None)
# what `Tracer.call` and `Tracer.host` hand back with tracing off
OFF = contextlib.nullcontext()


def _range(name: str):
    """An entered profiler range named ``conserve.<name>``."""
    rf = torch.profiler.record_function(f"conserve.{name}")
    rf.__enter__()
    return rf


class Tracer:
    """Span ids, the context of the call running now, and the publish, on
    one runtime's bus. `now` reads the runtime's logical clock."""

    def __init__(self, bus: Optional[EventBus] = None,
                 now: Callable[[], float] = lambda: 0.0):
        self.bus = bus
        self.now = now
        self.ctx: Context = NO_CONTEXT
        self._ids = itertools.count(1)

    @property
    def on(self) -> bool:
        return self.bus is not None and self.bus.wants(EV_SPAN)

    def new_id(self) -> int:
        return next(self._ids)

    def publish(self, name: str, t: float, span_id: int,
                parent: Optional[int], host_t0_ns: int, host_t1_ns: int,
                cid: Optional[int] = None, turn_idx: Optional[int] = None,
                node_id: Optional[int] = None, t0: Optional[float] = None,
                **attrs: Any) -> None:
        data = dict(name=name, span_id=span_id, parent=parent,
                    host_t0_ns=host_t0_ns, host_t1_ns=host_t1_ns, **attrs)
        if t0 is not None:
            data["t0"] = t0
        self.bus.publish(ServeEvent(kind=EV_SPAN, t=t, cid=cid,
                                    turn_idx=turn_idx, node_id=node_id,
                                    data=data))

    # ----- logical-clock spans ------------------------------------------
    def emit(self, name: str, t0: float, t: float, parent: Optional[int],
             cid: Optional[int] = None, turn_idx: Optional[int] = None,
             node_id: Optional[int] = None, span_id: Optional[int] = None,
             host_t0_ns: Optional[int] = None, **attrs: Any) -> None:
        """Publish a logical span [t0, t]. Its host pair is the instant its
        start was observed (`host_t0_ns`, default now) and now."""
        h1 = time.perf_counter_ns()
        self.publish(name, t, self.new_id() if span_id is None else span_id,
                     parent, h1 if host_t0_ns is None else host_t0_ns, h1,
                     cid, turn_idx, node_id, t0=t0, **attrs)

    def call(self, name: str, parent: Optional[int],
             cid: Optional[int] = None, turn_idx: Optional[int] = None,
             node_id: Optional[int] = None, **attrs: Any):
        """A logical span around a call (``with``; None with tracing off):
        inside the block, the spans the call makes take it as their parent
        and its conversation as theirs. `attrs` are published with it."""
        return (OpenSpan(self, name, parent, cid, turn_idx, node_id, attrs)
                if self.on else OFF)

    # ----- host-clock spans ---------------------------------------------
    def host(self, name: str, node_id: Optional[int] = None):
        """A host-clock span over a replica call (``with``; None with
        tracing off), under the server span whose call runs now."""
        return HostSpan(self, name, node_id) if self.on else OFF


class OpenSpan:
    """A server span bracketing a call: its id is the context of the spans
    the call makes while the ``with`` block runs."""

    def __init__(self, tracer: Tracer, name: str, parent: Optional[int],
                 cid: Optional[int], turn_idx: Optional[int],
                 node_id: Optional[int], attrs: Dict[str, Any]):
        self.tr = tracer
        self.name = name
        self.span_id = tracer.new_id()
        self.parent = parent
        self.ids = (cid, turn_idx, node_id)
        self.attrs = attrs
        self.outer = tracer.ctx
        self.host_t0_ns = time.perf_counter_ns()

    def __enter__(self) -> "OpenSpan":
        self.tr.ctx = (self.span_id,) + self.ids
        return self

    def __exit__(self, *exc) -> bool:
        self.tr.ctx = self.outer
        return False

    def close(self, t0: float, t: float, **attrs: Any) -> None:
        """Publish the call's span as the logical interval [t0, t]."""
        self.tr.publish(self.name, t, self.span_id, self.parent,
                        self.host_t0_ns, time.perf_counter_ns(), *self.ids,
                        t0=t0, **self.attrs, **attrs)


class HostSpan:
    """One host-clock span and its one child, the program's run."""

    def __init__(self, tracer: Tracer, name: str, node_id: Optional[int]):
        self.tr = tracer
        self.name = name
        self.span_id = tracer.new_id()
        self.parent, cid, turn_idx, ctx_node = tracer.ctx
        self.ids = (cid, turn_idx, ctx_node if node_id is None else node_id)
        self.child: Optional[List] = None   # [name, t0_ns, t1_ns]
        self.ranges: Optional[List] = (
            [] if torch.autograd._profiler_enabled() else None)

    def __enter__(self) -> "HostSpan":
        if self.ranges is not None:
            self.ranges.append(_range(self.name))
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self._exit_ranges()
        return False

    def _exit_ranges(self) -> None:
        while self.ranges:
            self.ranges.pop().__exit__(None, None, None)

    def begin(self, name: str) -> None:
        """The program's run starts."""
        if self.ranges is not None:
            self.ranges.append(_range(name))
        self.child = [name, time.perf_counter_ns(), None]

    def end(self) -> None:
        """The program's run ends."""
        self.child[2] = time.perf_counter_ns()
        if self.ranges is not None:
            self.ranges.pop().__exit__(None, None, None)

    def close(self, **attrs: Any) -> None:
        """End the span and publish it, with its child."""
        end = time.perf_counter_ns()
        self._exit_ranges()
        tr, t = self.tr, self.tr.now()
        if self.child is not None:
            name, a, b = self.child
            tr.publish(name, t, tr.new_id(), self.span_id, a, b, *self.ids)
        tr.publish(self.name, t, self.span_id, self.parent, self.t0_ns, end,
                   *self.ids, **attrs)


NO_TRACER = Tracer()
