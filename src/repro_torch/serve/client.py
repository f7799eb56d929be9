"""Client-side helpers for the serving gateway: per-conversation stream
collectors and a one-call live-serving harness used by the benchmarks, the
launcher and the e2e tests.

`serve_scenario_live` is the canonical live drive: conversations are staged
into the gateway in arrival order, a few at a time, with event batches
executing between stagings — genuine mid-flight submission, not a pre-loaded
batch — while per-conversation consumer tasks assemble each stream from the
`stream(cid)` generator (honoring failure rewinds). It returns the offline-
comparable records plus the assembled streams, so callers can assert the
byte-identity contract against `Runtime.serve()` replay.
"""
from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Tuple

from repro_torch.core.conversation import Conversation

from .gateway import ServeGateway


class GatewayClient:
    """Consumes a gateway's per-conversation streams into assembled
    per-(cid, turn_idx) buffers. A ``rewind`` marker (failure recovery)
    discards the interrupted turn's partial buffer, mirroring the gateway's
    own accumulation — what remains after DONE is exactly what a live
    subscriber would have kept."""

    def __init__(self, gateway: ServeGateway):
        self.gateway = gateway
        # (cid, turn_idx) -> engine token ids, or per-turn counts on the sim
        self.collected: Dict[Tuple[int, int], List[int]] = {}
        self.rewinds: Dict[int, int] = {}

    async def collect(self, cid: int):
        """Drain one conversation's stream to completion."""
        async for item in self.gateway.stream(cid):
            if item[0] == "tokens":
                _, turn_idx, payload = item
                buf = self.collected.setdefault((cid, turn_idx), [])
                if isinstance(payload, list):
                    buf.extend(payload)
                else:
                    buf.append(int(payload))
            elif item[0] == "rewind":
                self.collected.pop((cid, item[1]), None)
                self.rewinds[cid] = self.rewinds.get(cid, 0) + 1


def serve_scenario_live(runtime, convs: List[Conversation], *,
                        shed_watermark: Optional[int] = None,
                        stagger: int = 2,
                        max_events_per_tick: int = 64,
                        ticks_between: int = 8):
    """Drive `runtime` live through a gateway: submit `convs` in arrival
    order, `stagger` at a time, executing up to `ticks_between` event
    batches between stagings so later submissions genuinely inject
    mid-flight. Returns ``(records, gateway, client)`` after a full drain.

    Overload shed (`GatewayOverloaded`) is NOT handled here — callers that
    want shedding behavior submit through the gateway themselves; this
    harness asserts the happy-path identity contract, so the watermark
    (when given) must be deep enough to admit the whole workload.
    """
    ordered = sorted(convs, key=lambda c: (c.arrival_s, c.cid))

    async def _run():
        gw = ServeGateway(runtime, shed_watermark=shed_watermark,
                          max_events_per_tick=max_events_per_tick)
        client = GatewayClient(gw)
        gw.start()
        consumers = [asyncio.ensure_future(client.collect(c.cid))
                     for c in ordered]
        for i in range(0, len(ordered), max(stagger, 1)):
            gw.submit(ordered[i:i + max(stagger, 1)])
            # let the driver execute a few batches before the next staging
            for _ in range(ticks_between):
                await asyncio.sleep(0)
        records = await gw.drain()
        await asyncio.gather(*consumers)
        return records, gw, client

    return asyncio.run(_run())
