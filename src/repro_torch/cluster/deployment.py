"""Deployment factories: build the node sets for each system configuration
(§5.1: four GPUs — 1 prefiller + 3 decoders for disaggregated systems, 4
mixed replicas for Collocated) on a chosen hardware tier, plus the
heterogeneous variant (full-power prefiller, capped decoders)."""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.scheduler import Scheduler, make_scheduler

from .hardware import (A40, A40_CAPPED, HardwareTier, NodeCostModel,
                       ServedModelProfile)
from .simulator import ClusterSimulator, SimNode


def build_cluster(scheduler: Scheduler, *, n_prefill: int = 1,
                  n_decode: int = 3, n_mixed: int = 0,
                  prefill_tier: HardwareTier = A40,
                  decode_tier: HardwareTier = A40,
                  model: Optional[ServedModelProfile] = None,
                  decoder_chunk_tokens: int = 2944,
                  chunk_tokens: int = 8192,
                  **sim_kwargs) -> ClusterSimulator:
    """`sim_kwargs` pass through to ClusterSimulator (e.g. the failure
    contract's `tool_deadline_s` / `tool_timeout_action`)."""
    model = model or ServedModelProfile()
    nodes: List[SimNode] = []
    nid = 0
    for _ in range(n_prefill):
        nodes.append(SimNode(node_id=nid, role="prefill",
                             cost=NodeCostModel(prefill_tier, model,
                                                chunk_tokens)))
        nid += 1
    for _ in range(n_decode):
        nodes.append(SimNode(node_id=nid, role="decode",
                             cost=NodeCostModel(decode_tier, model,
                                                decoder_chunk_tokens)))
        nid += 1
    for _ in range(n_mixed):
        nodes.append(SimNode(node_id=nid, role="mixed",
                             cost=NodeCostModel(decode_tier, model,
                                                decoder_chunk_tokens)))
        nid += 1
    return ClusterSimulator(scheduler, nodes, chunk_tokens=chunk_tokens,
                            decoder_chunk_tokens=decoder_chunk_tokens,
                            **sim_kwargs)


def paper_deployment(system: str, *, heterogeneous: bool = False,
                     wrong_prediction_rate: float = 0.10,
                     seed: int = 0, **sim_kwargs) -> ClusterSimulator:
    """The four evaluated systems on the paper's 4-GPU box. `heterogeneous`
    caps the decoder tier to 200W (Fig. 13)."""
    dec_tier = A40_CAPPED if heterogeneous else A40
    if system == "collocated":
        sched = make_scheduler("collocated")
        return build_cluster(sched, n_prefill=0, n_decode=0, n_mixed=4,
                             decode_tier=dec_tier, **sim_kwargs)
    if system == "conserve":
        sched = make_scheduler("conserve")
    elif system == "full_disagg":
        sched = make_scheduler("full_disagg")
    elif system == "ampd":
        sched = make_scheduler("ampd",
                               wrong_prediction_rate=wrong_prediction_rate,
                               seed=seed)
    else:
        raise ValueError(system)
    return build_cluster(sched, n_prefill=1, n_decode=3,
                         decode_tier=dec_tier, **sim_kwargs)
