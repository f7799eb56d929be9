"""Deterministic synthetic LM data pipeline: seeded, shardable, restartable.

Produces next-token-prediction batches from a procedural token stream (a
mixture of Zipfian unigrams and repeated n-gram motifs so the loss actually
falls during the example training runs). `step`-indexed generation means any
batch can be regenerated exactly — resuming from a checkpoint needs no data
state beyond the step counter, and each data shard draws a disjoint
substream (host-sharded input pipeline)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_prob: float = 0.35
    n_motifs: int = 256
    frontend_len: int = 0   # >0: also emit stub frontend embeddings
    d_model: int = 0


class SyntheticLM:
    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1):
        assert cfg.global_batch % n_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        base = np.random.RandomState(cfg.seed)
        probs = 1.0 / np.power(np.arange(1, cfg.vocab_size + 1), cfg.zipf_a)
        self._probs = probs / probs.sum()
        self._motifs = base.randint(
            0, cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        bs = cfg.global_batch // self.n_shards
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step * 613 + self.shard) % (2**31 - 1))
        toks = rng.choice(cfg.vocab_size, size=(bs, cfg.seq_len + 1),
                          p=self._probs).astype(np.int32)
        # splice in motifs: learnable structure
        n_splice = int(cfg.motif_prob * bs * cfg.seq_len / cfg.motif_len)
        for _ in range(n_splice):
            b = rng.randint(bs)
            pos = rng.randint(cfg.seq_len + 1 - cfg.motif_len)
            toks[b, pos: pos + cfg.motif_len] = self._motifs[
                rng.randint(cfg.n_motifs)]
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend_len:
            out["frontend_embeds"] = rng.standard_normal(
                (bs, cfg.frontend_len, cfg.d_model)).astype(np.float32) * 0.02
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
