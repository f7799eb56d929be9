"""The comparison that decides `correct` fails what it should: a run of the
tiny cell on the CPU, with the timed path broken underneath the harness,
comes out not correct; and the control — the reference in the precision
below the configuration's — reads a share of missed tokens that a limit
can separate from the program's, and comes out not correct through the
same comparison."""
import numpy as np
import pytest
import torch

from bench.harness import check, system, weights
from bench.reference import dense
from bench.tests import tiny

torch.set_num_threads(1)


def _token_altered(monkeypatch):
    """A decoded token altered where it is produced: the chunk's first
    sampled row, every lane."""
    from repro_torch.engine import ReplicaEngine
    real = ReplicaEngine.decode_steps

    def broken(self, next_tokens, emit_mask, remaining):
        seq, dt = real(self, next_tokens, emit_mask, remaining)
        seq = seq.copy()
        seq[0] = (seq[0] + 1) % self.cfg.vocab_size
        return seq, dt
    monkeypatch.setattr(ReplicaEngine, "decode_steps", broken)


def _transfer_left_out(monkeypatch):
    """The exchange between replicas left out: the decoder's slot takes
    the package's length but none of its rows."""
    from repro_torch.engine.kvcache import SlotKVCache

    def broken(self, slot, package):
        self.lengths[slot] = package["length"]
    monkeypatch.setattr(SlotKVCache, "import_slot", broken)


def _state_unchanged(monkeypatch):
    """An append that returns the cache unchanged: its rows are put back
    as they were, though the slot's length moves on."""
    from repro_torch.engine import ReplicaEngine
    from repro_torch.engine.kvcache import leaves
    real = ReplicaEngine.append_prefill

    def broken(self, slot, tokens):
        saved = [t[..., slot, :, :, :].clone() if t.dim() == 5 else None
                 for _, t in leaves(self.kv.caches)]
        out = real(self, slot, tokens)
        for (_, t), s in zip(leaves(self.kv.caches), saved):
            if s is not None:
                t[..., slot, :, :, :] = s
        return out
    monkeypatch.setattr(ReplicaEngine, "append_prefill", broken)


def _half_the_batch(monkeypatch):
    """Half of a decode chunk's lanes left out: they are not computed, and
    their tokens repeat the last one fed."""
    from repro_torch.engine import ReplicaEngine
    real = ReplicaEngine.decode_steps

    def broken(self, next_tokens, emit_mask, remaining):
        emit = np.asarray(emit_mask, bool)
        lanes = np.flatnonzero(emit)
        drop = lanes[: len(lanes) // 2]
        kept = emit.copy()
        kept[drop] = False
        if not kept.any():
            return real(self, next_tokens, emit_mask, remaining)
        seq, dt = real(self, next_tokens, kept, remaining)
        seq = seq.copy()
        rem = np.broadcast_to(np.asarray(remaining), emit.shape)
        for i in drop:
            self.kv.lengths[i] += int(rem[i])
            seq[:, i] = next_tokens[i]
        if seq.shape[0] < int(rem[emit].max()):
            pad = np.repeat(seq[-1:], int(rem[emit].max()) - seq.shape[0], 0)
            seq = np.concatenate([seq, pad])
        return seq, dt
    monkeypatch.setattr(ReplicaEngine, "decode_steps", broken)


FAULTS = [_token_altered, _transfer_left_out, _state_unchanged,
          _half_the_batch]


def test_a_sound_run_is_correct(tmp_path):
    out = tiny.run_tiny(tiny.copy_root(tmp_path), seconds=0.5)
    assert out["correct"] and out["compared"]["miss_share"]["value"] == 0.0
    assert out["detail"]["judged"]["logit_gap"] < 1e-4


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    out = tiny.run_tiny(tiny.copy_root(tmp_path), seconds=0.5)
    assert not out["correct"], out["compared"]
    assert out["compared"]["miss_share"]["value"] > \
        out["compared"]["miss_share"]["limit"]


def test_control_reads_a_wider_gap_than_the_program(tmp_path, monkeypatch):
    """In bfloat16, as the cells serve: the program's share of served
    tokens that are not the reference's first choice, and the control's
    (the reference computed in float8 choosing the tokens) on the same
    conversations, at least three times larger; the control's run, put
    through the same comparison at a limit between the two, is not
    correct."""
    conf = dict(tiny.TINY_CONF, model=dict(tiny.TINY_MODEL,
                                           dtype="bfloat16"))
    seen = {}
    real = check.judge

    def both(conf_, w, seed, sample, streams, device, control=False):
        seen.update(real(conf_, w, seed, sample, streams, device,
                         control=True))
        return real(conf_, w, seed, sample, streams, device)
    monkeypatch.setattr(check, "judge", both)
    program, control = [], []
    for seed in (5, 6, 7):
        tiny.run_tiny(tiny.copy_root(tmp_path / str(seed), conf=conf),
                      seed=seed, seconds=0.5)
        program.append(seen["miss_share"])
        control.append(seen["control"]["miss_share"])
        ctl_judged = {**seen, **seen["control"]}
    assert min(control) > 0 and min(control) >= 3 * max(program), \
        (program, control)
    limit = dict(conf["check"], max_miss_share=(max(program)
                                                + min(control)) / 2)
    assert not check.passes(check.compare(limit, ctl_judged, 0))


def test_fp8_cast_is_a_lower_precision():
    w = weights.make(tiny.TINY_MODEL, 3, "cpu")
    t = w["blocks.0.mlp.wi"].float()
    q = dense.fp8_cast("blocks.0.mlp.wi", t)
    err = (q - t).abs().max() / t.abs().max()
    assert 1e-3 < err < 0.1
    e = w["embed.w"].float()
    assert dense.fp8_cast("embed.w", e).shape == e.shape
    assert system is not None


def test_calibration_reads_the_knee_and_fails_the_control(tmp_path):
    """`calibrate.py` on the tiny cell: a sweep whose backlog grows at
    every rate keeps the rate known to hold as the knee, and each seed's
    control run, put through the same comparison, is not correct (the
    process would exit 5 otherwise)."""
    import json
    import os
    import subprocess
    import sys
    root = tiny.copy_root(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(tiny.ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, str(root / "bench/calibrate.py"), "--workload",
         "tiny.mix", "--rates", "40,80", "--sweep-fill", "0.1",
         "--sweep-seconds", "0.4", "--sustained", "10", "--seeds", "5,6",
         "--seconds", "0.5", "--device", "cpu"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(x) for x in r.stdout.splitlines()]
    assert next(x for x in rows if "knee" in x) == {"knee": 10.0, "rate": 8.0}
    judged = [x["judged"] for x in rows if "judged" in x]
    assert [j["seed"] for j in judged] == [5, 6]
    assert all(j["program_correct"] and not j["control_correct"]
               for j in judged)
