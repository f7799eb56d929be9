"""Training launcher of the port (reference `examples/train_lm.py`): train an
OLMo-family model on the synthetic LM pipeline, with checkpoints in the
reference's format and restart-resume.

    python -m repro_torch.launch.train_lm [--arch olmo-1b] [--steps 300]
        [--small] [--seq 128] [--batch 8] [--ckpt-dir DIR]
        [--ckpt-every 100] [--resume] [--device cuda|cpu]

Without --small the model is the reference's ~100M variant of the arch
(12 x 768, vocab 32768, float32); --small is its CPU size (4 x 128, vocab
4096). It runs on the card unless `--device cpu` is given (a CUDA device
without a card raises). The checkpoint directory defaults to
`repro_torch_ckpt` under the system's temporary directory. The parameter
count is summed as Python ints over the module on the meta device (the
reference's `n_params()` wraps in int32 at full size, F10).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Run the training loop; returns each step's loss."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true",
                    help="reduced config for CPU")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                                   adamw_init, latest_step, make_train_step,
                                   restore_checkpoint, save_checkpoint)

    device = resolve_device(args.device)
    if args.small:
        cfg = get_reduced(args.arch).scaled(
            n_layers=4, d_model=128, d_ff=512, n_heads=4, n_kv_heads=4,
            head_dim=32, vocab_size=4096)
    else:
        # ~100M: olmo-family, 12L x 768
        cfg = get_config(args.arch).scaled(
            n_layers=12, d_model=768, d_ff=3072, n_heads=12, n_kv_heads=12,
            head_dim=64, vocab_size=32768, dtype="float32")
    model = build_model(cfg)
    n_params = sum(p.numel() for p in model.module("meta").parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M seq={args.seq} "
          f"batch={args.batch} device={device}")

    params = model.init(0, device)
    opt = adamw_init(params)
    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        start = latest_step(args.ckpt_dir)
        params, opt, _ = restore_checkpoint(args.ckpt_dir, start, params, opt)
        print(f"resumed from step {start}")

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch))
    t0 = time.time()
    tokens_seen = start * args.seq * args.batch
    losses = []
    for i in range(start, args.steps):
        params, opt, m = step_fn(params, opt, data.batch(i))
        losses.append(float(m["loss"]))
        tokens_seen += args.seq * args.batch
        if (i + 1) % 20 == 0 or i == start:
            tps = tokens_seen / max(time.time() - t0, 1e-9)
            print(f"step {i + 1:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"gnorm {float(m['grad_norm']):.2f}  {tps / 1e3:.1f}k tok/s")
        if (i + 1) % args.ckpt_every == 0:
            p = save_checkpoint(args.ckpt_dir, i + 1, params, opt,
                                extra={"tokens_seen": tokens_seen})
            print(f"  checkpoint -> {p}")
    print("done")
    return losses


if __name__ == "__main__":
    main()
