"""AdamW in torch ops, the reference's arithmetic (`repro/train/optimizer.py`)
written out: fp32 moments whatever the parameter's dtype, the update
applied to the parameter itself in fp32 and cast back to its dtype (no fp32
master copy), the global-norm clip, the bias corrections in fp32 and the
warm-up + cosine schedule. `torch.optim.AdamW` is not used: its decay rule
is not the reference's (below).

The state mirrors the port's parameters: {"mu": {name: fp32}, "nu": {name:
fp32}, "step": int32 scalar}, names as `module.named_parameters()` gives
them.

Weight decay follows the reference's rule on the reference's tree: a leaf
is decayed when its `ndim >= 2` there. The reference tests that on its
STACKED tree, where every per-layer leaf under "groups" (and an
encoder-decoder's "encoder" and "decoder") carries the layer axis, so a
norm scale or a qk-norm scale there is decayed and one under "rem" or at
the top is not (ROADMAP queue 3, F20). The port keeps one module per layer,
so `decay_mask` counts that axis for a parameter in a stacked place —
mirrored, not designed out: the port is held to the reference's updates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.convert import reference_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def adamw_init(params) -> Dict[str, Any]:
    """Zero fp32 moments beside each parameter of the module `params`, and
    step 0."""
    dev = next(params.parameters()).device
    f32 = lambda: {n: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
                   for n, p in params.named_parameters()}
    return {"mu": f32(), "nu": f32(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_state_skeleton(param_skeleton) -> Dict[str, Any]:
    """The state's shapes and dtypes as meta tensors (a restore target that
    holds no memory)."""
    meta = lambda: {n: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                   device="meta")
                    for n, p in param_skeleton.named_parameters()}
    return {"mu": meta(), "nu": meta(),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def decay_mask(params) -> Dict[str, bool]:
    """{name: decayed}: the reference's `p.ndim >= 2` on its stacked tree
    (F20), a stacked place counting its layer axis."""
    shapes = {n: p.dim() for n, p in params.named_parameters()}
    return {n: shapes[n] + int(stacked) >= 2
            for _, names, stacked in reference_leaves(params) for n in names}


def lr_schedule(cfg: AdamWConfig, step):
    """Linear warm-up to cfg.lr, then a cosine to min_lr_frac x lr, in fp32
    at `step` (an int tensor)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in fp32."""
    total = None
    for g in grads.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Dict[str, torch.Tensor], state,
                 params) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step on the module `params` and on `state`, both in place
    (a parameter's moments are replaced one parameter at a time, so the
    step holds no second copy of them). `grads` {name: tensor} in any float
    dtype. Returns (params, state, {"grad_norm", "lr"} as fp32 scalars)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip
             else torch.ones((), dtype=torch.float32, device=gnorm.device))
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    decay = decay_mask(params)
    mu, nu = state["mu"], state["nu"]
    for n, p in params.named_parameters():
        g = grads[n].float() * scale
        mu[n] = cfg.b1 * mu[n] + (1 - cfg.b1) * g
        nu[n] = cfg.b2 * nu[n] + (1 - cfg.b2) * torch.square(g)
        delta = (mu[n] / b1c) / (torch.sqrt(nu[n] / b2c) + cfg.eps)
        if decay[n]:  # decoupled weight decay on the reference's matrices
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWConfig", "adamw_init", "adamw_state_skeleton",
           "adamw_update", "decay_mask", "global_norm", "lr_schedule"]
