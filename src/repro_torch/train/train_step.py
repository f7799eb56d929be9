"""The training step of the port (reference `repro/train/train_step.py`): the
rematerialised training forward (`Model.hidden`), the chunked-vocab
cross-entropy, gradient accumulation over microbatches and bf16 gradient
compression, then `adamw_update`.

The cross-entropy never holds the (B, S, V) logits: the sequence is padded
to whole chunks (label -1, masked) and each chunk's loss runs under
`torch.utils.checkpoint`, so the backward recomputes a chunk's (B, C, V)
logits from its hidden rows instead of saving every chunk's full-vocab
softmax. The logits and their logsumexp are fp32 over the whole padded
vocab, as the reference's are (only greedy sampling cuts to vocab_size).

A batch is {"tokens", "labels" (B, S) ints, optionally "frontend_embeds"
(B, F, D)}, numpy arrays or tensors; it is moved to the model's device.
The step runs no CUDA kernel of the port (the training forward is the
reference's train path, `attention_impl="torch"`).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.model import Model

from .optimizer import AdamWConfig, adamw_update


def chunked_xent(model: Model, params, hidden, labels, chunk: int = 512):
    """hidden: (B, S, D) post-norm; labels: (B, S) ints (-1 = masked). The
    sum of the chunks' NLLs over max(count of labels >= 0, 1); each chunk
    materialises only (B, chunk, V) and is recomputed in the backward."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    labels = labels.to(hidden.device).long()
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)

    def chunk_nll(h, lab):
        logits = model.logits(params, h).float()  # (B, C, V)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, lab.clamp(min=0)[..., None])[..., 0]
        valid = (lab >= 0).float()
        return ((lse - tgt) * valid).sum(), valid.sum()

    loss_sum = count = None
    for c0 in range(0, S + pad, chunk):
        nll, n = checkpoint(chunk_nll, hidden[:, c0:c0 + chunk],
                            labels[:, c0:c0 + chunk], use_reentrant=False)
        loss_sum = nll if loss_sum is None else loss_sum + nll
        count = n if count is None else count + n
    return loss_sum / torch.clamp(count, min=1.0)


def _on(device, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_loss_fn(model: Model, *, remat: bool = True, loss_chunk: int = 512):
    def loss_fn(params, batch):
        batch = _on(params.embed.w.device, batch)
        h = model.hidden(params, batch["tokens"],
                         frontend_embeds=batch.get("frontend_embeds"),
                         remat=remat)
        return chunked_xent(model, params, h, batch["labels"],
                            chunk=loss_chunk)
    return loss_fn


def make_grad_fn(model: Model, *, remat: bool = True, loss_chunk: int = 512,
                 grad_accum: int = 1, compress_grads: bool = False):
    """Returns grad_fn(params, batch) -> (loss, {name: gradient}): the
    train step's loss and gradients before the update. With grad_accum > 1
    microbatch i is batch[i·b/g:(i+1)·b/g]; each microbatch's loss is its
    own mean, the step's loss the mean of those; the gradients accumulate
    in fp32 and are divided by grad_accum. compress_grads casts each
    gradient to bf16 before it is accumulated (or used)."""
    loss_fn = make_loss_fn(model, remat=remat, loss_chunk=loss_chunk)

    def grads_of(params, batch):
        names, ps = zip(*params.named_parameters())
        for p in ps:
            p.requires_grad_(True)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, ps)
        if compress_grads:
            grads = [g.to(torch.bfloat16) for g in grads]
        return loss.detach(), dict(zip(names, grads))

    def grad_fn(params, batch):
        if grad_accum == 1:
            return grads_of(params, batch)
        mb = len(batch["tokens"]) // grad_accum
        loss = grads = None
        for i in range(grad_accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss_i, g = grads_of(params, micro)
            if grads is None:
                loss, grads = loss_i, {n: t.float() for n, t in g.items()}
            else:
                loss = loss + loss_i
                for n, t in g.items():
                    grads[n] += t.float()
            del g
        for t in grads.values():
            t /= grad_accum
        return loss / grad_accum, grads

    return grad_fn


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    remat: bool = True, loss_chunk: int = 512,
                    grad_accum: int = 1, compress_grads: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "grad_norm", "lr"}), the module and the state updated
    in place: `make_grad_fn`'s loss and gradients, then `adamw_update`."""
    grad_fn = make_grad_fn(model, remat=remat, loss_chunk=loss_chunk,
                           grad_accum=grad_accum,
                           compress_grads=compress_grads)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                                  params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


__all__ = ["chunked_xent", "make_loss_fn", "make_grad_fn",
           "make_train_step"]
