"""Decoder-only LM assembled from a ModelConfig: an embedding, one `Block` per
layer in an `nn.ModuleList`, a final norm and the (tied or untied)
unembedding, with the prefill / decode entry points the serving engine
uses.

Caches keep the JAX package's tree (its `groups`/`rem` layering): the
config's block pattern repeats `n_groups` times, and pattern position j of
every repetition stacks under "groups"/"p{j}" with the repetition on the
leading axis; the layers left over (`pattern_groups()`'s remainder) sit
under "rem"/"p{j}" without that axis. Layer i = g * len(pattern) + j reads
groups/p{j}[g]; the remainder's layers follow. A one-kind pattern has no
remainder, so all its layers stack under "groups"/"p0". The leaves are the
kind's: "k", "v" (…, batch, ctx, Hkv, hd) for attention (a local layer's
ctx is at most its window); "ckv" (…, batch, ctx, kv_lora_rank) and "krope"
(…, batch, ctx, qk_rope_dim) for MLA; "s" (…, batch, nh_pad, hs, hs) and
"shift", "cshift" (…, batch, 1, d_model) for RWKV6; "h" (…, batch,
lru_width) and "conv" (…, batch, conv1d_width - 1, lru_width) for RG-LRU.

The training forward (`lm_hidden(mode="train")`) builds no cache and runs
the reference's train path (`attention_impl="torch"`, no kernel). Remat
wraps the same layering in `torch.utils.checkpoint`: a "group" is one
repetition of the pattern (that many consecutive blocks), and the "rem"
blocks are never rematerialised.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .blocks import Block, block_decode, block_prefill
from .config import (ATTN_GLOBAL, ATTN_LOCAL, ATTN_MLA, RGLRU, RWKV6,
                     ModelConfig)
from .layers import embed, make_norm, param, unembed


HYBRID_PATTERN = (RGLRU, RGLRU, ATTN_LOCAL)
# the reference's dense family: global GQA (olmo-1b, stablelm-12b,
# nemotron-4-15b, qwen3-0.6b) and gemma3's five local layers to one global
DENSE_PATTERNS = ((ATTN_GLOBAL,), (ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,))
DENSE_NORMS = ("rmsnorm", "layernorm", "nonparametric_ln")
DENSE_ACTIVATIONS = ("silu", "squared_relu", "gelu")
MLA_PATTERN = (ATTN_MLA,)  # deepseek-v2-lite-16b
# the patterns a MoE config may have: llama4-scout's and deepseek's
MOE_PATTERNS = ((ATTN_GLOBAL,), MLA_PATTERN)


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a configuration the port does not
    serve, naming what is missing. It serves six families: decoders with
    GQA or MLA attention — the pattern (global), (local x 5, global) or
    (MLA), any of the norms rmsnorm, layernorm and nonparametric_ln, the
    activations silu, squared_relu and gelu, a gated MLP or not, tied
    embeddings or not, qk-norm or not (qwen3-0.6b, olmo-1b, stablelm-12b,
    nemotron-4-15b, gemma3-12b), and with the pattern (global) or (MLA) the
    grouped-capacity MoE in place of the MLP (llama4-scout-17b-a16e,
    deepseek-v2-lite-16b); the vision frontend's stub patch embeddings
    before the text of a (global) dense decoder (internvl2-26b);
    attention-free RWKV6 with LayerNorm and untied embeddings (rwkv6-3b),
    whose FFN is the channel-mix; the Griffin hybrid — the pattern (RG-LRU,
    RG-LRU, local attention) with RMSNorm, a gelu gated MLP, untied
    embeddings and no qk-norm (recurrentgemma-9b); and the encoder-decoder
    (`models.encdec`) with the audio stub's frames, global attention,
    LayerNorm, a gelu MLP without a gate, untied embeddings and no qk-norm
    (whisper-small)."""
    if cfg.is_encoder_decoder:
        family = (("block_pattern", cfg.block_pattern, ((ATTN_GLOBAL,),)),
                  ("norm", cfg.norm, ("layernorm",)),
                  ("activation", cfg.activation, ("gelu",)),
                  ("gated_mlp", cfg.gated_mlp, (False,)),
                  ("tie_embeddings", cfg.tie_embeddings, (False,)),
                  ("qk_norm", cfg.qk_norm, (False,)),
                  ("n_experts", cfg.n_experts, (0,)),
                  ("frontend of an encoder-decoder", cfg.frontend,
                   ("audio",)))
    elif cfg.block_pattern == (RWKV6,):
        family = (("norm", cfg.norm, ("layernorm",)),
                  ("tie_embeddings", cfg.tie_embeddings, (False,)))
    elif cfg.block_pattern == HYBRID_PATTERN:
        family = (("norm", cfg.norm, ("rmsnorm",)),
                  ("activation", cfg.activation, ("gelu",)),
                  ("gated_mlp", cfg.gated_mlp, (True,)),
                  ("tie_embeddings", cfg.tie_embeddings, (False,)),
                  ("qk_norm", cfg.qk_norm, (False,)))
    else:
        family = (("block_pattern", cfg.block_pattern,
                   DENSE_PATTERNS + (MLA_PATTERN,)),
                  ("norm", cfg.norm, DENSE_NORMS),
                  ("activation", cfg.activation, DENSE_ACTIVATIONS))
    if cfg.n_experts:
        family += (("block_pattern of a MoE", cfg.block_pattern,
                    MOE_PATTERNS),)
    if not cfg.is_encoder_decoder:
        family += (("frontend", cfg.frontend, ("none", "vision")),)
    if cfg.frontend == "vision":
        family += (("block_pattern with a vision frontend", cfg.block_pattern,
                    ((ATTN_GLOBAL,),)),
                   ("n_experts with a vision frontend", cfg.n_experts, (0,)))
    missing = [f"{what} {got!r}" for what, got, want in family
               if got not in want]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: "
            f"{', '.join(missing)}")


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = nn.Module()
        self.embed.w = param((cfg.padded_vocab, cfg.d_model),
                             cfg.torch_dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, kind, device)
                                    for kind in cfg.layer_kinds())
        self.final_norm = make_norm(cfg, device)
        self.unembed = nn.Module()
        if not cfg.tie_embeddings:
            self.unembed.w = param((cfg.d_model, cfg.padded_vocab),
                                   cfg.torch_dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.w.device


def layer_places(cfg: ModelConfig) -> List[Tuple[str, str, Optional[int]]]:
    """Where each layer sits in the tree, in layer order: ("groups",
    "p{j}", g) for repetition g of the pattern, ("rem", "p{j}", None) for
    the remainder."""
    pat, n_groups, rem = cfg.pattern_groups()
    return ([("groups", f"p{j}", g) for g in range(n_groups)
             for j in range(len(pat))]
            + [("rem", f"p{j}", None) for j in range(len(rem))])


def layer_cache(cfg: ModelConfig, caches, i: int) -> Dict[str, torch.Tensor]:
    sec, key, g = layer_places(cfg)[i]
    node = caches[sec][key]
    return dict(node) if g is None else {n: leaf[g] for n, leaf in
                                         node.items()}


def stack_layers(cfg: ModelConfig,
                 per_layer: List[Dict[str, torch.Tensor]]) -> Dict:
    """Per-layer cache leaves -> the cache tree: "groups" leaves stacked on
    a leading repetition axis, "rem" leaves as they are."""
    by_key: Dict[Tuple[str, str], List[Dict[str, torch.Tensor]]] = {}
    for (sec, key, _), leaves_ in zip(layer_places(cfg), per_layer):
        by_key.setdefault((sec, key), []).append(leaves_)
    tree: Dict[str, Dict] = {}
    for (sec, key), ls in by_key.items():
        tree.setdefault(sec, {})[key] = (
            {n: torch.stack([u[n] for u in ls]) for n in ls[0]}
            if sec == "groups" else ls[0])
    return tree


def lm_logits(lm: LM, h):
    return unembed(lm.embed.w, h, getattr(lm.unembed, "w", None))


def _remat(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _train_stack(lm: LM, cfg: ModelConfig, h, start_pos, remat: bool):
    """The training forward's blocks: no cache is built and no block
    returns its new K/V (under remat a returned K/V would be an output that
    stays alive). With `remat`, `cfg.remat_granularity` places
    `torch.utils.checkpoint` as the reference places `jax.checkpoint`:
    "layer" around each block, "group" around each repetition of the
    pattern, "both" nested; the "rem" blocks are never rematerialised."""
    pat, n_groups, _ = cfg.pattern_groups()
    per_layer = remat and cfg.remat_granularity in ("layer", "both")
    outer = remat and cfg.remat_granularity in ("group", "both")

    def one(block, x):
        return block_prefill(block, cfg, x, start_pos)[0]

    def layer(block, x):
        return _remat(partial(one, block), x) if per_layer else one(block, x)

    def group(blocks, x):
        for block in blocks:
            x = layer(block, x)
        return x

    n = n_groups * len(pat)
    for g in range(0, n, len(pat)):
        blocks = lm.blocks[g:g + len(pat)]
        h = (_remat(partial(group, blocks), h) if outer
             else group(blocks, h))
    for block in lm.blocks[n:]:
        h = one(block, h)
    return h


def lm_hidden(lm: LM, cfg: ModelConfig, tokens, *, mode: str = "prefill",
              caches=None, start_pos: int = 0, kv_lens=None,
              prefix_start=None, frontend_embeds=None,
              attention_impl: str = "torch", remat: bool = False):
    """Run the stack over (B, S) tokens in "prefill" or "train" mode.
    Returns (post-final-norm hidden (B, S, D), the new tokens' caches as a
    tree — {} in train mode, which builds none).

    A vision model's `frontend_embeds` (B, F, D) — the stub's patch
    embeddings — go before the tokens' embeddings and occupy the first F
    positions from `start_pos` (RoPE included); their K/V are in the
    caches (F + S rows), and their rows are dropped from the hidden
    states. Train mode takes no prefix and runs the reference's train path
    (`attention_impl="torch"`), rematerialised when `remat`
    (`_train_stack`)."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode {mode!r} not in ('prefill', 'train')")
    h = embed(lm.embed.w, cfg, tokens).to(cfg.torch_dtype)
    n_front = 0
    if cfg.frontend != "none" and frontend_embeds is not None:
        n_front = frontend_embeds.shape[1]
        h = torch.cat([frontend_embeds.to(h.device, cfg.torch_dtype), h],
                      dim=1)
    if mode == "train":
        h = _train_stack(lm, cfg, h, start_pos, remat)
        return lm.final_norm(h)[:, n_front:], {}
    outs = []
    for i, block in enumerate(lm.blocks):
        prefix = None if caches is None else layer_cache(cfg, caches, i)
        h, co = block_prefill(block, cfg, h, start_pos, cache=prefix,
                              kv_lens=kv_lens, prefix_start=prefix_start,
                              attention_impl=attention_impl)
        outs.append(co)
    return lm.final_norm(h)[:, n_front:], stack_layers(cfg, outs)


def logits_of(h, logits_at):
    """The hidden row whose logits a prefill returns: the last (logits_at
    None), one index for the batch, or one index per sequence."""
    if logits_at is None:
        return h[:, -1]
    if not torch.is_tensor(logits_at) or logits_at.dim() == 0:
        return h[:, int(logits_at)]
    return h[torch.arange(h.shape[0], device=h.device),
             logits_at.to(h.device).long()]


def lm_prefill(lm: LM, cfg: ModelConfig, tokens, *, caches=None,
               start_pos: int = 0, kv_lens=None, prefix_start=None,
               logits_at=None, frontend_embeds=None,
               attention_impl: str = "torch"):
    """Prefill: returns (logits (B,V), caches_out). logits_at selects the
    text position whose logits are returned (the engine passes true_len-1
    when the token batch is right-padded to a bucket; default: last
    position); a frontend's positions are not counted."""
    h, caches_out = lm_hidden(lm, cfg, tokens, caches=caches,
                              start_pos=start_pos, kv_lens=kv_lens,
                              prefix_start=prefix_start,
                              frontend_embeds=frontend_embeds,
                              attention_impl=attention_impl)
    return lm_logits(lm, logits_of(h, logits_at)), caches_out


def lm_decode(lm: LM, cfg: ModelConfig, token, caches, position,
              kv_lens=None, ctx_limit=None, attention_impl: str = "torch"):
    """One decode step. token: (B,) int; caches as from `Model.init_cache`.
    Returns (logits (B,V), cache updates) — the new token's K/V only, in the
    cache tree's layout with length 1, or the updated recurrent state."""
    h = embed(lm.embed.w, cfg, token[:, None]).to(cfg.torch_dtype)
    ups = []
    for i, block in enumerate(lm.blocks):
        h, up = block_decode(block, cfg, h, position,
                             layer_cache(cfg, caches, i),
                             kv_lens=kv_lens, ctx_limit=ctx_limit,
                             attention_impl=attention_impl)
        ups.append(up)
    return lm_logits(lm, lm.final_norm(h)[:, 0]), stack_layers(cfg, ups)
