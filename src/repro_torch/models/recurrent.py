"""The recurrent layers of the JAX package's `models/recurrent.py`: RWKV6
("Finch", data-dependent decay) — the time-mix and the channel-mix — and
RG-LRU (RecurrentGemma / Griffin).

The modules hold their parameters under the reference's leaf names, and the
dtype steps follow it exactly: the token-shift lerp takes sigmoid(mu) in
fp32 cast to the model dtype, the decay LoRA runs in the model dtype before
fp32, and the WKV output goes through the per-head group norm in fp32.

The WKV recurrence of a prefill runs in the hand-written kernel K3
(`kernels/ops.wkv6`) under `attention_impl="cuda"` and in the chunk-parallel
`wkv6_chunked` under "torch" — the two compute one function, as the
reference's own test holds its Pallas kernel and its jnp chunked version
together. A decode step is torch ops, as it is jnp in the reference.

RG-LRU keeps the reference's leaf names and dtype steps too: the gates are
fp32 GEMMs of the fp32-cast input and weights (the bf16 weights are cast at
each call, not cached), the prefill's input weight is sqrt(1 - exp(2 log a))
and the decode's sqrt(1 - a·a), each as the reference writes it, and the
output gate is gelu in its tanh form. The prefill's recurrence runs in the
hand-written kernel K4 (`kernels/ops.rglru_scan`) under "cuda" and in
`rglru_scan_logdepth` — the reference's associative combine in torch ops —
under "torch". A decode step is torch ops under both.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

from .config import ModelConfig
from .layers import gelu, param


def _rwkv_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_heads, n_heads_padded, attention width). rwkv_pad_heads_to pads
    the head axis; the padded heads are dead (their r is zeroed)."""
    hs = cfg.rwkv_head_size
    nh = cfg.d_model // hs
    nh_pad = max(cfg.rwkv_pad_heads_to, nh) if cfg.rwkv_pad_heads_to else nh
    return nh, nh_pad, nh_pad * hs


class TimeMix(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dt, hs = cfg.d_model, cfg.torch_dtype, cfg.rwkv_head_size
        _, nh_pad, da = _rwkv_dims(cfg)
        lora = max(32, d // 32)
        for n in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
            setattr(self, n, param((d,), dt, device))
        for n in ("wr", "wk", "wv", "wg"):
            setattr(self, n, param((d, da), dt, device))
        self.wo = param((da, d), dt, device)
        self.w0 = param((da,), torch.float32, device)
        self.wA = param((d, lora), dt, device)
        self.wB = param((lora, da), dt, device)
        self.bonus_u = param((nh_pad, hs), torch.float32, device)
        self.ln_y = param((da,), dt, device)


class ChannelMix(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.torch_dtype
        self.mu_k = param((d,), dt, device)
        self.mu_r = param((d,), dt, device)
        self.wk = param((d, cfg.d_ff), dt, device)
        self.wv = param((cfg.d_ff, d), dt, device)
        self.wr = param((d, d), dt, device)


def _lerp(x, shifted, mu):
    return x + (shifted - x) * torch.sigmoid(mu.float()).to(x.dtype)


def _rwkv_mix(tmix: TimeMix, x, x_prev) -> Dict[str, torch.Tensor]:
    """Token shift: per-projection lerp between x_t and x_{t-1}.
    x: (B, S, D); x_prev: (B, 1, D), the last token of the previous
    segment."""
    shifted = torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)
    return {n: _lerp(x, shifted, getattr(tmix, f"mu_{n}"))
            for n in ("r", "k", "v", "g", "w")}


def _rwkv_rkvwg(tmix: TimeMix, cfg: ModelConfig, x, x_prev):
    B, S, _ = x.shape
    hs = cfg.rwkv_head_size
    nh, nh_pad, _ = _rwkv_dims(cfg)
    m = _rwkv_mix(tmix, x, x_prev)
    r = (m["r"] @ tmix.wr).reshape(B, S, nh_pad, hs)
    k = (m["k"] @ tmix.wk).reshape(B, S, nh_pad, hs)
    v = (m["v"] @ tmix.wv).reshape(B, S, nh_pad, hs)
    g = F.silu(m["g"] @ tmix.wg)
    logw = -torch.exp(
        tmix.w0.float() + (torch.tanh(m["w"] @ tmix.wA) @ tmix.wB).float()
    ).reshape(B, S, nh_pad, hs)  # log decay, strictly < 0
    if nh_pad != nh:
        # dead padded heads: zero r so they contribute nothing downstream
        mask = (torch.arange(nh_pad, device=x.device) < nh).to(r.dtype)
        r = r * mask[None, None, :, None]
    return r, k, v, g, logw


def wkv6_chunked(r, k, v, logw, u, state, chunk: int = 64):
    """Chunk-parallel WKV6. r, k, v: (B, S, H, hs) any float; logw:
    (B, S, H, hs) fp32 (< 0); u: (H, hs); state: (B, H, hs, hs) fp32
    (key-major, value-minor). Returns (y (B, S, H, hs) fp32, final_state).
    Every decay exponent is a difference along time, so every exp argument
    is <= 0. Pad steps get k = 0 and logw = 0 (decay 1), so the state
    carries through them; their y is dropped."""
    B, S, H, hs = r.shape
    c = min(chunk, S)
    pad = (-S) % c
    rf, kf, vf, wf = r.float(), k.float(), v.float(), logw.float()
    if pad:
        z = lambda a: F.pad(a, (0, 0, 0, 0, 0, pad))  # noqa: E731
        rf, kf, vf, wf = z(rf), z(kf), z(vf), z(wf)
    uf = u.float()
    tri_lower = torch.tril(torch.ones(c, c, dtype=torch.bool,
                                      device=r.device), diagonal=-1)
    eye = torch.eye(c, dtype=rf.dtype, device=r.device)
    S0 = state.float()
    ys = []
    for c0 in range(0, S + pad, c):
        rc, kc, vc, wc = (a[:, c0:c0 + c] for a in (rf, kf, vf, wf))
        cum = torch.cumsum(wc, dim=1)  # inclusive cumulative log-decay
        e_t = cum - wc  # cum_{t-1}
        dmat = e_t[:, :, None] - cum[:, None, :]  # (B, t, j, H, hs)
        A = torch.einsum("bthi,bjhi,btjhi->bhtj", rc, kc,
                         torch.exp(torch.clamp(dmat, max=0.0))
                         * tri_lower[None, :, :, None, None])
        # The bonus term r·(u ⊙ k) can cancel to near 0 on a head, and the
        # per-head group norm after it (variance << eps) then scales its
        # rounding by up to 1/sqrt(eps) ~ 316: its 16-64 products are summed
        # in float64, so the one rounding left is the result's own.
        diag = torch.einsum("bthi,bthi->bht", rc.double(),
                            (uf[None, None] * kc).double()).to(rc.dtype)
        A = A + eye[None, None] * diag[..., None]
        y = torch.einsum("bhtj,bjhi->bthi", A, vc)
        r_dec = rc * torch.exp(e_t)
        y = y + torch.einsum("bthi,bhij->bthj", r_dec, S0)
        tot = cum[:, -1]  # (B, H, hs)
        k_dec = kc * torch.exp(tot[:, None] - cum)
        S0 = torch.exp(tot)[..., None] * S0 + torch.einsum(
            "bjhi,bjhv->bhiv", k_dec, vc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], S0


def _groupnorm_heads(y, scale, eps: float = 1e-5):
    """Per-head layernorm on (B, S, H, hs), then flatten and scale."""
    B, S, H, hs = y.shape
    mu = y.mean(dim=-1, keepdim=True)
    var = (y - mu).square().mean(dim=-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + eps)
    return y.reshape(B, S, H * hs) * scale.to(y.dtype)


def rwkv6_prefill(tmix: TimeMix, cfg: ModelConfig, x, state: Dict,
                  attention_impl: str = "torch"):
    """state: {"s": (B, H, hs, hs) fp32, "shift": (B, 1, D)}. Returns
    (out, state'). The WKV call runs in K3 under "cuda" (its plain version
    for CPU tensors) and in `wkv6_chunked` under "torch"."""
    r, k, v, g, logw = _rwkv_rkvwg(tmix, cfg, x, state["shift"])
    if attention_impl == "cuda":
        y, s1 = ops.wkv6(r, k, v, logw, tmix.bonus_u, state["s"],
                         impl="cuda")
    elif attention_impl == "torch":
        y, s1 = wkv6_chunked(r, k, v, logw, tmix.bonus_u, state["s"])
    else:
        raise ValueError(f"attention_impl {attention_impl!r} not in "
                         "('cuda', 'torch')")
    out = _groupnorm_heads(y, tmix.ln_y).to(x.dtype) * g
    return out @ tmix.wo, {"s": s1, "shift": x[:, -1:]}


def rwkv6_decode(tmix: TimeMix, cfg: ModelConfig, x1, state: Dict):
    """Single-token step. y = r.(S + (u*k) v^T); S' = e^{logw} (.) S +
    k v^T."""
    r, k, v, g, logw = _rwkv_rkvwg(tmix, cfg, x1, state["shift"])
    rf, kf, vf = (a[:, 0].float() for a in (r, k, v))
    S0 = state["s"]
    u = tmix.bonus_u.float()[None]
    y = torch.einsum("bhi,bhij->bhj", rf, S0) + (
        torch.einsum("bhi,bhi->bh", rf, u * kf)[..., None] * vf)
    S1 = torch.exp(logw[:, 0])[..., None] * S0 + torch.einsum(
        "bhi,bhv->bhiv", kf, vf)
    y = y[:, None].reshape(*x1.shape[:2], -1, cfg.rwkv_head_size)
    out = _groupnorm_heads(y, tmix.ln_y).to(x1.dtype) * g
    return out @ tmix.wo, {"s": S1, "shift": x1}


def rwkv6_init_state(cfg: ModelConfig, batch: int, device):
    hs = cfg.rwkv_head_size
    _, nh_pad, _ = _rwkv_dims(cfg)
    return {"s": torch.zeros((batch, nh_pad, hs, hs), dtype=torch.float32,
                             device=device),
            "shift": torch.zeros((batch, 1, cfg.d_model),
                                 dtype=cfg.torch_dtype, device=device)}


def rwkv_cmix(cmix: ChannelMix, cfg: ModelConfig, x, x_prev):
    """The family's FFN. Returns (out, the new cshift = x's last token)."""
    shifted = torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)
    kx, rx = _lerp(x, shifted, cmix.mu_k), _lerp(x, shifted, cmix.mu_r)
    k = torch.square(torch.relu(kx @ cmix.wk))
    return torch.sigmoid(rx @ cmix.wr) * (k @ cmix.wv), x[:, -1:]


# --------------------------------------------------------------------------- #
# RG-LRU (RecurrentGemma / Griffin)
# --------------------------------------------------------------------------- #
RGLRU_C = 8.0


class RGLRU(nn.Module):
    """w_in / w_gate (d, W): the recurrent branch's input and the gelu gate
    branch; w_out (W, d); conv_k (K, W), conv_b (W,): the causal depthwise
    conv; w_a, w_i (W, W) with fp32 biases b_a, b_i: the recurrence and
    input gates; lam (W,) fp32: the per-channel base decay Λ."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, w, dt = cfg.d_model, cfg.lru_width, cfg.torch_dtype
        self.w_in = param((d, w), dt, device)
        self.w_gate = param((d, w), dt, device)
        self.w_out = param((w, d), dt, device)
        self.conv_k = param((cfg.conv1d_width, w), dt, device)
        self.conv_b = param((w,), dt, device)
        self.w_a = param((w, w), dt, device)
        self.b_a = param((w,), torch.float32, device)
        self.w_i = param((w, w), dt, device)
        self.b_i = param((w,), torch.float32, device)
        self.lam = param((w,), torch.float32, device)


def _causal_conv1d(u, kern, bias, prev):
    """u: (B, S, W); kern: (K, W); prev: (B, K-1, W), the carried inputs.
    Tap i reads kern[K-1-i]. Returns (out, the new carry = the last K-1 rows
    of prev ++ u), which holds for any S, S < K-1 included."""
    K = kern.shape[0]
    S = u.shape[1]
    full = torch.cat([prev.to(u.dtype), u], dim=1)
    out = sum(full[:, i:i + S] * kern[K - 1 - i] for i in range(K))
    return out + bias, full[:, -(K - 1):]


def _rglru_gates(rg: RGLRU, u):
    """(log_a <= 0, input gate), both fp32: fp32 GEMMs of the fp32 input and
    weights, as the reference's `u.astype(f32) @ w_a.astype(f32)`."""
    uf = u.float()
    a_gate = torch.sigmoid(uf @ rg.w_a.float() + rg.b_a)
    i_gate = torch.sigmoid(uf @ rg.w_i.float() + rg.b_i)
    log_a = -RGLRU_C * F.softplus(rg.lam) * a_gate
    return log_a, i_gate


def rglru_scan_logdepth(log_a, b, h0):
    """h_t = exp(log_a_t) h_{t-1} + b_t over axis 1 as a log-depth scan in
    torch ops: h0 folded into the first step's b, then the reference's
    associative combine (a1·a2, a2·b1 + b2) applied at distances 1, 2, 4,
    .... log_a, b: (B, S, W) fp32; h0: (B, W). Returns (h_all, h_T)."""
    a = torch.exp(log_a.float())
    b = b.float().clone()
    b[:, 0] += a[:, 0] * h0.float()
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b, b[:, -1]


def rglru_prefill(rg: RGLRU, cfg: ModelConfig, x, state: Dict,
                  attention_impl: str = "torch"):
    """state: {"h": (B, W) fp32, "conv": (B, K-1, W)}. Returns (out,
    state'). The recurrence runs in K4 under "cuda" (its plain version for
    CPU tensors) and in `rglru_scan_logdepth` under "torch"."""
    u = x @ rg.w_in
    u, conv1 = _causal_conv1d(u, rg.conv_k, rg.conv_b, state["conv"])
    log_a, i_gate = _rglru_gates(rg, u)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i_gate * u.float())
    if attention_impl == "cuda":
        h, h_last = ops.rglru_scan(log_a, b, state["h"], impl="cuda")
    elif attention_impl == "torch":
        h, h_last = rglru_scan_logdepth(log_a, b, state["h"])
    else:
        raise ValueError(f"attention_impl {attention_impl!r} not in "
                         "('cuda', 'torch')")
    gate = gelu(x @ rg.w_gate)
    out = (h.to(x.dtype) * gate) @ rg.w_out
    return out, {"h": h_last, "conv": conv1}


def rglru_decode(rg: RGLRU, cfg: ModelConfig, x1, state: Dict):
    """Single-token step: h = a·h + sqrt(1 - a·a)·(i ⊙ u)."""
    u = x1 @ rg.w_in
    u, conv1 = _causal_conv1d(u, rg.conv_k, rg.conv_b, state["conv"])
    log_a, i_gate = _rglru_gates(rg, u[:, 0:1])
    a = torch.exp(log_a[:, 0])
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i_gate[:, 0] * u[:, 0].float())
    h = a * state["h"] + b
    gate = gelu(x1 @ rg.w_gate)
    out = (h[:, None].to(x1.dtype) * gate) @ rg.w_out
    return out, {"h": h, "conv": conv1}


def rglru_init_state(cfg: ModelConfig, batch: int, device):
    return {"h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, cfg.lru_width),
                                dtype=cfg.torch_dtype, device=device)}
