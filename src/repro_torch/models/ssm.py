"""Recurrent layers: RWKV6 (Finch) time-mix and channel-mix, and the RG-LRU
block of RecurrentGemma (Griffin).

Both are attention-free O(seq) layers.  A sequence is processed by a loop
over time carrying the state; decode is the same loop at one token against
the carried state (the recurrent analogue of the KV cache).  The loop runs
in the reference's order (its ``lax.scan``), step by step, so the f32 state
sums in the same sequence; only the elementwise work that does not depend
on the carry is hoisted out of it.  The dtype steps are the reference's:
the wkv memory, its decay ``w`` and bonus ``u`` run in f32, as do the LRU's
``a``, its gated input and its state; ``log_a`` is formed in the serving
dtype before the cast, and the conv state stays in the serving dtype.

No hand kernel lies on these layers: the products are plain matmuls and the
recurrences are the plain bodies of the reference's scans.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.param import P


# ---------------------------------------------------------------------------
# RWKV6 (Finch) time-mix: data-dependent decay  [arXiv:2404.05892]
# ---------------------------------------------------------------------------

def rwkv6_spec(cfg: ModelConfig) -> dict:
    h = cfg.d_model
    nh = max(1, h // 64)           # rwkv6 uses head_size 64
    hd = h // nh
    lora = 64                       # decay LoRA rank (w_lora in Finch)
    return {
        "norm": P((h,), ("embed",), init="zeros"),
        "mu": P((5, h), (None, "embed"), init="zeros"),     # r,k,v,w,g mixes
        "wr": P((h, nh, hd), ("embed", "heads", None)),
        "wk": P((h, nh, hd), ("embed", "heads", None)),
        "wv": P((h, nh, hd), ("embed", "heads", None)),
        "wg": P((h, nh, hd), ("embed", "heads", None)),
        "w0": P((nh, hd), ("heads", None), init="zeros"),   # decay bias
        "w_lora_a": P((h, lora), ("embed", None)),
        "w_lora_b": P((lora, nh, hd), (None, "heads", None)),
        "bonus": P((nh, hd), ("heads", None), init="zeros"),  # first-token u
        "ln_x": P((h,), ("embed",), init="zeros"),          # output norm
        "wo": P((nh, hd, h), ("heads", None, "embed")),
    }


def _token_shift(xn, x_prev):
    """The previous token's row for every row: ``x_prev`` (b, 1, h), or
    zeros, ahead of ``xn[:, :-1]``."""
    if x_prev is None:
        x_prev = xn.new_zeros(xn.shape[0], 1, xn.shape[2])
    return torch.cat([x_prev.to(xn.dtype), xn[:, :-1]], dim=1)


def _heads(x, w):
    """(b, s, h) @ (h, n, d) -> (b, s, n, d)."""
    b, s, h = x.shape
    return (x.reshape(b * s, h) @ w.reshape(h, -1)).reshape(b, s,
                                                            *w.shape[1:])


def _rwkv6_step(state, r, kv, ukv, w):
    """One recurrence step.  state (b, nh, hd, hd) f32 outer-product
    memory; r, w (b, nh, hd); kv = k (x) v and ukv = u * kv (b, nh, hd,
    hd).  Returns (state, out (b, nh, hd))."""
    out = (r[..., None, :] @ (state + ukv))[..., 0, :]
    return state * w[..., :, None] + kv, out


def rwkv6_time_mix(p, x, cfg: ModelConfig, *,
                   state: Optional[torch.Tensor] = None,
                   x_prev: Optional[torch.Tensor] = None):
    """RWKV6 time-mix.  x (b, s, h).  Returns (out, (state, x_last)):
    ``state`` is the (b, nh, hd, hd) f32 wkv memory, ``x_last`` the last
    normed row (b, 1, h), the next call's ``x_prev`` (token shift across
    decode steps)."""
    b, s, h = x.shape
    nh = p["w0"].shape[0]
    hd = h // nh
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    shifted = _token_shift(xn, x_prev)
    mix = xn[None] + p["mu"][:, None, None, :] * (shifted - xn)[None]
    xr, xk, xv, xw, xg = mix

    r = _heads(xr, p["wr"])
    k = _heads(xk, p["wk"])
    v = _heads(xv, p["wv"])
    g = F.silu(_heads(xg, p["wg"]))
    # data-dependent decay (the Finch contribution): w_t = exp(-exp(dd_t))
    dd = p["w0"] + _heads(xw @ p["w_lora_a"], p["w_lora_b"])
    w = torch.exp(-torch.exp(dd.float()))
    u = p["bonus"].float()

    if state is None:
        state = torch.zeros(b, nh, hd, hd, dtype=torch.float32,
                            device=x.device)
    r, k, v = r.float(), k.float(), v.float()
    kv = k[..., :, None] * v[..., None, :]             # (b, s, nh, hd, hd)
    ukv = u[:, :, None] * kv
    outs = []
    for t in range(s):
        state, o = _rwkv6_step(state, r[:, t], kv[:, t], ukv[:, t], w[:, t])
        outs.append(o)
    out = torch.stack(outs, 1).reshape(b, s, h).to(x.dtype)
    out = rms_norm(out, p["ln_x"], cfg.norm_eps) * g.reshape(b, s, h)
    out = out.reshape(b * s, h) @ p["wo"].reshape(h, h)
    return out.reshape(b, s, h), (state, xn[:, -1:])


def rwkv6_channel_mix_spec(cfg: ModelConfig) -> dict:
    h, f = cfg.d_model, cfg.d_ff
    return {
        "norm": P((h,), ("embed",), init="zeros"),
        "mu": P((2, h), (None, "embed"), init="zeros"),
        "wk": P((h, f), ("embed", "ffn")),
        "wv": P((f, h), ("ffn", "embed")),
        "wr": P((h, h), ("embed", None)),
    }


def rwkv6_channel_mix(p, x, cfg: ModelConfig, *,
                      x_prev: Optional[torch.Tensor] = None):
    """RWKV6 channel-mix.  x (b, s, h).  Returns (out, x_last)."""
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    shifted = _token_shift(xn, x_prev)
    xk, xr = xn[None] + p["mu"][:, None, None, :] * (shifted - xn)[None]
    k = torch.relu(xk @ p["wk"]).square()
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    return out, xn[:, -1:]


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin)  [arXiv:2402.19427]
# ---------------------------------------------------------------------------

def rglru_spec(cfg: ModelConfig) -> dict:
    h = cfg.d_model
    w = cfg.lru_width
    cw = cfg.conv1d_width
    return {
        "norm": P((h,), ("embed",), init="zeros"),
        "w_x": P((h, w), ("embed", "ffn")),       # input branch
        "w_gate_branch": P((h, w), ("embed", "ffn")),
        "conv_w": P((cw, w), (None, "ffn"), init="zeros"),
        "conv_b": P((w,), ("ffn",), init="zeros"),
        # RG-LRU gates
        "w_input_gate": P((w, w), ("ffn", None)),
        "b_input_gate": P((w,), ("ffn",), init="zeros"),
        "w_rec_gate": P((w, w), ("ffn", None)),
        "b_rec_gate": P((w,), ("ffn",), init="zeros"),
        "lambda_p": P((w,), ("ffn",), init="zeros"),  # recurrence magnitude
        "w_out": P((w, h), ("ffn", "embed")),
    }


_C_LRU = 8.0  # Griffin's fixed scalar on the recurrence gate


def rglru_block(p, x, cfg: ModelConfig, *,
                state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None):
    """Griffin recurrent block: causal conv1d + RG-LRU, gated.  x (b, s, h).

    Returns (out, (lru_state (b, w) f32, conv_state (b, cw - 1, w)))."""
    b, s, h = x.shape
    w, cw = cfg.lru_width, cfg.conv1d_width
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    gate = F.gelu(xn @ p["w_gate_branch"], approximate="tanh")
    u = xn @ p["w_x"]

    # temporal conv1d (causal, width cw)
    if conv_state is None:
        conv_state = u.new_zeros(b, cw - 1, w)
    u_pad = torch.cat([conv_state.to(u.dtype), u], dim=1)
    new_conv_state = u_pad[:, -(cw - 1):] if cw > 1 else conv_state
    conv = u_pad[:, 0:s] * p["conv_w"][0]
    for i in range(1, cw):
        conv = conv + u_pad[:, i:i + s] * p["conv_w"][i]
    conv = conv + p["conv_b"]

    # RG-LRU
    i_gate = torch.sigmoid(conv @ p["w_input_gate"] + p["b_input_gate"])
    r_gate = torch.sigmoid(conv @ p["w_rec_gate"] + p["b_rec_gate"])
    log_a = -_C_LRU * r_gate * F.softplus(p["lambda_p"])
    a = torch.exp(log_a.float())
    gated_x = (i_gate * conv).float()
    # the step is h = a * h + sqrt(max(1 - a^2, 0)) * gx; the second term
    # does not depend on the carry
    drive = torch.sqrt((1.0 - a.square()).clamp_min(0.0)) * gated_x

    if state is None:
        state = torch.zeros(b, w, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        state = a[:, t] * state + drive[:, t]
        ys.append(state)
    y = torch.stack(ys, 1).to(x.dtype)
    return (y * gate) @ p["w_out"], (state, new_conv_state)


__all__ = [
    "rwkv6_spec", "rwkv6_time_mix", "rwkv6_channel_mix_spec",
    "rwkv6_channel_mix", "rglru_spec", "rglru_block",
]
