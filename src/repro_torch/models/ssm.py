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

On a mesh (``plan.enabled``) each rank runs its batch rows and its TP
block of the channels, as the reference's rules lay them out: RWKV6's
time-mix on its wkv heads (``wr`` / ``wk`` / ``wv`` / ``wg``, the decay and
the bonus cut over ``heads`` when ``plan.heads_sharded``), the channel-mix
and the RG-LRU on their ``ffn`` block; the carried states are cut alike
(the wkv memory over heads, the LRU state and the conv tail over ``ffn``).
The recurrences need whole time order, so a seq-cut residual is gathered
on entry and every row-parallel output leaves through ``plan.reduce_out``.
Two products cross the cut: RWKV6's ``ln_x`` normalises over all heads
(its mean of squares is a TP psum of each rank's sum), and the RG-LRU's
gates multiply the rank's ``conv`` columns by its row block of
``w_input_gate`` / ``w_rec_gate`` (``("ffn", None)``), a partial sum over
TP: each rank forms it in f32, one reduce-scatter along the channels
sums the ranks' partials in f32 and leaves each rank its own columns,
rounded once to the serving dtype (the reference's one product
accumulates in f32 and rounds once too; only the order of the f32 sum
differs).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan, rwkv_heads
from repro_torch.models.layers import rms_norm
from repro_torch.models.param import P


# ---------------------------------------------------------------------------
# RWKV6 (Finch) time-mix: data-dependent decay  [arXiv:2404.05892]
# ---------------------------------------------------------------------------

def rwkv6_spec(cfg: ModelConfig) -> dict:
    h = cfg.d_model
    nh = rwkv_heads(cfg)           # rwkv6 uses head_size 64
    hd = h // nh
    lora = 64                       # decay LoRA rank (w_lora in Finch)
    return {
        "norm": P((h,), ("embed",), init="zeros", tp_share="seq"),
        "mu": P((5, h), (None, "embed"), init="zeros",      # r,k,v,w,g mixes
                tp_share="heads"),
        "wr": P((h, nh, hd), ("embed", "heads", None)),
        "wk": P((h, nh, hd), ("embed", "heads", None)),
        "wv": P((h, nh, hd), ("embed", "heads", None)),
        "wg": P((h, nh, hd), ("embed", "heads", None)),
        "w0": P((nh, hd), ("heads", None), init="zeros"),   # decay bias
        "w_lora_a": P((h, lora), ("embed", None), tp_share="heads"),
        "w_lora_b": P((lora, nh, hd), (None, "heads", None)),
        "bonus": P((nh, hd), ("heads", None), init="zeros"),  # first-token u
        "ln_x": P((h,), ("embed",), init="zeros",           # output norm
                  tp_share="heads"),
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


def _channel_block(plan: ShardingPlan, n: int) -> slice:
    """This rank's block of ``n`` channels cut over the TP axes."""
    if plan.tp <= 1:
        return slice(0, n)
    k = n // plan.tp
    j = C.axis_index(plan.mesh, plan.tp_axes)
    return slice(j * k, (j + 1) * k)


def _ln_x(out, w, cfg: ModelConfig, plan: ShardingPlan, heads_cut: bool):
    """``rms_norm`` over all heads of ``out`` (b, s, nh * hd): with the
    heads cut over TP, ``out`` holds this rank's and the mean of squares
    is the TP psum of each rank's sum over the whole width."""
    if not heads_cut:
        return rms_norm(out, w, cfg.norm_eps)
    xf = out.float()
    # each rank's gradient of the sum is its heads' share
    ss = C.psum(xf.square().sum(-1, keepdim=True), plan.mesh, plan.tp_axes,
                grad="sum")
    var = ss / cfg.d_model
    w_loc = w[_channel_block(plan, w.shape[0])]
    return ((xf * torch.rsqrt(var + cfg.norm_eps))
            * (1.0 + w_loc.float())).to(out.dtype)


def rwkv6_time_mix(p, x, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN,
                   *, state: Optional[torch.Tensor] = None,
                   x_prev: Optional[torch.Tensor] = None,
                   seq_sharded: bool = False):
    """RWKV6 time-mix.  x (b, s, h).  Returns (out, (state, x_last)):
    ``state`` is the (b, nh, hd, hd) f32 wkv memory, ``x_last`` the last
    normed row (b, 1, h), the next call's ``x_prev`` (token shift across
    decode steps).  On a mesh nh is this rank's heads, x (and out) its
    seq block when ``seq_sharded``, x_last whole."""
    heads_cut = plan.heads_sharded(cfg)
    nh = p["w0"].shape[0]
    xn = plan.gather_seq(rms_norm(x, p["norm"], cfg.norm_eps), seq_sharded,
                         parallel=heads_cut)
    b, s, h = xn.shape
    hd = h // rwkv_heads(cfg)
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
    out = torch.stack(outs, 1).reshape(b, s, nh * hd).to(x.dtype)
    out = _ln_x(out, p["ln_x"], cfg, plan, heads_cut) \
        * g.reshape(b, s, nh * hd)
    out = out.reshape(b * s, nh * hd) @ p["wo"].reshape(nh * hd, h)
    out = out.reshape(b, s, h)
    out = plan.reduce_out(out, seq_sharded) if heads_cut \
        else plan.cut_seq(out, seq_sharded)
    return out, (state, xn[:, -1:])


def rwkv6_channel_mix_spec(cfg: ModelConfig) -> dict:
    h, f = cfg.d_model, cfg.d_ff
    return {
        "norm": P((h,), ("embed",), init="zeros", tp_share="seq"),
        "mu": P((2, h), (None, "embed"), init="zeros", tp_share="seq"),
        "wk": P((h, f), ("embed", "ffn")),
        "wv": P((f, h), ("ffn", "embed")),
        "wr": P((h, h), ("embed", None), tp_share="seq"),
    }


def rwkv6_channel_mix(p, x, cfg: ModelConfig,
                      plan: ShardingPlan = NULL_PLAN, *,
                      x_prev: Optional[torch.Tensor] = None,
                      seq_sharded: bool = False):
    """RWKV6 channel-mix.  x (b, s, h).  Returns (out, x_last).  On a mesh
    ``wk`` / ``wv`` are this rank's ``ffn`` block (column- then
    row-parallel): ``k @ wv`` is reduced before the receptance gate.
    The receptance runs on the rank's rows whole (its seq block when the
    stream is cut), so only ``xk`` enters the TP-parallel products: with
    the stream whole it alone passes ``copy_in``."""
    xn = plan.gather_seq(rms_norm(x, p["norm"], cfg.norm_eps), seq_sharded,
                         parallel=seq_sharded)
    shifted = _token_shift(xn, x_prev)
    xk, xr = xn[None] + p["mu"][:, None, None, :] * (shifted - xn)[None]
    if not seq_sharded:
        xk = plan.copy_in(xk)
    k = torch.relu(xk @ p["wk"]).square()
    kv = plan.reduce_out(k @ p["wv"], seq_sharded)
    out = torch.sigmoid(plan.cut_seq(xr, seq_sharded, grad="sum")
                        @ p["wr"]) * kv
    return out, xn[:, -1:]


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin)  [arXiv:2402.19427]
# ---------------------------------------------------------------------------

def rglru_spec(cfg: ModelConfig) -> dict:
    h = cfg.d_model
    w = cfg.lru_width
    cw = cfg.conv1d_width
    return {
        "norm": P((h,), ("embed",), init="zeros", tp_share="seq"),
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


def _rglru_gates(p, conv, plan: ShardingPlan):
    """The input and recurrence gates' pre-activations of ``conv`` (b, s,
    w_loc).  On one device (or TP 1) ``conv @ W`` in the serving dtype;
    with TP, this rank's f32 partial sums over its rows of W, reduced and
    scattered along the channels in f32, then rounded to conv's dtype."""
    if plan.tp <= 1:
        return conv @ p["w_input_gate"], conv @ p["w_rec_gate"]
    cf = conv.float()
    part = torch.stack([cf @ p["w_input_gate"].float(),
                        cf @ p["w_rec_gate"].float()])      # (2, b, s, w)
    both = C.psum_scatter(part, plan.mesh, plan.tp_axes,
                          scatter_dimension=-1).to(conv.dtype)
    return both[0], both[1]


def rglru_block(p, x, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN, *,
                state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                seq_sharded: bool = False):
    """Griffin recurrent block: causal conv1d + RG-LRU, gated.  x (b, s, h).

    Returns (out, (lru_state (b, w) f32, conv_state (b, cw - 1, w))); on a
    mesh w is this rank's ``ffn`` block of ``lru_width``."""
    cw = cfg.conv1d_width
    xn = plan.gather_seq(rms_norm(x, p["norm"], cfg.norm_eps), seq_sharded)
    b, s, h = xn.shape
    w = p["w_x"].shape[1]
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
    pre_i, pre_r = _rglru_gates(p, conv, plan)
    i_gate = torch.sigmoid(pre_i + p["b_input_gate"])
    r_gate = torch.sigmoid(pre_r + p["b_rec_gate"])
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
    return plan.reduce_out((y * gate) @ p["w_out"], seq_sharded), \
        (state, new_conv_state)


__all__ = [
    "rwkv6_spec", "rwkv6_time_mix", "rwkv6_channel_mix_spec",
    "rwkv6_channel_mix", "rglru_spec", "rglru_block",
]
