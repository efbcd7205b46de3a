"""Weight loader/exporter — the paper's online-stage "weight loader &
partitioner" (§III-A).

Converts between a flat HF-transformers-style checkpoint dict
(``model.layers.{i}.self_attn.q_proj.weight`` with (out, in)-major Linear
layout) and the port's parameter tree for the llama-family architectures
(smollm, minitron, gemma*, qwen2-vl text stack).  The port keeps one dict a
layer (``models.model.model_spec``), so ``model.layers.{i}.*`` maps straight
onto layer i's leaves; nothing is stacked.

The flat dict holds CPU ``torch`` tensors in the leaf's dtype, as an HF
``state_dict`` does (numpy has no bfloat16); the loader takes tensors or
numpy arrays.  ``load_llama_style(..., plan=...)`` cuts each leaf to this
rank's block on the host (``plan.keep_hook``, the hook ``init_params`` and
``bridge.from_reference`` use) before it moves to ``device``, so no whole
leaf is ever put on the card.

*gemma's tied embedding + GeGLU map 1:1; MLA/MoE archs have their own
native checkpoint layouts and are out of scope for this HF mapping.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan
from repro_torch.models.model import model_spec
from repro_torch.serving.engine import resolve_device


def _llama_names(cfg: ModelConfig, i: int) -> dict:
    base = f"model.layers.{i}."
    names = {
        "attn.wq": base + "self_attn.q_proj.weight",
        "attn.wk": base + "self_attn.k_proj.weight",
        "attn.wv": base + "self_attn.v_proj.weight",
        "attn.wo": base + "self_attn.o_proj.weight",
        "attn.norm": base + "input_layernorm.weight",
        "mlp.w_in": base + "mlp.up_proj.weight",
        "mlp.w_out": base + "mlp.down_proj.weight",
        "mlp.norm": base + "post_attention_layernorm.weight",
    }
    if cfg.activation in ("swiglu", "geglu"):      # gated MLPs only
        names["mlp.w_gate"] = base + "mlp.gate_proj.weight"
    return names


def _to_ours(key: str, arr: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """HF Linear (out, in) -> our einsum layouts."""
    h, nq, nkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    if key == "attn.wq":
        return arr.reshape(nq, hd, h).permute(2, 0, 1)       # (h, nq, hd)
    if key in ("attn.wk", "attn.wv"):
        return arr.reshape(nkv, hd, h).permute(2, 0, 1)      # (h, nkv, hd)
    if key == "attn.wo":
        return arr.reshape(h, nq, hd).permute(1, 2, 0)       # (nq, hd, h)
    if key in ("mlp.w_gate", "mlp.w_in"):
        return arr.T                                         # (h, f)
    if key == "mlp.w_out":
        return arr.T                                         # (f, h)
    return arr   # norms map 1:1 (our rms_norm uses the (1 + w) convention
                 # with zero-init, matching HF weights shifted by the loader
                 # caller when needed)


def _from_ours(key: str, arr: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    h, nq, nkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    if key == "attn.wq":
        return arr.permute(1, 2, 0).reshape(nq * hd, h)
    if key in ("attn.wk", "attn.wv"):
        return arr.permute(1, 2, 0).reshape(nkv * hd, h)
    if key == "attn.wo":
        return arr.permute(2, 0, 1).reshape(h, nq * hd)
    if key in ("mlp.w_gate", "mlp.w_in", "mlp.w_out"):
        return arr.T
    return arr


def _supported(cfg: ModelConfig) -> bool:
    return (cfg.family in ("dense", "vlm") and cfg.attention == "gqa"
            and not cfg.is_moe)


def _check_supported(cfg: ModelConfig) -> None:
    if not _supported(cfg):
        raise ValueError(
            f"{cfg.name}: not a llama-family dense arch (the HF mapping "
            "covers the dense and vlm families with GQA attention and no "
            f"experts; got family {cfg.family!r}, attention "
            f"{cfg.attention!r}, {cfg.n_experts} experts)")


def _tensor(arr) -> torch.Tensor:
    """A flat dict's entry as a CPU tensor (a numpy array is wrapped,
    copied only when it is not contiguous or not writable)."""
    return arr if isinstance(arr, torch.Tensor) \
        else torch.from_numpy(np.require(arr, requirements=("C", "W")))


def _host(t: torch.Tensor) -> torch.Tensor:
    """A leaf as an HF state_dict holds it: a contiguous CPU tensor in the
    leaf's dtype."""
    return t.detach().to("cpu").contiguous()


def export_llama_style(params, cfg: ModelConfig) -> dict:
    """The port's whole tree -> flat HF-style dict of CPU tensors
    (llama-family dense archs)."""
    _check_supported(cfg)
    flat = {}
    v = cfg.vocab_size
    flat["model.embed_tokens.weight"] = _host(params["embed"][:v])
    flat["model.norm.weight"] = _host(params["final_norm"])
    if not cfg.tie_embeddings:
        flat["lm_head.weight"] = _host(params["lm_head"].T[:v])
    for i, layer in enumerate(params["groups"][0]):
        for key, name in _llama_names(cfg, i).items():
            sub, leaf = key.split(".")
            flat[name] = _host(_from_ours(key, layer[sub][leaf], cfg))
    return flat


def load_llama_style(flat: dict, cfg: ModelConfig,
                     plan: ShardingPlan = NULL_PLAN,
                     dtype=torch.float32, device=None) -> dict:
    """Flat HF-style dict (tensors or numpy arrays) -> the port's tree on
    ``device`` in ``dtype``; with a mesh plan each leaf is this rank's
    block (``plan.keep_hook``), cut on the host.  ``device`` is CUDA unless
    the caller names another, and raises with no card."""
    _check_supported(cfg)
    dev = resolve_device(device)
    spec = model_spec(cfg)
    keep = plan.keep_hook(cfg)

    def put(t, p_decl, path):
        if tuple(t.shape) != tuple(p_decl.shape):        # vocab padding
            padded = torch.zeros(p_decl.shape, dtype=t.dtype)
            padded[tuple(slice(0, s) for s in t.shape)] = t
            t = padded
        sl = keep(path, p_decl) if keep is not None else None
        if sl is not None:
            t = t[sl]
        # a fresh contiguous leaf: never a view of the caller's dict
        return torch.empty(t.shape, dtype=dtype, device=dev).copy_(t)

    out = {"embed": put(_tensor(flat["model.embed_tokens.weight"]),
                        spec["embed"], ("embed",)),
           "final_norm": put(_tensor(flat["model.norm.weight"]),
                             spec["final_norm"], ("final_norm",))}
    if not cfg.tie_embeddings:
        out["lm_head"] = put(_tensor(flat["lm_head.weight"]).T,
                             spec["lm_head"], ("lm_head",))

    layers = []
    for i, layer_spec in enumerate(spec["groups"][0]):
        layer: dict = {"attn": {}, "mlp": {}}
        for key, name in _llama_names(cfg, i).items():
            sub, leaf = key.split(".")
            layer[sub][leaf] = put(_to_ours(key, _tensor(flat[name]), cfg),
                                   layer_spec[sub][leaf],
                                   ("groups", 0, i, sub, leaf))
        layers.append(layer)
    out["groups"] = [layers]
    return out


__all__ = ["export_llama_style", "load_llama_style"]
