"""Meta-tensor stand-ins for every (arch x shape): one rank's arguments.

``input_specs`` returns the arguments of the step function the given
workload shape runs (``launch/dryrun.py``), as tensors on the meta device,
which hold shapes and no data:

  train_4k                   -> train_step(params, opt_state, batch)
  prefill_32k                -> prefill_step(params, batch, cache)
  decode_32k / long_500k     -> decode_step(params, tokens, cache)

The reference's ``launch/specs.py`` returns ShapeDtypeStructs of the whole
arrays beside the NamedShardings that cut them over the mesh.  The port
runs one process a rank, so a spec here is that rank's block itself: the
parameters through ``plan.keep_hook`` (``plan.store_spec`` gives each
leaf's mesh axes, ``params_and_specs``), the dense cache through
``models.model.init_cache(plan=)``.  On another device the same shapes
come back as zeros.

Where the port lays a tensor out differently from the reference's
NamedSharding (``tests/test_torch_specs.py`` checks each against the
reference's shard shapes and lists these):

* ``head_dim``, ``kv_head_dim`` and ``qk`` stay whole; the heads are cut
  over TP only where TP divides the query and the kv heads
  (``ShardingPlan.heads_sharded``), else the attention runs replicated,
  where the reference falls back to cutting ``head_dim``;
* every rank is handed the whole batch (tokens, labels, mask, embeds,
  frames) and the cache's ``length`` covers every slot: the forward takes
  the rank's rows itself (``plan.rows``), where the reference cuts them
  over the batch axes;
* a dense cache buffer holds the rank's rows and, where they split, its
  heads, whole along ``kv_seq``, where the reference cuts ``kv_seq`` over
  TP (ROADMAP queue C, "Mesh layout choices"): MLA's latent (no head
  axis) and a ring's positions stay whole, and the recurrent states cut
  their heads (RWKV6) or channels (the RG-LRU) over TP where the
  reference keeps them whole.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan
from repro_torch.models.model import init_cache, model_spec
from repro_torch.models.param import is_p
from repro_torch.training.optimizer import init_opt_state


def _new(shape, dtype, device):
    """No data on the meta device; zeros elsewhere."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


def _sliced(shape: tuple, sl) -> tuple:
    if sl is None:
        return tuple(shape)
    return tuple(len(range(*s.indices(n))) for s, n in zip(sl, shape))


def params_and_specs(cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN,
                     dtype=torch.bfloat16, *, device="meta"):
    """(params, specs): this rank's block of every parameter, and each
    leaf's ``plan.store_spec`` (one entry a dim: None or the mesh axes it
    is cut over; all None with no mesh)."""
    keep = plan.keep_hook(cfg)

    def walk(path, node):
        if is_p(node):
            sl = keep(path, node) if keep is not None else None
            return (_new(_sliced(node.shape, sl), dtype, device),
                    plan.store_spec(cfg, node))
        if isinstance(node, dict):
            pairs = {k: walk(path + (k,), node[k]) for k in sorted(node)}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        pairs = [walk(path + (i,), v) for i, v in enumerate(node)]
        return [v[0] for v in pairs], [v[1] for v in pairs]
    return walk((), model_spec(cfg))


def batch_specs(cfg: ModelConfig, shape: InputShape, *, with_labels: bool,
                device="meta") -> dict:
    """{tokens, labels, embeds, frames, mask}, the whole batch (every rank
    is handed all of it): tokens (b, s_text) int32, where a decode step
    has one row a slot and qwen2-vl's vision stub takes its
    ``n_frontend_tokens`` rows (bf16 ``embeds``) off the prompt; whisper's
    ``frames`` (b, n_frames, d_enc) bf16; labels (b, s) int32 and, with
    the stub, a float32 loss ``mask``."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        s = 1
    n_front = cfg.n_frontend_tokens if (cfg.frontend == "vision_stub"
                                        and shape.kind != "decode") else 0
    batch = {"tokens": _new((b, s - n_front), torch.int32, device)}
    if n_front:
        batch["embeds"] = _new((b, n_front, cfg.d_model), torch.bfloat16,
                               device)
    if cfg.frontend == "audio_stub" and shape.kind != "decode":
        e = cfg.encoder
        batch["frames"] = _new((b, e.n_frames, e.d_model), torch.bfloat16,
                               device)
    if with_labels:
        batch["labels"] = _new((b, s), torch.int32, device)
        if n_front:
            batch["mask"] = _new((b, s), torch.float32, device)
    return batch


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                plan: ShardingPlan = NULL_PLAN, dtype=torch.bfloat16, *,
                vector_lengths: bool = True, device="meta") -> dict:
    """The dense cache of this rank (``init_cache(plan=)``).
    ``vector_lengths``: a per-slot (batch,) int32 ``length`` of every slot
    (continuous-batching decode); a prefill keeps the 0-d one (every
    request starts at offset 0)."""
    cache = init_cache(cfg, batch, max_len, dtype, device, plan)
    if vector_lengths:
        cache = {**cache, "length": _new((batch,), torch.int32, device)}
    return cache


def input_specs(cfg: ModelConfig, shape: InputShape,
                plan: ShardingPlan = NULL_PLAN, dtype=torch.bfloat16, *,
                device="meta") -> tuple:
    """The step's arguments for ``shape`` on this rank (module docstring);
    the optimizer's moments are bf16, as the reference's dry run keeps
    them (float32 moments of the 236B config would not fit)."""
    params, _ = params_and_specs(cfg, plan, dtype, device=device)
    if shape.kind == "train":
        batch = batch_specs(cfg, shape, with_labels=True, device=device)
        return params, init_opt_state(params, torch.bfloat16), batch
    batch = batch_specs(cfg, shape, with_labels=False, device=device)
    cache = cache_specs(cfg, shape.global_batch, shape.seq_len, plan, dtype,
                        vector_lengths=shape.kind != "prefill",
                        device=device)
    if shape.kind == "prefill":
        return params, batch, cache
    return params, batch["tokens"], cache


__all__ = ["input_specs", "params_and_specs", "batch_specs", "cache_specs"]
