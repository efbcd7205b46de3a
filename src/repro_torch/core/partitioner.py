"""Hybrid TP-EP partitioner (paper §III-C): logical axes -> mesh axes.

The plan maps the *logical* axes the models declare (``expert``,
``expert_ffn``, ``batch``, ...) onto the axes of a ``launch.mesh.Mesh`` for
one of four layouts, exactly as the reference's rules do:

  mixserve   MoE: experts over "data" (EP), the expert FFN over "model"
             (TP); batch over pod + data
  pure_tp    no EP: every rank holds all experts, FFN sharded over "model"
  pure_ep /  experts over data + model jointly (EP = every rank), tokens
  dp_ep      sliced over "model" inside the MoE block
             (``dispatch_mode``/``kernels``/``ep_overlap`` ride along)

What the port shards: only the MoE block, as the reference's ``shard_map``
body does (``models.moe.moe_block``).  Every other layer runs replicated on
each rank over the whole step's batch, which is numerically the reference's
GSPMD layout; ``constrain`` is therefore the identity.  TP-sharded
attention, the vocab-sharded head and the ``seq_resid`` sequence sharding
are later work (ROADMAP A8).  With no mesh the plan is the single-device
one (``enabled`` False).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.cost_model import EpOverlap, Strategy
from repro_torch.kernels.policy import NULL_POLICY, KernelPolicy

_LAYOUTS = ("mixserve", "pure_tp", "pure_ep", "dp_ep")


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Logical-axis -> mesh-axis rules plus the mesh (None = one device)."""

    mesh: Optional[object] = None     # launch.mesh.Mesh
    rules: dict = dataclasses.field(default_factory=dict)
    tp_axes: tuple = ()        # "intra-node" TP group
    ep_axes: tuple = ()        # "inter-node" EP group (MoE)
    dp_axes: tuple = ()        # the batch's group (includes pod)
    comm_algo: str = "fused"   # fused | sync | unfused
    kernels: KernelPolicy = NULL_POLICY
    # "auto" (-> dropless for inference) | "dropless" | "capacity"
    dispatch_mode: str = "auto"
    # micro-chunked EP-exchange schedule (dropless); None = monolithic
    ep_overlap: Optional[EpOverlap] = None

    @property
    def enabled(self) -> bool:
        return self.mesh is not None

    def axis_size(self, axes: tuple) -> int:
        if not self.enabled or not axes:
            return 1
        return self.mesh.axis_size(axes)

    @property
    def tp(self) -> int:
        return self.axis_size(self.tp_axes)

    @property
    def ep(self) -> int:
        return self.axis_size(self.ep_axes)

    @property
    def dp(self) -> int:
        return self.axis_size(self.dp_axes)

    @property
    def token_sliced(self) -> bool:
        """The dp_ep layout: experts span the TP axes too, so the MoE body
        slices its tokens over them (EP among the experts is DP)."""
        return bool(set(self.tp_axes) & set(self.ep_axes))

    def strategy(self) -> Strategy:
        """The cost-model ``Strategy`` this plan realises on its mesh (the
        inverse of ``make_plan``'s layouts; the reference's
        ``trace_contract.strategy_for_plan``)."""
        tp, ep = self.tp, self.ep
        n = self.mesh.size if self.enabled else 1
        if ep <= 1:                                   # pure_tp
            return Strategy(attn_tp=tp, attn_dp=max(1, n // tp), moe_tp=tp,
                            moe_ep=1, comm_algo=self.comm_algo)
        if self.token_sliced:                         # dp_ep (pure EP)
            return Strategy(attn_tp=tp, attn_dp=max(1, n // tp), moe_tp=1,
                            moe_ep=ep, comm_algo="unfused")
        return Strategy(attn_tp=tp, attn_dp=max(1, n // tp), moe_tp=tp,
                        moe_ep=ep, comm_algo=self.comm_algo)

    # ------------------------------------------------------------------
    def spec(self, logical_axes: tuple) -> tuple:
        """Mesh axes per dim (None, a name, or a tuple of names), trailing
        Nones dropped: the reference's ``PartitionSpec``."""
        if not self.enabled:
            return ()
        out, used = [], set()
        for ax in logical_axes:
            m = self.rules.get(ax)
            if m is None:
                out.append(None)
                continue
            m = tuple(x for x in (m if isinstance(m, tuple) else (m,))
                      if x not in used)
            used.update(m)
            out.append(m if len(m) > 1 else (m[0] if m else None))
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def spec_for_shape(self, shape: tuple, logical_axes: tuple) -> tuple:
        """Divisibility-aware ``spec``: a mesh axis that does not divide a
        dim is skipped and left for a later logical axis; the FSDP-style
        axes ("layers", "embed") claim what is left last."""
        if not self.enabled:
            return ()
        axes_seq = tuple(logical_axes) + (None,) * (len(shape)
                                                    - len(logical_axes))
        out: list = [None] * len(shape)
        used: set = set()

        def assign(i, ax, dim):
            rule = self.rules.get(ax) if ax is not None else None
            if rule is None:
                return
            cand = tuple(a for a in (rule if isinstance(rule, tuple)
                                     else (rule,)) if a not in used)
            if cand and dim % self.mesh.axis_size(cand) == 0:
                used.update(cand)
                out[i] = cand if len(cand) > 1 else cand[0]

        low = ("layers", "embed")
        for i, (dim, ax) in enumerate(zip(shape, axes_seq)):
            if ax not in low:
                assign(i, ax, dim)
        for i, (dim, ax) in enumerate(zip(shape, axes_seq)):
            if ax in low:
                assign(i, ax, dim)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def local_slices(self, shape: tuple, logical_axes: tuple) -> tuple:
        """This rank's block of a tensor laid out by ``spec``: one slice
        per dim (the reference's ``shard_map`` in_spec cut)."""
        sl = [slice(None)] * len(shape)
        for i, m in enumerate(self.spec(logical_axes)):
            if m is None:
                continue
            axes = m if isinstance(m, tuple) else (m,)
            n = self.mesh.axis_size(axes)
            if shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} ({logical_axes}"
                                 f") does not split over {axes} ({n} ranks)")
            blk = shape[i] // n
            j = self.mesh.axis_index(axes)
            sl[i] = slice(j * blk, (j + 1) * blk)
        return tuple(sl)

    def shard(self, t, logical_axes: tuple):
        """This rank's block of a whole tensor ``t`` (a view)."""
        if not self.enabled:
            return t
        return t[self.local_slices(tuple(t.shape), logical_axes)]

    def constrain(self, x, *logical_axes):
        """Identity: outside the MoE block every rank holds every tensor
        whole (replicated)."""
        return x


NULL_PLAN = ShardingPlan()


def make_plan(strategy: str | Strategy, mesh=None, comm_algo: str = "fused",
              *, kernels: Optional[KernelPolicy] = None,
              dispatch: str = "auto",
              ep_overlap: Optional[EpOverlap] = None) -> ShardingPlan:
    """The plan for a layout name (or an analyzer ``Strategy``) on
    ``mesh``.  With no mesh every layout is the single-device plan.
    ``kernels=None`` leaves every kernel off."""
    kernels = kernels if kernels is not None else NULL_POLICY
    if isinstance(strategy, Strategy):
        # analyzer output: moe_tp > 1 selects the hybrid layout
        strategy = "mixserve" if strategy.moe_tp > 1 else "dp_ep"
    if strategy not in _LAYOUTS:
        raise KeyError(f"unknown strategy {strategy!r}")
    if mesh is None:
        return ShardingPlan(comm_algo=comm_algo, kernels=kernels,
                            dispatch_mode=dispatch, ep_overlap=ep_overlap)
    names = mesh.axis_names
    pod = ("pod",) if "pod" in names else ()
    data, model = ("data",), ("model",)
    common = {"vocab": model, "heads": model, "ffn": model,
              "batch": pod + data, "kv_heads": model, "qk": model,
              "embed": None, "head_dim": model, "kv_head_dim": model,
              "seq": None, "layers": None, "kv_seq": model,
              "seq_resid": model}
    if strategy == "mixserve":
        rules = dict(common, expert=data, expert_ffn=model)
        ep_axes = data
    elif strategy == "pure_tp":
        rules = dict(common, expert=None, expert_ffn=model)
        ep_axes, comm_algo = (), "unfused"
    else:                              # pure_ep / dp_ep
        rules = dict(common, expert=data + model, expert_ffn=None)
        ep_axes, comm_algo = data + model, "unfused"
    return ShardingPlan(mesh=mesh, rules=rules, tp_axes=model,
                        ep_axes=ep_axes, dp_axes=pod + data,
                        comm_algo=comm_algo, kernels=kernels,
                        dispatch_mode=dispatch, ep_overlap=ep_overlap)


__all__ = ["ShardingPlan", "NULL_PLAN", "make_plan"]
