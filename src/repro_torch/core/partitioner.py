"""Hybrid TP-EP partitioner (paper §III-C): logical axes -> mesh axes.

The plan maps the *logical* axes the models declare (``expert``,
``expert_ffn``, ``heads``, ``vocab``, ``batch``, ``seq_resid``, ...) onto
the axes of a ``launch.mesh.Mesh`` for one of four layouts, exactly as the
reference's rules do:

  mixserve   MoE: experts over "data" (EP), the expert FFN over "model"
             (TP); batch over pod + data
  pure_tp    no EP: every rank holds all experts, FFN sharded over "model"
  pure_ep /  experts over data + model jointly (EP = every rank), tokens
  dp_ep      sliced over "model" inside the MoE block
             (``dispatch_mode``/``kernels``/``ep_overlap`` ride along)

and in every layout the attention half: heads, the dense FFN and the vocab
over "model" (TP), the batch over pod + data (DP), and with ``sp`` the
residual stream's sequence over "model" (``seq_resid``, Megatron-SP).

The reference is single-controller GSPMD and hands these rules to XLA as
sharding hints.  The port runs one process per rank and realises the same
layout with explicit collectives, through the few helpers the layers call:

  keep_hook(cfg)     each rank's block of every weight: ``heads`` /
                     ``kv_heads`` (when ``heads_sharded``), ``vocab``,
                     ``ffn``, ``expert``, ``expert_ffn``; every other axis
                     (``qk``, ``head_dim``, ``embed``, ...) stays whole
  heads_sharded(cfg) the TP size divides the query heads and (GQA) the kv
                     heads (whisper: its encoder's too; RWKV6: its wkv
                     heads); otherwise that model's attention runs
                     replicated, which gives the same numbers (the
                     reference would split ``head_dim`` instead)
  for_batch(b) / rows(b)
                     a step's batch over the batch axes when they divide
                     it, else replicated (a legacy batch-1 prefill), and
                     this rank's block of the rows
  seq_sharded(s)     the residual stream of an s-row step is cut along seq
                     over the TP axes (``sp`` on and the TP size divides s)
  gather_seq / reduce_out / cut_seq
                     a sub-layer's entry (all_gather along seq), its
                     row-parallel exit (psum_scatter along seq, or psum),
                     and the cut of a TP-replicated output to this rank's
                     seq block (no collective)

With no mesh the plan is the single-device one (``enabled`` False) and
every helper is the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import collectives as C
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

    # ------------------------------------------------------------------
    # the attention half of the layout (what the layers call)
    # ------------------------------------------------------------------
    def heads_sharded(self, cfg) -> bool:
        """Whether ``cfg``'s heads run 1/tp a rank: the TP size divides
        ``n_heads`` and, for GQA, ``n_kv_heads`` (GQA groups stay whole),
        and whisper's encoder heads too; RWKV6 (``n_heads`` 0) counts its
        wkv heads, ``d_model / 64``.  Otherwise they run replicated on
        every TP rank (the reference's ``spec_for_shape`` leaves an axis
        that does not divide its dim unsharded)."""
        tp = self.tp
        if tp <= 1:
            return False
        if cfg.family == "ssm":
            return rwkv_heads(cfg) % tp == 0
        enc = cfg.encoder
        return cfg.n_heads % tp == 0 and (cfg.attention == "mla"
                                          or cfg.n_kv_heads % tp == 0) \
            and (enc is None or enc.n_heads % tp == 0)

    def batch_sharded(self, b: int) -> bool:
        """Whether a step of ``b`` rows splits over the batch axes: they
        divide it (a legacy batch-1 prefill does not, and then runs whole
        on every batch rank, as ``spec_for_shape`` replicates it)."""
        return self.dp > 1 and b % self.dp == 0

    def for_batch(self, b: int) -> "ShardingPlan":
        """The plan of a step of ``b`` rows: this one, or, when the batch
        axes do not divide ``b``, one whose batch is replicated (no batch
        rule, no batch axes: rows and logits stay whole)."""
        if self.dp <= 1 or self.batch_sharded(b):
            return self
        return dataclasses.replace(self, dp_axes=(),
                                   rules=dict(self.rules, batch=None))

    def rows(self, b: int) -> slice:
        """This rank's block of ``b`` batch rows (all of them when the
        batch does not split)."""
        if not self.batch_sharded(b):
            return slice(0, b)
        n = b // self.dp
        j = self.mesh.axis_index(self.dp_axes)
        return slice(j * n, (j + 1) * n)

    def seq_sharded(self, s: int) -> bool:
        """Whether a step of ``s`` rows carries its residual stream cut
        along seq over the TP axes (``seq_resid``): ``sp`` is on and the
        TP size divides s (a width-1 decode step is never cut)."""
        return (self.rules.get("seq_resid") is not None and self.tp > 1
                and s % self.tp == 0)

    def keep_hook(self, cfg):
        """The ``models.param.init_tree`` keep-hook: each rank keeps its
        block of the axes the port shards (``vocab``, ``ffn``, ``expert``,
        ``expert_ffn``, and ``heads`` / ``kv_heads`` when
        ``heads_sharded``); every other axis stays whole on every rank.
        None with no mesh."""
        if not self.enabled:
            return None
        cut = {"vocab", "ffn", "expert", "expert_ffn"}
        if self.heads_sharded(cfg):
            cut |= {"heads", "kv_heads"}

        def keep(path, p):
            axes = tuple(a if a in cut else None for a in p.axes)
            if all(self.rules.get(a) is None for a in axes if a):
                return None
            return self.local_slices(p.shape, axes)
        return keep

    def gather_seq(self, x, seq_sharded: bool):
        """Whole rows of a residual-layout ``x``: with the stream cut,
        (b, s/tp, ...) -> (b, s, ...) by an all_gather over the TP axes."""
        if not seq_sharded:
            return x
        return C.all_gather(x, self.mesh, self.tp_axes, axis=1)

    def reduce_out(self, y, seq_sharded: bool):
        """A row-parallel output, (b, s, h) partial over the TP axes, into
        the residual layout: the sum cut along seq (psum_scatter) when the
        stream is cut, else the whole sum (psum)."""
        if seq_sharded:
            return C.psum_scatter(y, self.mesh, self.tp_axes,
                                  scatter_dimension=1)
        if self.tp > 1:
            return C.psum(y, self.mesh, self.tp_axes)
        return y

    def cut_seq(self, y, seq_sharded: bool):
        """A (b, s, ...) output replicated over the TP axes into the
        residual layout: this rank's seq block, no collective."""
        if not seq_sharded:
            return y
        n = y.shape[1] // self.tp
        j = C.axis_index(self.mesh, self.tp_axes)
        return y[:, j * n:(j + 1) * n]


NULL_PLAN = ShardingPlan()


def rwkv_heads(cfg) -> int:
    """RWKV6's wkv heads: head size 64."""
    return max(1, cfg.d_model // 64)


def make_plan(strategy: str | Strategy, mesh=None, comm_algo: str = "fused",
              *, kernels: Optional[KernelPolicy] = None,
              sp: bool = True, dispatch: str = "auto",
              ep_overlap: Optional[EpOverlap] = None) -> ShardingPlan:
    """The plan for a layout name (or an analyzer ``Strategy``) on
    ``mesh``.  With no mesh every layout is the single-device plan.
    ``kernels=None`` leaves every kernel off.  ``sp=False`` turns off the
    Megatron-SP cut of the residual stream (``seq_resid`` -> None), as the
    reference's switch does."""
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
              "seq_resid": model if sp else None}
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


__all__ = ["ShardingPlan", "NULL_PLAN", "make_plan", "rwkv_heads"]
