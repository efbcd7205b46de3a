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
  gather_seq / reduce_out / cut_seq / copy_in
                     a sub-layer's entry (all_gather along seq, or, with
                     the stream whole, the identity whose backward psums
                     the gradient), its row-parallel exit (psum_scatter
                     along seq, or psum), and the cut of a TP-replicated
                     output to this rank's seq block (no collective)
  store_spec / unshard
                     the mesh axes each dim of a leaf is stored cut over
                     (with ``fsdp`` the ``embed`` axis over "data" too,
                     ZeRO-3 style; ``training.tree.store_specs`` gives
                     every leaf of a state tree its own), and the gather
                     of a layer's FSDP leaves on use
  grad_sum_axes      the axes a leaf's gradient is summed over after the
                     backward (``core.collectives``' convention; the leaf's
                     declaration says where TP ranks hold shares)

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
    def fsdp(self) -> bool:
        """Parameters (and their optimizer moments) stored with the
        ``embed`` axis cut over "data", gathered on use (training only)."""
        return self.enabled and self.rules.get("embed") is not None

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
        return self.block(shape, _per_dim(self.spec(logical_axes),
                                          len(shape)))

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

    def _cut_axes(self, cfg) -> set:
        cut = {"vocab", "ffn", "expert", "expert_ffn"}
        if self.heads_sharded(cfg):
            cut |= {"heads", "kv_heads"}
        if self.fsdp:
            cut |= {"embed"}
        return cut

    def store_spec(self, cfg, p) -> tuple:
        """The mesh axes each dim of leaf ``p`` (a ``models.param.P``) is
        stored cut over: one entry a dim, None or a tuple of axis names.
        The axes the port shards (``keep_hook``); with ``fsdp`` also
        ``embed`` over "data" at the lowest priority, where the dim splits
        and no other axis of the leaf took "data" (``spec_for_shape``)."""
        cut = self._cut_axes(cfg)
        axes = tuple(a if a in cut else None for a in p.axes)
        spec = self.spec_for_shape(p.shape, axes) if self.fsdp \
            else self.spec(axes)
        return _per_dim(spec, len(p.shape))

    def block(self, shape: tuple, spec: tuple) -> tuple:
        """This rank's slices of a whole tensor of ``shape`` stored by
        ``spec`` (``store_spec``)."""
        sl = []
        for i, m in enumerate(spec):
            if m is None:
                sl.append(slice(None))
                continue
            n = self.mesh.axis_size(m)
            if shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"over {m} ({n} ranks)")
            blk, j = shape[i] // n, self.mesh.axis_index(m)
            sl.append(slice(j * blk, (j + 1) * blk))
        return tuple(sl)

    def keep_hook(self, cfg):
        """The ``models.param.init_tree`` keep-hook: each rank keeps its
        block of the axes the port shards (``vocab``, ``ffn``, ``expert``,
        ``expert_ffn``, and ``heads`` / ``kv_heads`` when
        ``heads_sharded``; with ``fsdp`` also ``embed``: ``store_spec``);
        every other axis stays whole on every rank.  None with no mesh."""
        if not self.enabled:
            return None

        def keep(path, p):
            spec = self.store_spec(cfg, p)
            if all(m is None for m in spec):
                return None
            return self.block(p.shape, spec)
        return keep

    def unshard(self, cfg, p, spec):
        """Layer weights ``p`` with each FSDP-cut leaf gathered whole along
        its ``embed`` dim over the data axes (``spec``: the matching tree
        of ``models.param.P``).  The backward reduce-scatters each
        gathered leaf's gradient: the data ranks' sum of their rows'
        shares.  Without ``fsdp``, ``p`` itself."""
        if not self.fsdp:
            return p
        if isinstance(spec, dict):
            return {k: self.unshard(cfg, v, spec[k]) for k, v in p.items()}
        if isinstance(spec, list):
            return [self.unshard(cfg, v, sp) for v, sp in zip(p, spec)]
        for i, (a, m) in enumerate(zip(spec.axes,
                                       self.store_spec(cfg, spec))):
            if a == "embed" and m is not None:
                return C.all_gather(p, self.mesh, m, axis=i)
        return p

    def gather_seq(self, x, seq_sharded: bool, *, parallel: bool = True):
        """A sub-layer's entry: whole rows of a residual-layout ``x``.
        With the stream cut, (b, s/tp, ...) -> (b, s, ...) by an
        all_gather over the TP axes.  ``parallel``: the sub-layer's
        products are TP-parallel (column-parallel after the entry), so
        each rank's gradient of the gathered rows is a share: the
        all_gather's backward reduce-scatters it, and with the stream
        whole the entry is ``copy_in``.  Otherwise (replicated heads) every
        rank's gradient is whole: the gather's backward takes its block
        and a whole stream needs nothing."""
        if seq_sharded:
            return C.all_gather(x, self.mesh, self.tp_axes, axis=1,
                                grad="sum" if parallel else "whole")
        return self.copy_in(x) if parallel else x

    def copy_in(self, x):
        """``x``, whole on every TP rank, entering TP-parallel products:
        the identity, whose backward psums the gradient over the TP axes
        (``collectives.copy_in``)."""
        if self.tp > 1:
            return C.copy_in(x, self.mesh, self.tp_axes)
        return x

    def reduce_out(self, y, seq_sharded: bool):
        """A row-parallel output, (b, s, h) partial over the TP axes, into
        the residual layout: the sum cut along seq (psum_scatter) when the
        stream is cut, else the whole sum (psum, whose gradient every
        rank holds whole)."""
        if seq_sharded:
            return C.psum_scatter(y, self.mesh, self.tp_axes,
                                  scatter_dimension=1)
        if self.tp > 1:
            return C.psum(y, self.mesh, self.tp_axes)
        return y

    def cut_seq(self, y, seq_sharded: bool, *, grad: str = "whole"):
        """A (b, s, ...) output replicated over the TP axes into the
        residual layout: this rank's seq block, no collective.  Its
        backward (``grad="whole"``) all_gathers the blocks' gradients, so
        ``y``'s is whole on every rank; ``grad="sum"`` leaves each rank
        its block's share (zero elsewhere), for a ``y`` whose gradient is
        held in shares."""
        if not seq_sharded:
            return y
        if grad == "whole":
            return C.scatter(y, self.mesh, self.tp_axes, axis=1)
        n = y.shape[1] // self.tp
        j = C.axis_index(self.mesh, self.tp_axes)
        return y[:, j * n:(j + 1) * n]

    def grad_sum_axes(self, cfg, p, spec: tuple, seq_sharded: bool) \
            -> tuple:
        """The mesh axes the gradient of a leaf declared by ``p`` (a
        ``models.param.P``) is psummed over after the backward
        (``core.collectives``' convention): the batch axes it is not
        stored cut over (its rows' shares; an FSDP leaf's data axes are
        summed by its gather's reduce-scatter), and the TP axes where each
        TP rank holds only a share of its gradient (``p.tp_share``).
        ``spec``: its ``store_spec``."""
        if not self.enabled:
            return ()
        cut = {a for m in spec if m is not None for a in m}
        axes = [a for a in self.dp_axes if a not in cut]
        share = p.tp_share == "tp" \
            or (p.tp_share == "heads" and self.heads_sharded(cfg)) \
            or (p.tp_share == "seq" and seq_sharded)
        if self.tp > 1 and share:
            axes += [a for a in self.tp_axes if a not in cut]
        return tuple(a for a in self.mesh.axis_names if a in axes)


NULL_PLAN = ShardingPlan()


def _per_dim(spec: tuple, ndim: int) -> tuple:
    """A spec (trailing Nones dropped, single axes bare) as one entry a
    dim: None or a tuple of mesh axis names."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(m if m is None or isinstance(m, tuple) else (m,)
                 for m in spec)


def rwkv_heads(cfg) -> int:
    """RWKV6's wkv heads: head size 64."""
    return max(1, cfg.d_model // 64)


def make_plan(strategy: str | Strategy, mesh=None, comm_algo: str = "fused",
              *, kernels: Optional[KernelPolicy] = None,
              fsdp: bool = False, sp: bool = True, dispatch: str = "auto",
              ep_overlap: Optional[EpOverlap] = None) -> ShardingPlan:
    """The plan for a layout name (or an analyzer ``Strategy``) on
    ``mesh``.  With no mesh every layout is the single-device plan.
    ``kernels=None`` leaves every kernel off.  ``sp=False`` turns off the
    Megatron-SP cut of the residual stream (``seq_resid`` -> None), as the
    reference's switch does.  ``fsdp=True`` (training): parameters and
    their optimizer moments store the ``embed`` axis cut over "data",
    ZeRO-3 style, at the lowest priority (an expert axis on the same leaf
    keeps "data"), gathered on use (``unshard``)."""
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
              "embed": data if fsdp else None, "head_dim": model,
              "kv_head_dim": model,
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
