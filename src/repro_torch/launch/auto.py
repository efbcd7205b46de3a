"""Automatic strategy -> plan wiring (the full MixServe loop).

``auto_plan`` runs the offline analyzer for the target mesh's cluster spec,
takes the best strategy, and maps it onto a ShardingPlan — the
"--strategy auto" path of the launchers.  This is the piece that makes the
system *automatic* end to end: model config in, mesh in, sharded program
out.

Planning needs no process group: a ``launch.mesh.Mesh(..., connect=False)``
that only describes a layout (16x16, 2x16x16) plans in one process.

The serving-side mirror of this loop is ``repro_torch.serving.api.ServeSpec``,
which resolves the SAME analyzer choice plus the online knobs (chunk, token
budget, kernels, dispatch) through ``core.resolve`` — the strategy -> layout
mapping is shared (``core.resolve.plan_name_for``).
"""

from __future__ import annotations

from typing import Union

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import analyzer
from repro_torch.core.partitioner import make_plan
from repro_torch.core.resolve import plan_name_for, resolve_cluster
from repro_torch.core.topology import ClusterSpec


def cluster_for_mesh(mesh, cluster: Union[str, ClusterSpec, None] = None
                     ) -> ClusterSpec:
    """ClusterSpec for a mesh: an explicit spec/name wins (validated
    against ``mesh.size``); None falls back to the H100 cluster of the
    mesh's size (``core.resolve.resolve_cluster``: ``h100x1``,
    ``h100-2x2``, or ``h100-<N>`` of N / 8 nodes of 8 cards)."""
    spec, _src = resolve_cluster(cluster, mesh=mesh)
    return spec


def auto_plan(cfg: ModelConfig, mesh, shape: InputShape, *,
              fsdp: bool = False, sp: bool = True,
              objective: str = "balanced",
              cluster: Union[str, ClusterSpec, None] = None) -> tuple:
    """(plan, report): analyzer-selected ShardingPlan for (model, mesh, shape).

    The analyzer enumerates the §III-B1 grammar on the mesh's cluster spec
    (explicit ``cluster`` or the mesh-sized fallback); the winning strategy
    maps to the hybrid ("mixserve") layout when its MoE block uses TP>1,
    else to pure-EP — with a divisibility guard: pure-EP needs
    n_experts % n_devices == 0, otherwise the hybrid layout is the only
    implementable choice on this mesh (the deepseek-v2 case: 160 experts
    on 256 ranks).
    """
    cluster = cluster_for_mesh(mesh, cluster)
    if shape.kind in ("train", "prefill"):
        batch, l_in, l_out = shape.global_batch, shape.seq_len, 1
    else:
        batch, l_in, l_out = shape.global_batch, shape.seq_len, 256
    rep = analyzer.select(cfg, cluster, batch=batch, l_in=min(l_in, 8192),
                          l_out=l_out, objective=objective)
    best = rep.best.strategy

    name = plan_name_for(cfg, best, mesh.size)
    plan = make_plan(name, mesh, comm_algo=best.comm_algo, fsdp=fsdp, sp=sp)
    return plan, rep


__all__ = ["auto_plan", "cluster_for_mesh"]
