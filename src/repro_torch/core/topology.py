"""Cluster / interconnect topology description.

The paper's analyzer consumes "the configuration of network and hardware
resources ... computational power, as well as intra-node and inter-node
network bandwidth and topology" (§III-A).  ``ClusterSpec`` is that input.

Bandwidths are *per-link, per-direction* bytes/s.  ``intra_node_bw`` models
NVLink / HCCS / TPU ICI; ``inter_node_bw`` models IB / RoCE / TPU DCN.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A cluster of ``n_node`` nodes with ``n_proc`` accelerators each."""

    name: str
    n_node: int
    n_proc: int
    # per-chip peak compute (FLOP/s) at serving dtype
    peak_flops: float
    # per-chip HBM bandwidth (bytes/s)
    hbm_bw: float
    # per-chip HBM capacity (bytes)
    hbm_bytes: float
    # intra-node (NVLink / HCCS / ICI) bandwidth per chip, bytes/s
    intra_node_bw: float
    # inter-node (IB / RoCE / DCN) bandwidth per chip, bytes/s
    inter_node_bw: float
    # fixed per-collective latency (s) intra / inter node (alpha term)
    intra_node_latency: float = 5e-6
    inter_node_latency: float = 20e-6

    @property
    def n_devices(self) -> int:
        return self.n_node * self.n_proc

    def bw(self, inter_node: bool) -> float:
        return self.inter_node_bw if inter_node else self.intra_node_bw

    def latency(self, inter_node: bool) -> float:
        return self.inter_node_latency if inter_node else self.intra_node_latency


def _gbps(x: float) -> float:
    """Gigabits/s -> bytes/s."""
    return x * 1e9 / 8


def _gBps(x: float) -> float:
    """Gigabytes/s -> bytes/s."""
    return x * 1e9


# ---------------------------------------------------------------------------
# The paper's two evaluation clusters (§IV-A).
# ---------------------------------------------------------------------------

# 2 nodes x 8 Nvidia H20 (96 GB).  NVLink 4.0 "up to 900 GB/s" aggregate;
# InfiniBand 400 Gbps per node.
H20_CLUSTER = ClusterSpec(
    name="h20x16",
    n_node=2,
    n_proc=8,
    peak_flops=148e12,          # H20 bf16 dense
    hbm_bw=4.0e12,              # 4.0 TB/s
    hbm_bytes=96e9,
    intra_node_bw=_gBps(450.0),  # 900 GB/s bidirectional -> 450 per direction
    inter_node_bw=_gbps(400.0) / 8,  # 400 Gb/s NIC shared by 8 GPUs
)

# 4 nodes x 8 Ascend 910B (64 GB).  HCCS "up to 480 Gbps" per link; RoCE
# "up to 200 Gbps" per node.
ASCEND_910B_CLUSTER = ClusterSpec(
    name="910bx32",
    n_node=4,
    n_proc=8,
    peak_flops=376e12 / 2,      # 910B fp16 ~ 376 TFLOPS dense /2 derate
    hbm_bw=1.6e12,
    hbm_bytes=64e9,
    intra_node_bw=_gbps(480.0),
    inter_node_bw=_gbps(200.0) / 8,
)

# ---------------------------------------------------------------------------
# The TPU target for this reproduction: v5e pods.
# "model" axis rides ICI inside a pod slice; "pod" axis rides DCN.
# Hardware constants fixed by the task: 197 TFLOP/s bf16, 819 GB/s HBM,
# ~50 GB/s per ICI link.
# ---------------------------------------------------------------------------

TPU_V5E_POD = ClusterSpec(
    name="v5e-pod-256",
    n_node=16,                  # "data" axis (EP/DP groups)
    n_proc=16,                  # "model" axis (TP groups)
    peak_flops=197e12,
    hbm_bw=819e9,
    hbm_bytes=16e9,
    intra_node_bw=_gBps(50.0),  # ICI per link
    # within a single pod both axes are ICI; the 2x asymmetry below reflects
    # fewer hops / contention on the contiguous "model" axis vs the "data"
    # axis of a 16x16 torus.
    inter_node_bw=_gBps(25.0),
)

TPU_V5E_MULTIPOD = dataclasses.replace(
    TPU_V5E_POD,
    name="v5e-2pods-512",
    n_node=32,                  # 2 pods x 16 "data" rows
    inter_node_bw=_gBps(6.25),  # DCN between pods, far below ICI
)

# ---------------------------------------------------------------------------
# The port's target: one NVIDIA H100 SXM (80 GB).  Data-sheet values: 989
# TFLOP/s bf16 dense, 3.35 TB/s HBM3; NVLink 4 is 900 GB/s bidirectional,
# 450 GB/s per direction.  One node of one card, so the inter-node figure
# (a 400 Gb/s NIC) never prices a collective.
# ---------------------------------------------------------------------------

H100_X1 = ClusterSpec(
    name="h100x1",
    n_node=1,
    n_proc=1,
    peak_flops=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    intra_node_bw=_gBps(450.0),
    inter_node_bw=_gbps(400.0),
)

# Four H100s as MixServe lays them out: 2 nodes x 2 cards, the "model" (TP)
# axis on NVLink inside a node, the "data" (EP) axis across nodes, each
# node's 400 Gb/s NIC shared by its two cards.  The per-card figures are
# h100x1's.  This prices a mesh of 4 ranks; on one card (ranks sharing it)
# or on one 4-card host it has not been checked against a measurement.
H100_2X2 = dataclasses.replace(
    H100_X1,
    name="h100-2x2",
    n_node=2,
    n_proc=2,
    inter_node_bw=_gbps(400.0) / 2,
)

CLUSTERS = {
    c.name: c for c in (H20_CLUSTER, ASCEND_910B_CLUSTER, TPU_V5E_POD,
                        TPU_V5E_MULTIPOD, H100_X1, H100_2X2)
}

H100_NODE = 8     # cards a node of the mesh-sized fallback cluster


def h100_cluster(n_devices: int) -> ClusterSpec:
    """``h100-<N>``: N H100s as N / 8 nodes of 8 cards, NVLink inside a
    node and one 400 Gb/s NIC a card across nodes; the per-card figures
    are h100x1's.  The cluster a mesh of N ranks is priced on when none
    is named (N a multiple of 8).  Like h100-2x2 it has not been checked
    against a measurement."""
    if n_devices < H100_NODE or n_devices % H100_NODE:
        raise ValueError(f"h100-<N> needs N a multiple of {H100_NODE}, "
                         f"got {n_devices}")
    return dataclasses.replace(H100_X1, name=f"h100-{n_devices}",
                               n_node=n_devices // H100_NODE,
                               n_proc=H100_NODE)


def is_pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


def pow2_divisors(n: int) -> list[int]:
    """All powers of two d with d | n (the grammar's ``degree -> 2^k``)."""
    out = []
    d = 1
    while d <= n:
        if n % d == 0:
            out.append(d)
        d *= 2
    return out


def flops_per_s_total(spec: ClusterSpec) -> float:
    return spec.peak_flops * spec.n_devices


def bisection_inter_node_bw(spec: ClusterSpec) -> float:
    return spec.inter_node_bw * spec.n_devices


__all__ = [
    "ClusterSpec",
    "H20_CLUSTER",
    "ASCEND_910B_CLUSTER",
    "TPU_V5E_POD",
    "TPU_V5E_MULTIPOD",
    "H100_X1",
    "H100_2X2",
    "CLUSTERS",
    "h100_cluster",
    "is_pow2",
    "pow2_divisors",
]
