"""The plan the layers consult — single-device part only.

The reference maps logical tensor axes onto a JAX mesh (hybrid TP-EP,
paper §III-C).  The port serves on one card, so its ``ShardingPlan`` carries
only what the layers read on that path — the ``KernelPolicy``, the MoE
``dispatch_mode`` and the EP-overlap schedule — with ``enabled`` False and
an identity ``constrain``.  A mesh (multi-device MoE) is ROADMAP A8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.cost_model import EpOverlap, Strategy
from repro_torch.kernels.policy import NULL_POLICY, KernelPolicy

_LAYOUTS = ("mixserve", "pure_tp", "pure_ep", "dp_ep")


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Plan for one device: no mesh, so no constraints."""

    comm_algo: str = "fused"   # fused | sync | unfused (priced, not run)
    kernels: KernelPolicy = NULL_POLICY
    # "auto" (-> dropless for inference) | "dropless" | "capacity"
    dispatch_mode: str = "auto"
    ep_overlap: Optional[EpOverlap] = None

    @property
    def enabled(self) -> bool:
        return False

    def constrain(self, x, *logical_axes):
        """Identity: one device holds every tensor whole."""
        return x


NULL_PLAN = ShardingPlan()


def make_plan(strategy: str | Strategy, mesh=None, comm_algo: str = "fused",
              *, kernels: Optional[KernelPolicy] = None,
              dispatch: str = "auto",
              ep_overlap: Optional[EpOverlap] = None) -> ShardingPlan:
    """The plan for a resolved layout name on one device.

    ``strategy`` is a layout name the resolver emits (or an analyzer
    ``Strategy``); with no mesh every layout runs as the single-device
    path.  ``kernels=None`` leaves every kernel off."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device plans are not ported yet (ROADMAP A8)")
    if isinstance(strategy, str) and strategy not in _LAYOUTS:
        raise KeyError(f"unknown strategy {strategy!r}")
    return ShardingPlan(comm_algo=comm_algo,
                        kernels=kernels if kernels is not None
                        else NULL_POLICY,
                        dispatch_mode=dispatch, ep_overlap=ep_overlap)


__all__ = ["ShardingPlan", "NULL_PLAN", "make_plan"]
