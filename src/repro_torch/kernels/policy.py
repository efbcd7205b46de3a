"""KernelPolicy — which hand-written kernels the serving hot path uses.

The policy rides on the ``ShardingPlan`` (core.partitioner) so it reaches
every layer the plan reaches: ``models.layers`` attention (``flash_chunk``:
the paged kernel for GQA, the dense kernel for MLA's gathered latent view;
``flash_decode``: the dense kernel at one query row) and
``models.moe.moe_local`` (``topk_gate``; ``moe_gemm`` = both expert GEMMs,
the dropless ``grouped_gemm`` and the capacity-mode ``moe_gemm``, as in the
reference; ``fused_permute`` = the permute / unpermute kernels).

``KernelPolicy.auto(device)`` turns every kernel on exactly when the
engine's device is CUDA; on the CPU every stage runs its plain PyTorch body.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Per-kernel opt-in switches for the serving hot path."""

    flash_decode: bool = False    # single-token decode attention
    flash_chunk: bool = False     # ragged mixed-chunk attention
    topk_gate: bool = False       # fused softmax+top-k router gate
    moe_gemm: bool = False        # expert GEMMs: grouped (dropless) + capacity
    fused_permute: bool = False   # fused token permute / unpermute+combine

    @property
    def any_enabled(self) -> bool:
        return (self.flash_decode or self.flash_chunk or self.topk_gate
                or self.moe_gemm or self.fused_permute)

    @classmethod
    def all_on(cls) -> "KernelPolicy":
        return cls(flash_decode=True, flash_chunk=True, topk_gate=True,
                   moe_gemm=True, fused_permute=True)

    @classmethod
    def off(cls) -> "KernelPolicy":
        return cls()

    @classmethod
    def auto(cls, device="cuda") -> "KernelPolicy":
        """On exactly when ``device`` is a CUDA device."""
        import torch
        return cls.all_on() if torch.device(device).type == "cuda" \
            else cls.off()

    @classmethod
    def parse(cls, value, device="cuda") -> "KernelPolicy":
        """The ServeSpec surface: "auto" | "on" | "off" (or an already-built
        policy, passed through) -> a concrete KernelPolicy."""
        if isinstance(value, cls):
            return value
        if value == "auto":
            return cls.auto(device)
        if value in ("on", "all_on"):
            return cls.all_on()
        if value in ("off", "none"):
            return cls.off()
        raise ValueError(
            f"kernel policy must be 'auto'/'on'/'off' or a KernelPolicy, "
            f"got {value!r}")

    def describe(self) -> str:
        """Compact provenance-report form: all-on / off / the enabled set."""
        on = [f.name for f in dataclasses.fields(self)
              if getattr(self, f.name)]
        if len(on) == len(dataclasses.fields(self)):
            return "all-on"
        return "+".join(on) if on else "off"


NULL_POLICY = KernelPolicy()

__all__ = ["KernelPolicy", "NULL_POLICY"]
