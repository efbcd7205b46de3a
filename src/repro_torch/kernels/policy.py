"""KernelPolicy — which hand-written kernels the serving hot path uses.

The policy rides on the ``ShardingPlan`` (core.partitioner) so it reaches
every layer the plan reaches: ``models.layers.gqa_attention``
(``flash_chunk``: the paged ragged attention kernel) and
``models.moe.moe_local`` (``topk_gate``, ``moe_gemm`` = the dropless grouped
GEMM).

``KernelPolicy.auto(device)`` turns the ported kernels on exactly when the
engine's device is CUDA; on the CPU every stage runs its plain PyTorch body.
``fused_permute`` and ``flash_decode`` have no Hopper kernel yet: asking for
either on CUDA raises ``NotImplementedError`` instead of running a stand-in.
"""

from __future__ import annotations

import dataclasses

# kernels with a Hopper port, and the ROADMAP item of each one still missing
PORTED = ("flash_chunk", "topk_gate", "moe_gemm")
NOT_PORTED = {"fused_permute": "ROADMAP B5/B6 (permute_tokens, "
                               "unpermute_tokens)",
              "flash_decode": "ROADMAP B2 (flash_chunk / flash_decode)"}


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Per-kernel opt-in switches for the serving hot path."""

    flash_decode: bool = False    # single-token decode attention
    flash_chunk: bool = False     # ragged mixed-chunk (paged) attention
    topk_gate: bool = False       # fused softmax+top-k router gate
    moe_gemm: bool = False        # dropless grouped expert GEMM
    fused_permute: bool = False   # fused token permute / unpermute+combine

    @property
    def any_enabled(self) -> bool:
        return (self.flash_decode or self.flash_chunk or self.topk_gate
                or self.moe_gemm or self.fused_permute)

    @classmethod
    def all_on(cls) -> "KernelPolicy":
        """Every kernel that has a Hopper port."""
        return cls(**{f: True for f in PORTED})

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

    def check_ported(self, device) -> None:
        """Raise for a switch whose kernel has no Hopper port on CUDA."""
        import torch
        if torch.device(device).type != "cuda":
            return
        for name, item in NOT_PORTED.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"kernel {name!r} has no Hopper port yet: {item}")

    def describe(self) -> str:
        """Compact provenance-report form: all-on / off / the enabled set."""
        on = [f.name for f in dataclasses.fields(self)
              if getattr(self, f.name)]
        if len(on) == len(dataclasses.fields(self)):
            return "all-on"
        return "+".join(on) if on else "off"


NULL_POLICY = KernelPolicy()

__all__ = ["KernelPolicy", "NULL_POLICY", "PORTED", "NOT_PORTED"]
