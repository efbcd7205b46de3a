"""The serving stack: one resolvable API.

``ServeSpec`` is the declarative surface — every knob defaults to "auto"
and is resolved by the offline analyzer / cost model; ``LLM`` is the
facade that owns Engine + Scheduler construction, on a CUDA device unless
the caller passes ``device="cpu"``.
"""

from repro_torch.core.resolve import OverloadPolicy
from repro_torch.serving.api import AUTO, LLM, ResolvedServeSpec, ServeSpec
from repro_torch.serving.engine import (Engine, PromptTooLongError, Request,
                                        RequestState, unified_supported)
from repro_torch.serving.faults import Fault, FaultInjector, InjectedFault
from repro_torch.serving.scheduler import (Scheduler, ServeMetrics,
                                           StalledEngineError,
                                           mixed_workload,
                                           synthetic_workload,
                                           tiered_workload)

__all__ = ["AUTO", "LLM", "ServeSpec", "ResolvedServeSpec", "OverloadPolicy",
           "Engine", "Request", "RequestState", "PromptTooLongError",
           "unified_supported", "Fault", "FaultInjector", "InjectedFault",
           "Scheduler", "ServeMetrics", "StalledEngineError",
           "mixed_workload", "synthetic_workload", "tiered_workload"]
