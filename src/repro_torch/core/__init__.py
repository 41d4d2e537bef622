"""SLOs-Serve core (framework-free): multi-SLO planning and admission.

Verbatim copies of ``repro.core`` modules with their imports rewritten.
"""
from repro_torch.core.batch import Batch, BatchEntry
from repro_torch.core.perf_model import (PerfModel, HardwareSpec, TPU_V5E,
                                         A100_40G, H100_80G, opt_perf_model)
from repro_torch.core.request import Request, RequestState, simple_request
from repro_torch.core.scheduler import (SLOsServeScheduler, SchedulerConfig,
                                        PlanResult)
from repro_torch.core.simulator import ClusterSim, SimConfig, find_capacity
from repro_torch.core.slo import (StageKind, StageSLO, StageSpec,
                                  prefill_slo, decode_slo)
from repro_torch.core.trace import (SIX_SCENARIO_MIX, TraceEntry,
                                    generate_trace, load_trace, save_trace)

__all__ = [
    "Batch", "BatchEntry", "PerfModel", "HardwareSpec", "TPU_V5E", "A100_40G",
    "H100_80G", "opt_perf_model", "Request", "RequestState", "simple_request",
    "SLOsServeScheduler", "SchedulerConfig", "PlanResult", "ClusterSim",
    "SimConfig", "find_capacity", "StageKind", "StageSLO", "StageSpec",
    "prefill_slo", "decode_slo", "SIX_SCENARIO_MIX", "TraceEntry",
    "generate_trace", "load_trace", "save_trace",
]
