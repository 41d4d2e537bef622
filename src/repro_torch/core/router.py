"""Multi-replica serving with SLO-driven request routing (paper §4.2).

A centralized controller holds one SLOs-Serve scheduler per replica and
*virtualizes* replica execution through the shared performance model: upon
arrival the target replica's scheduler decides SLO attainability; requests
it declines are routed sequentially to the next replica, and after
``max_route_hops`` a backup policy fires (best-effort tier or decline).

The event-level mechanics live in ``simulator.ClusterSim``; the REAL
token-by-token counterpart is ``serving/cluster.ClusterFrontend``.  Both
share the ``RoutingPolicy`` type defined here, and this module provides
the factories used by benchmarks/examples for either path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.perf_model import PerfModel
from repro_torch.core.scheduler import SLOsServeScheduler, SchedulerConfig
from repro_torch.core.simulator import ClusterSim, SimConfig


@dataclasses.dataclass
class RoutingPolicy:
    max_hops: int = 3
    routing_delay: float = 0.002
    backup: str = "best_effort"     # or "decline"
    # Prefix-affinity hint (real cluster only): probe the replica whose
    # paged pool holds the best cached-prefix match for the request's
    # prompt FIRST, before the round-robin / SLO-verdict hop sequence —
    # PolyServe-style locality-aware placement.  The event simulator has
    # no token-level cache and ignores the flag.
    prefix_affinity: bool = True
    # Proactive placement (real cluster, host spill tier on): every
    # ``placement_interval`` cluster steps, the top-``placement_top_k``
    # chains by aggregated probe/hit popularity (at least
    # ``placement_min_hits`` hits) are pushed onto under-loaded replicas'
    # host tiers, upgrading prefix affinity from organic (hits follow
    # wherever requests landed) to planned (hot system prompts are
    # replicated ahead of the load).  0 interval disables the pass.
    placement_interval: int = 16
    placement_top_k: int = 4
    placement_min_hits: int = 2


def make_slos_serve_cluster(n_replicas: int, perf: PerfModel,
                            spec_alpha: Optional[float] = None,
                            sim_cfg: SimConfig = None,
                            sched_cfg: SchedulerConfig = None,
                            policy: RoutingPolicy = None) -> ClusterSim:
    """Build an SLOs-Serve cluster: one virtualized scheduler per replica
    behind the central controller (Fig. 7)."""
    policy = policy or RoutingPolicy()
    sim_cfg = sim_cfg or SimConfig()
    sim_cfg = dataclasses.replace(
        sim_cfg, max_route_hops=policy.max_hops,
        routing_delay=policy.routing_delay,
        best_effort=(policy.backup == "best_effort") and sim_cfg.best_effort)
    scheds = []
    for _ in range(n_replicas):
        cfg = sched_cfg or SchedulerConfig()
        cfg = dataclasses.replace(cfg, spec_alpha=spec_alpha)
        scheds.append(SLOsServeScheduler(perf, cfg))
    return ClusterSim(scheds, perf, sim_cfg)


def make_real_cluster(n_replicas: int, model_cfg, params, perf: PerfModel,
                      policy: RoutingPolicy = None, **kw):
    """Real-execution counterpart of ``make_slos_serve_cluster``: N
    PyTorch ``ServingEngine`` replicas behind the SLO-routed
    ``ClusterFrontend``, sharing one page budget (serving/cluster.py).
    ``device`` (in ``kw``) goes to ``ClusterFrontend.build``: CUDA unless
    named.  Imported lazily so the simulator-side core package stays
    importable without the serving stack."""
    from repro_torch.serving.cluster import ClusterFrontend
    return ClusterFrontend.build(model_cfg, params, n_replicas, perf,
                                 policy=policy, **kw)


def make_baseline_cluster(kind: str, n_replicas: int, perf: PerfModel,
                          sim_cfg: SimConfig = None,
                          prefill_ratio: tuple[int, int] = (1, 1),
                          spec_len: int = 0) -> ClusterSim:
    """kind in {vllm, vllm-spec, sarathi, distserve}."""
    from repro_torch.core.baselines import (VLLMScheduler, SarathiScheduler,
                                            DistServeScheduler)
    sim_cfg = sim_cfg or SimConfig()
    sim_cfg = dataclasses.replace(sim_cfg, best_effort=False)
    if kind == "distserve":
        p, d = prefill_ratio
        total = p + d
        assert n_replicas % total == 0, "replicas must split into the ratio"
        unit = n_replicas // total
        scheds = ([DistServeScheduler(perf, role="prefill")
                   for _ in range(p * unit)]
                  + [DistServeScheduler(perf, role="decode")
                     for _ in range(d * unit)])
        return ClusterSim(scheds, perf, sim_cfg, distserve=True)
    if kind == "vllm":
        scheds = [VLLMScheduler(perf) for _ in range(n_replicas)]
    elif kind == "vllm-spec":
        from repro_torch.core.scheduler import SchedulerConfig as _SC
        scheds = [VLLMScheduler(perf, cfg=_SC(spec_alpha=0.7),
                                spec_len=spec_len or 3)
                  for _ in range(n_replicas)]
    elif kind == "sarathi":
        scheds = [SarathiScheduler(perf) for _ in range(n_replicas)]
    else:
        raise ValueError(kind)
    return ClusterSim(scheds, perf, sim_cfg)
