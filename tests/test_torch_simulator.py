"""The port's simulator, router factories and baselines against the JAX
package's: ``ClusterSim`` from ``make_slos_serve_cluster`` and from each
``make_baseline_cluster`` kind replays the same seeded workload on two
replicas.  Both are pure Python in virtual time, so every field of the
result (per-request records, preemptions, the load trace) must be exactly
equal; only the host-time fields (scheduler overheads, wall clock)
differ."""
import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.perf_model as jperf                           # noqa: E402
import repro.core.router as jrouter                             # noqa: E402
import repro.core.workload as jwork                             # noqa: E402
from repro_torch.core import perf_model, router, workload       # noqa: E402

HOST_TIME = ("sched_overheads", "sim_wallclock")


def _run(R, P, W, kind, scenario, rate):
    perf = P.opt_perf_model(7e9)
    reqs = W.generate_workload(scenario, rate, 10.0, seed=0)
    sim = (R.make_slos_serve_cluster(2, perf) if kind == "slos-serve"
           else R.make_baseline_cluster(kind, 2, perf))
    return dataclasses.asdict(sim.run(reqs))


@pytest.mark.parametrize("kind,scenario,rate", [
    ("slos-serve", "chatbot", 12.0),
    ("slos-serve", "coder", 8.0),        # overload: best-effort tier
    ("vllm", "coder", 8.0),
    ("vllm-spec", "coder", 8.0),
    ("sarathi", "coder", 8.0),
    ("distserve", "coder", 8.0),
])
def test_cluster_sim_matches_jax(kind, scenario, rate):
    want = _run(jrouter, jperf, jwork, kind, scenario, rate)
    got = _run(router, perf_model, workload, kind, scenario, rate)
    assert want["n_requests"] > 100
    for key in want:
        if key not in HOST_TIME:
            assert got[key] == want[key], key
    if (kind, scenario) == ("slos-serve", "coder"):
        assert got["n_best_effort"] > 0


def test_core_exports_the_simulator():
    from repro_torch import core
    assert core.ClusterSim is router.ClusterSim
    assert {"ClusterSim", "SimConfig", "find_capacity"} <= set(core.__all__)
