"""The port's telemetry against the JAX package's: the registry, ring-buffer
series and exporters fed one scripted sequence of calls give the same
Prometheus text and percentiles; the autoscaler takes the same decisions
on one scripted attainment and pressure series; a small two-replica
cluster run on bridged weights gives the same exposition as the JAX
cluster (wall-clock histograms compared by count) and its counters equal
its ``ClusterStats``; and ``REPRO_TORCH_TRACE`` labels spans in
``torch.profiler``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as jcfgs                                   # noqa: E402
import repro.core.perf_model as jperf                           # noqa: E402
import repro.core.request as jreq                               # noqa: E402
import repro.core.router as jrouter                             # noqa: E402
import repro.core.scheduler as jsched                           # noqa: E402
import repro.models as jmodels                                  # noqa: E402
import repro.telemetry as jtel                                  # noqa: E402
from repro_torch import bridge, telemetry                       # noqa: E402
from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.core import (perf_model, request, router,      # noqa: E402
                              scheduler)
from repro_torch.telemetry import exporters                     # noqa: E402

# histograms of wall-clock (host) time: their values differ run to run
WALL_CLOCK = ("repro_plan_latency_seconds",)


def _script(T):
    """One fixed sequence of registry, series and tracer calls."""
    r = T.MetricsRegistry(enabled=True)
    c = r.counter("a_total", 'help "q"', ("cls", "rep"))
    g = r.gauge("g", "a gauge", ("r",))
    h = r.histogram("h_seconds", "", ("cls",), buckets=T.LATENCY_BUCKETS)
    rng = np.random.default_rng(0)
    for i, x in enumerate(rng.lognormal(-3.0, 1.0, 400).tolist()):
        cls = "tight" if i % 3 else 'tpot="0.05"'
        c.labels(cls=cls, rep=str(i % 2)).inc(1 + i % 4)
        g.labels(r=str(i % 5)).set(x)
        h.labels(cls=cls).observe(x)
    c.labels(cls="mirror", rep="0").set_total(7)
    c.labels(cls="mirror", rep="0").set_total(11)
    s = T.TimeSeriesSampler(capacity=16)
    for i in range(40):
        s.push("page_pressure", 0.1 * i, (i * 7 % 11) / 11)
        s.push("queue_depth", 0.1 * i, float(i % 6))
    tr = T.StepTracer()
    for i in range(5):
        tr.step(i, 0.25 * i, {"replicas": 2.0, "x": i / 3})
    buf = s.get("page_pressure")
    return (T.prometheus_text(r), T.histogram_percentiles(h),
            T.timeseries_prometheus_text(s), tr.dump(), buf.items(),
            buf.window_mean(5), buf.window_max(5))


def test_registry_series_and_exporters_match_jax():
    want, got = _script(jtel), _script(telemetry)
    assert got == want
    parsed = telemetry.parse_prometheus(got[0])
    assert parsed == jtel.parse_prometheus(want[0])
    for q in (0.5, 0.9, 0.99):
        assert telemetry.quantile_from_exposition(parsed, "h_seconds", q,
                                                  cls="tight") \
            == jtel.quantile_from_exposition(parsed, "h_seconds", q,
                                             cls="tight")


class _Driver:
    def __init__(self, idx):
        self.idx = idx
        self.running, self.new_q, self.be = [], [], []


class _Cluster:
    def __init__(self, n):
        self.drivers = [_Driver(i) for i in range(n)]
        self.draining = set()

    def add_replica(self):
        self.drivers.append(_Driver(len(self.drivers)))

    def drain_replica(self, i):
        self.drivers.pop(i)


def _decisions(T):
    """A scripted run: failing attainment scales up, a pressure spike and
    a backlog keep it busy, a quiet tail drains after its patience."""
    tel = T.ClusterTelemetry(enabled=True)
    sc = T.Autoscaler(tel, T.AutoscalerConfig(
        min_replicas=1, max_replicas=3, window=2, up_cooldown=0.1,
        down_cooldown=0.5, down_patience=3, min_finished=2))
    cl = _Cluster(1)
    t = 0.0
    for i in range(40):
        for _ in range(2):
            tel.note_finish("tpot=0.05", attained=i >= 8)
        tel.sampler.push("page_pressure", t, 0.97 if i in (12, 13) else 0.1)
        tel.sampler.push("queue_depth", t, 40.0 if 16 <= i < 18 else 0.0)
        sc.step(cl, t)
        t += 0.15
    return [(d.t, d.action, d.reason, d.replicas) for d in sc.decisions], \
        tel.tracer.dump()


def test_autoscaler_decisions_match_jax():
    want, got = _decisions(jtel), _decisions(telemetry)
    assert got == want
    actions = [a for _, a, _, _ in got[0]]
    assert "up" in actions and "down" in actions


@pytest.fixture(scope="module")
def weights():
    jcfg = jcfgs.get_reduced("smollm-135m")
    jparams = jax.jit(jmodels.init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return jcfg, jparams, get_reduced("smollm-135m"), tparams


def _cluster_run(R, Rq, S, P, cfg, params, **kw):
    cl = R.make_real_cluster(
        2, cfg, params, P.cpu_scale_perf_model(),
        policy=R.RoutingPolicy(max_hops=1), total_pages=48,
        replica_pages=16, page_size=4, max_slots=8, max_len=64,
        sched_cfg=S.SchedulerConfig(page_size=4,
                                    prefill_emits_first_token=True),
        telemetry=True, **kw)
    for i in range(6):
        cl.submit(Rq.simple_request(i, 0.05 * i, prompt=8, output=6,
                                    ttft_slowdown=6.0,
                                    tpot=0.05 if i % 2 else 0.15))
    stats = cl.run_until_idle()
    return cl, stats


def test_cluster_telemetry_matches_jax_and_stats(weights):
    jcfg, jparams, cfg, tparams = weights
    jcl, jstats = _cluster_run(jrouter, jreq, jsched, jperf, jcfg, jparams)
    cl, stats = _cluster_run(router, request, scheduler, perf_model, cfg,
                             tparams, device="cpu")
    assert stats.as_dict() == jstats.as_dict()
    assert stats.served == stats.submitted == 6
    want = jtel.parse_prometheus(jcl.telemetry.prometheus())
    got = telemetry.parse_prometheus(cl.telemetry.prometheus())
    assert set(got) == set(want)
    for key, v in want.items():
        if key[0].startswith(WALL_CLOCK):
            if key[0].endswith("_count"):
                assert got[key] == v, key
        else:
            assert got[key] == v, key
    # the exposition's counters are the cluster's stats
    fin = sum(v for k, v in got.items()
              if k[0] == "repro_requests_finished_total")
    assert fin == stats.served

    def event(name):
        return sum(v for (n, labels), v in got.items()
                   if n == "repro_engine_events_total"
                   and ("event", name) in labels)
    assert event("preemptions") == stats.preempted
    assert event("prefix_hit_tokens") == stats.prefix_hit_tokens
    for name in ("prefix_evictions", "spilled_pages", "prefetched_pages",
                 "host_evictions", "spilled_hit_tokens"):
        assert event(name) == getattr(stats, name), name
    for outcome, key in (("routed", "routed"), ("best_effort",
                                                "best_effort"),
                         ("affinity", "affinity_routed"),
                         ("dropped", "dropped")):
        assert got[("repro_routing_total", (("outcome", outcome),))] \
            == getattr(stats, key), outcome
    steps = cl.telemetry.tracer.records("step")
    assert [r["served_total"] for r in steps] == \
        [r["served_total"] for r in jcl.telemetry.tracer.records("step")]
    names = {r["name"] for r in cl.telemetry.tracer.records("span")}
    assert {"plan", "execute", "prefill", "decode"} <= names


def test_torch_trace_flag_labels_profiler_spans(monkeypatch):
    """With ``REPRO_TORCH_TRACE`` set each span opens a
    ``torch.profiler.record_function`` range of its name (recorded here
    by a stand-in: starting the profiler costs seconds)."""
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setenv("REPRO_TORCH_TRACE", "1")
    tr = exporters.StepTracer()
    with tr.span("decode", n=2):
        pass
    assert opened == ["decode"]
    assert tr.records("span")[0]["n"] == 2
    monkeypatch.delenv("REPRO_TORCH_TRACE")
    with exporters.StepTracer().span("prefill"):
        pass
    assert opened == ["decode"]
