"""The port's HTTP/SSE gateway (``repro_torch/serving/gateway.py``) and
the launcher's ``--http`` mode: the transport adds no behavior.

As ``tests/test_gateway.py`` does for the reference: payload parsing
(against the reference's ``request_from_payload``) and the HTTP error
surface; SSE token streams bit-identical to driving a fresh port cluster
in process, and equal to the JAX cluster's in-process streams on bridged
weights (``done`` fields equal but for the tie-break keys); concurrent
streams interleaving; a client disconnect cancelling its request with
its pages released and the shared budget conserved; graceful shutdown
draining every accepted stream; a replica drain under live traffic;
stream bytes invariant to telemetry, and ``/metrics`` exposing the time
series; a ``run_in_thread`` round trip; and the launcher as a process
(a request, SIGINT, the ``drained:`` line).

Gateways run with ``autostep=False`` on ``asyncio.run`` (the test pumps
the cluster itself, so every run is deterministic step for step)."""
import asyncio
import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as jcfgs                                   # noqa: E402
import repro.core.perf_model as jperf                           # noqa: E402
import repro.core.router as jrouter                             # noqa: E402
import repro.core.scheduler as jsched                           # noqa: E402
import repro.models as jmodels                                  # noqa: E402
import repro.serving.gateway as jgw                             # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.core.perf_model import cpu_scale_perf_model    # noqa: E402
from repro_torch.core.router import (RoutingPolicy,             # noqa: E402
                                     make_real_cluster)
from repro_torch.core.scheduler import SchedulerConfig          # noqa: E402
from repro_torch.core.trace import generate_trace               # noqa: E402
from repro_torch.launch import serve                            # noqa: E402
from repro_torch.serving.gateway import (GatewayClientError,    # noqa: E402
                                         PayloadError, SSEGateway,
                                         collect_stream, http_get,
                                         http_post, open_sse,
                                         request_from_payload,
                                         run_in_thread, sse_events)
from repro_torch.telemetry import parse_prometheus              # noqa: E402

ARCH = "smollm-135m"
ROOT = Path(__file__).resolve().parents[1]
# moved by the reference's decode tie-break (``core/scheduler.py:304-309``)
TIE_BREAK_KEYS = ("attained",)
CLUSTER_KW = dict(total_pages=64, replica_pages=32, page_size=4,
                  max_slots=8, max_len=96)

_jax_init = jax.jit(jmodels.init_params, static_argnums=(1,))


@pytest.fixture(scope="module")
def weights():
    jcfg = jcfgs.get_reduced(ARCH)
    jparams = _jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return jcfg, jparams, get_reduced(ARCH), tparams


def make_cluster(weights, n=2, **kw):
    _, _, cfg, params = weights
    defaults = dict(policy=RoutingPolicy(max_hops=1), **CLUSTER_KW,
                    sched_cfg=SchedulerConfig(
                        page_size=4, prefill_emits_first_token=True),
                    device="cpu")
    defaults.update(kw)
    if "total_pages" not in kw:
        defaults["total_pages"] = 32 * n
    return make_real_cluster(n, cfg, params, cpu_scale_perf_model(),
                             **defaults)


@pytest.fixture(scope="module")
def jax_cluster(weights):
    """One JAX cluster for the file: it serves the conformance payloads in
    process once (``test_sse_streams_match_jax_inprocess``)."""
    jcfg, jparams, _, _ = weights
    return jrouter.make_real_cluster(
        2, jcfg, jparams, jperf.cpu_scale_perf_model(),
        policy=jrouter.RoutingPolicy(max_hops=1), **CLUSTER_KW,
        sched_cfg=jsched.SchedulerConfig(page_size=4,
                                         prefill_emits_first_token=True))


def prompt_for(rid, seed=0, n=8):
    rng = np.random.default_rng((seed, rid))
    return rng.integers(1, 512, n).tolist()


async def _accepted(gw, n, timeout=5.0):
    for _ in range(int(timeout / 0.01)):
        if gw.stats.accepted >= n:
            return
        await asyncio.sleep(0.01)
    raise AssertionError(f"only {gw.stats.accepted}/{n} accepted")


def run_gateway(scenario, cluster):
    async def main():
        gw = await SSEGateway(cluster, autostep=False).start()
        try:
            return gw, await scenario(gw)
        finally:
            await gw.shutdown(drain=True)
    return asyncio.run(main())


def conserved(cluster):
    return (sum(d.engine.kv.used_pages for d in cluster.drivers)
            == cluster.budget.used)


# ----------------------- payloads and errors ---------------------------- #
PAYLOADS = [
    {"slo": "tight", "prompt_len": 8, "output_len": 4},
    {"slo": "spec", "prompt": [3, 4, 5], "output_len": 2, "tpot": 0.07},
    {"slo": "loose", "prompt_len": 5},
    {"prompt": [1, 2, 3],
     "stages": [{"kind": "prefill", "length": 9, "ttft_slowdown": 4.0},
                {"kind": "decode", "length": 5, "tpot": 0.2}]},
    {"stages": [{"kind": "prefill", "length": 6},
                {"kind": "decode", "length": 2},
                {"kind": "prefill", "length": 4, "ttft_slowdown": 2.0},
                {"kind": "decode", "length": 3, "tpot": 0.05}]},
    {"stages": [{"kind": "decode", "length": 3}]},
    {"slo": "nope", "prompt_len": 4},
    {"slo": "tight"},
    {"prompt": "text"},
    {"prompt": [1, "2"]},
    {"stages": []},
    {"stages": [{"kind": "warp", "length": 4}]},
    {"stages": [{"kind": "decode", "length": 0}]},
    {"slo": "loose", "prompt_len": 4, "output_len": 0},
]


def _request_fields(req, prompt):
    return (req.rid, req.arrival, prompt,
            [(s.kind.value, s.length, s.slo.ttft_slowdown, s.slo.tpot)
             for s in req.stages])


@pytest.mark.parametrize("payload", PAYLOADS)
def test_request_from_payload_matches_reference(payload):
    try:
        want = _request_fields(*jgw.request_from_payload(payload, 7, 1.5))
    except jgw.PayloadError:
        with pytest.raises(PayloadError):
            request_from_payload(payload, 7, 1.5)
        return
    assert _request_fields(*request_from_payload(payload, 7, 1.5)) == want


def test_http_error_surface(weights):
    async def scenario(gw):
        status, body = await http_post(gw.host, gw.port, "/v1/generate",
                                       {"slo": "nope", "prompt_len": 4})
        assert status == 400 and "slo" in body
        status, _ = await http_get(gw.host, gw.port, "/nope")
        assert status == 404
        status, body = await http_get(gw.host, gw.port, "/healthz")
        assert status == 200 and json.loads(body) == {"accepting": True,
                                                      "ok": True}
        with pytest.raises(GatewayClientError):
            await collect_stream(gw.host, gw.port, {"stages": []})
        return gw.stats.rejected

    gw, rejected = run_gateway(scenario, make_cluster(weights, n=1))
    assert rejected == 3 and gw.stats.accepted == 0


# --------------- conformance: SSE == in-process, port and JAX ----------- #
HAND = [
    {"slo": "tight", "prompt": prompt_for(0), "output_len": 6},
    {"slo": "loose", "prompt": prompt_for(1, n=12), "output_len": 5},
    {"prompt": prompt_for(2, n=6),
     "stages": [{"kind": "prefill", "length": 6, "ttft_slowdown": 4.0},
                {"kind": "decode", "length": 4, "tpot": 0.05},
                {"kind": "decode", "length": 3, "tpot": 0.1}]},
]


def inprocess(cluster, payloads, make_req):
    """Submit ``payloads`` in order on ``cluster`` at virtual time 0 and run
    it idle; each request's tokens, and the gateway's ``done`` fields
    (attained, dropped, finish time) at its terminal outcome."""
    streams, done = {}, {}

    def on_finish(req, attained, dropped):
        t = req.finish_time
        done[req.rid] = {"attained": bool(attained), "dropped": bool(dropped),
                         "t": None if t is None else round(t, 6)}
    for d in cluster.drivers:
        d.on_finish = on_finish
    for rid, p in enumerate(payloads):
        req, prompt = make_req(p, rid, 0.0)
        cluster.submit(req, prompt=prompt, on_token=lambda r, t: streams
                       .setdefault(r, []).extend(int(x) for x in t))
    cluster.run_until_idle()
    return streams, done


def serve_over_sse(cluster, payloads):
    """Every payload posted at once over TCP, then pumped until idle."""
    async def scenario(gw):
        tasks = [asyncio.create_task(collect_stream(gw.host, gw.port, p))
                 for p in payloads]
        await _accepted(gw, len(payloads))
        await gw.pump_until_idle()
        return await asyncio.gather(*tasks)

    gw, results = run_gateway(scenario, cluster)
    assert gw.stats.completed == gw.stats.accepted == len(payloads)
    assert [r["rid"] for r in results] == list(range(len(payloads)))
    return results


def test_sse_streams_bit_identical_to_inprocess_drive(weights):
    """The hand payloads and a trace's entries (six scenarios at CPU
    scale, tool loops included) over SSE equal a fresh identical port
    cluster driven in process, token for token and ``done`` for
    ``done``."""
    entries = generate_trace(3.0, 3.0, seed=1, time_scale=0.02,
                             max_stage_tokens=12, vocab=512)
    assert any(len(e.stages) == 6 for e in entries)
    payloads = HAND + [e.to_payload() for e in entries]
    results = serve_over_sse(make_cluster(weights), payloads)
    assert [r["slo_class"] for r in results[:3]] == [
        "tpot=0.05", "tpot=0.1", "tpot=0.05"]
    streams, done = inprocess(make_cluster(weights), payloads,
                              request_from_payload)
    for rid, r in enumerate(results):
        assert r["tokens"] == streams.get(rid, []), rid
        assert r["done"] == done[rid], rid
    assert [len(r["tokens"]) for r in results[:3]] == [6, 5, 7]


def test_sse_streams_match_jax_inprocess(weights, jax_cluster):
    """The hand payloads and one tool-loop entry (six stages) over the
    port's SSE equal the JAX cluster's in-process streams on the same
    weights; ``done`` fields equal but for the tie-break keys."""
    tool = [e for e in generate_trace(2.0, 2.0, seed=1, time_scale=0.02,
                                      max_stage_tokens=8, vocab=512)
            if e.scenario == "toolllm"]
    payloads = HAND + [e.to_payload() for e in tool]
    assert len(payloads[-1]["stages"]) == 6
    results = serve_over_sse(make_cluster(weights), payloads)
    jstreams, jdone = inprocess(jax_cluster, payloads,
                                jgw.request_from_payload)
    for rid, r in enumerate(results):
        assert r["tokens"] == jstreams.get(rid, []), rid
        for key in ("dropped", "t", "attained"):
            if key not in TIE_BREAK_KEYS:
                assert r["done"][key] == jdone[rid][key], (rid, key)
    assert len(results[-1]["tokens"]) == 12


# ------------------- concurrent interleaved streams -------------------- #
def test_concurrent_streams_interleave_chunks(weights):
    payloads = [{"slo": ("tight" if i % 2 else "loose"),
                 "prompt": prompt_for(i), "output_len": 8}
                for i in range(4)]

    async def scenario(gw):
        tasks = [asyncio.create_task(collect_stream(gw.host, gw.port, p))
                 for p in payloads]
        await _accepted(gw, len(payloads))
        await gw.pump_until_idle()
        return await asyncio.gather(*tasks)

    gw, results = run_gateway(scenario, make_cluster(weights))
    assert gw.stats.accepted == gw.stats.completed == 4
    for r in results:
        assert len(r["chunks"]) >= 2
        assert sum(len(c) for c in r["chunks"]) == len(r["tokens"])
    assert {r["rid"] for r in results} == {0, 1, 2, 3}


# --------------- disconnect -> cancel, pages released ------------------ #
def test_disconnect_cancels_and_releases_pages(weights):
    cluster = make_cluster(weights)

    async def scenario(gw):
        long_req = {"slo": "loose", "prompt": prompt_for(0), "output_len": 80}
        bystander = asyncio.create_task(collect_stream(
            gw.host, gw.port,
            {"slo": "tight", "prompt": prompt_for(1), "output_len": 6}))
        reader, writer = await open_sse(gw.host, gw.port, long_req)
        agen = sse_events(reader)
        ev, data = await asyncio.wait_for(agen.__anext__(), 5.0)
        assert ev == "start"
        live_rid = data["rid"]
        await _accepted(gw, 2)
        got = []
        for _ in range(200):
            if got:
                break
            gw._hook()
            gw.cluster.step(max_batches=1)
            assert conserved(cluster)
            await asyncio.sleep(0.01)
            try:
                ev, data = await asyncio.wait_for(agen.__anext__(), 0.5)
            except asyncio.TimeoutError:
                continue
            if ev == "token":
                got.extend(data["tokens"])
        assert got, "long stream never started"
        assert any(live_rid in d.engine.reqs for d in cluster.drivers)
        held = sum(len(d.engine.kv.tables.get(live_rid, []))
                   for d in cluster.drivers)
        assert held > 0
        writer.close()
        await writer.wait_closed()
        for _ in range(500):
            if gw.stats.disconnected:
                break
            await asyncio.sleep(0.01)
        assert gw.stats.disconnected == 1
        for d in cluster.drivers:
            assert live_rid not in d.engine.reqs
            assert live_rid not in d.engine.kv.tables
            assert all(r.rid != live_rid for r in d.running)
        assert conserved(cluster)
        await gw.pump_until_idle()
        return await bystander

    gw, bystander = run_gateway(scenario, cluster)
    assert (sum(d.engine.kv.used_pages for d in cluster.drivers)
            == cluster.budget.used == 0)
    assert cluster.stats.cancelled == 1
    assert bystander["done"]["attained"] in (True, False)
    assert gw.stats.completed == 1


# -------------------- graceful shutdown and drain ---------------------- #
def test_shutdown_drains_all_accepted_streams(weights):
    cluster = make_cluster(weights)

    async def main():
        gw = await SSEGateway(cluster, autostep=False).start()
        payloads = [{"slo": "loose", "prompt": prompt_for(i),
                     "output_len": 10} for i in range(3)]
        tasks = [asyncio.create_task(collect_stream(gw.host, gw.port, p))
                 for p in payloads]
        await _accepted(gw, 3)
        await gw.shutdown(drain=True)
        results = await asyncio.gather(*tasks)
        with pytest.raises((GatewayClientError, ConnectionError, OSError)):
            await collect_stream(gw.host, gw.port, payloads[0])
        return gw, results

    gw, results = asyncio.run(main())
    assert gw.stats.completed == 3
    assert all(r["done"] is not None and len(r["tokens"]) == 10
               for r in results)
    assert cluster.idle and cluster.budget.used == 0


def test_drain_replica_under_live_traffic(weights):
    cluster = make_cluster(weights)

    async def scenario(gw):
        payloads = [{"slo": "loose", "prompt": prompt_for(i),
                     "output_len": 8} for i in range(4)]
        tasks = [asyncio.create_task(collect_stream(gw.host, gw.port, p))
                 for p in payloads]
        await _accepted(gw, 4)
        await gw.pump_until_idle(max_steps=2)
        status, body = await http_post(gw.host, gw.port, "/admin/drain",
                                       {"replica": 0})
        assert status == 200 and json.loads(body) == {"draining": 0}
        await gw.pump_until_idle()
        results = await asyncio.gather(*tasks)
        for _ in range(50):
            if len(gw.cluster.drivers) == 1:
                break
            gw._hook()
            gw.cluster.step()
            await asyncio.sleep(0)
        assert len(gw.cluster.drivers) == 1
        status, _ = await http_post(gw.host, gw.port, "/admin/drain",
                                    {"replica": 0})
        assert status == 400
        return results

    gw, results = run_gateway(scenario, cluster)
    assert gw.stats.completed == 4
    assert all(len(r["tokens"]) == 8 for r in results)
    assert len(cluster.drivers) == 1 and cluster.budget.used == 0


# ------------------- telemetry observes, never perturbs ----------------- #
def _stream_bytes(weights, telemetry):
    cluster = make_cluster(weights, telemetry=telemetry)
    payloads = [
        {"slo": "tight", "prompt": prompt_for(0), "output_len": 5},
        {"slo": "loose", "prompt": prompt_for(1), "output_len": 6},
    ]

    async def scenario(gw):
        out = []
        for p in payloads:
            reader, writer = await open_sse(gw.host, gw.port, p)
            await gw.pump_until_idle()
            out.append(await reader.read())
            writer.close()
        return out

    _, chunks = run_gateway(scenario, cluster)
    return chunks


def test_metrics_do_not_change_stream_bytes(weights, monkeypatch):
    monkeypatch.delenv("REPRO_METRICS", raising=False)
    off = _stream_bytes(weights, telemetry=False)
    monkeypatch.setenv("REPRO_METRICS", "1")
    on = _stream_bytes(weights, telemetry=True)
    assert on == off
    assert all(b"event: done" in c for c in on)


def test_metrics_endpoint_exposes_timeseries(weights):
    from repro_torch.telemetry import ClusterTelemetry
    cluster = make_cluster(weights, telemetry=ClusterTelemetry(
        enabled=True, wall_clock=True))

    async def scenario(gw):
        task = asyncio.create_task(collect_stream(
            gw.host, gw.port,
            {"slo": "tight", "prompt": prompt_for(0), "output_len": 5}))
        await _accepted(gw, 1)
        await gw.pump_until_idle()
        await task
        return await http_get(gw.host, gw.port, "/metrics")

    _, (status, text) = run_gateway(scenario, cluster)
    assert status == 200
    parsed = parse_prometheus(text)
    assert sum(v for (name, _), v in parsed.items()
               if name == "repro_requests_finished_total") == 1
    assert any(name == "repro_step_series" for name, _ in parsed)


# ----------------------------- threaded -------------------------------- #
def test_run_in_thread_round_trip(weights):
    cluster = make_cluster(weights)
    handle = run_in_thread(cluster)
    try:
        async def client():
            outs = await asyncio.gather(*[collect_stream(
                handle.host, handle.port,
                {"slo": "tight", "prompt": prompt_for(i), "output_len": 4})
                for i in range(2)])
            return outs, await http_get(handle.host, handle.port, "/healthz")
        outs, (status, _) = asyncio.run(client())
    finally:
        handle.shutdown(drain=True)
    assert status == 200
    assert all(len(o["tokens"]) == 4 and o["done"] is not None for o in outs)
    assert not handle.thread.is_alive()
    assert handle.gateway.stats.completed == 2
    assert cluster.idle and cluster.budget.used == 0


# ------------------------------ launcher ------------------------------- #
def test_launcher_http_serves_and_drains_on_sigint():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--http",
         "--reduced", "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving smollm-135m x2 at http://"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(line.split("http://", 1)[1].split(" ")[0].rsplit(":")[1])
        out = asyncio.run(collect_stream(
            "127.0.0.1", port,
            {"slo": "tight", "prompt_len": 16, "output_len": 8}))
        assert len(out["tokens"]) == 8 and out["done"] is not None
        proc.send_signal(signal.SIGINT)
        rest, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    last = rest.splitlines()[-1]
    assert last.startswith("drained: served 1/1, attained ")
    assert last.endswith(", cancelled 0, streams completed 1")


def test_launcher_http_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--http", "--reduced", "--port", "0"])
    args = serve.parse_args(["--http"])
    assert (args.device, args.host, args.port, args.replicas) == (
        "cuda", "127.0.0.1", 8080, 2)


def test_http_cluster_sizes(weights):
    """Reduced: the reference launcher's cluster; full width: pages from
    the model's bytes a page (phi4-mini: 4 MiB a page, 256 a replica)."""
    from repro_torch.configs import get_config
    assert serve.http_cluster_config(get_reduced(ARCH), True) == dict(
        page_size=8, replica_pages=64, max_len=256, max_slots=8)
    phi = get_config("phi4-mini-3.8b")
    assert serve.kv_bytes_per_page(phi, 16) == 4 * 2**20
    assert serve.http_cluster_config(phi, False) == dict(
        page_size=16, max_len=1024, max_slots=8, replica_pages=256)
    gw = serve.http_gateway(weights[2], weights[3], 2, reduced=True,
                            device="cpu", autostep=False)
    cl = gw.cluster
    assert cl.budget.total_pages == 128 and len(cl.drivers) == 2
    assert all(d.engine.params is weights[3] for d in cl.drivers)
    assert all(d.engine.ecfg.page_size == 8 and d.engine.ecfg.max_len == 256
               and d.engine.kv.total_pages == 64 for d in cl.drivers)
    assert cl.policy.max_hops == 1 and cl.telemetry.sampler.wall_clock
    assert dataclasses.asdict(cl.drivers[0].sched.cfg)["page_size"] == 8
