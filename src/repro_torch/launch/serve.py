"""Serving launcher of the port: the SLOs-Serve scheduler driving the
PyTorch engine end to end through ``ServingFrontend``, in batch-replay
mode, or live over HTTP/SSE (port of ``repro/launch/serve.py``).

The planner runs against the same virtual-time performance model as the
JAX launcher (``cpu_scale_perf_model``), so served / attained / dropped
counts are comparable between the two; the engine executes every planned
token for real.  On the card (the default) the full published config is
served; ``--reduced`` picks the CPU-test variant, which runs on the CPU
with ``--device cpu``.  ``--layers N`` serves the config's first N layers
at its widths (a depth cut, for a run that must fit a time budget):

  PYTHONPATH=src python -m repro_torch.launch.serve              # CUDA
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --reduced --device cpu

``--http`` switches from batch replay to the live serving path: the
asyncio HTTP/SSE gateway (``serving/gateway.py``) over an N-replica
``ClusterFrontend`` (``--replicas``), with wall-clock telemetry on ``GET
/metrics`` and graceful SIGINT/SIGTERM shutdown: intake stops, every
in-flight stream drains to its done event, then the process exits.

  PYTHONPATH=src python -m repro_torch.launch.serve --http --reduced \
      --device cpu --replicas 2
  curl -N -d '{"slo":"tight","prompt_len":16,"output_len":32}' \
      http://127.0.0.1:8080/v1/generate
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.perf_model import cpu_scale_perf_model
from repro_torch.core.scheduler import SchedulerConfig, SLOsServeScheduler
from repro_torch.core.workload import generate_workload
from repro_torch.device import generator, resolve_device
from repro_torch.models import init_params
from repro_torch.models.transformer import init_paged_cache
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.frontend import ServingFrontend

VIRTUAL_PERF = cpu_scale_perf_model()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced (CPU-test) config")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve only the config's first N layers (its "
                         "widths unchanged)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--scenario", default="chatbot")
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-scale", type=float, default=0.02,
                    help="shrink request lengths (1.0 = the scenario's own)")
    ap.add_argument("--max-requests", type=int, default=24)
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP/SSE instead of batch replay")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--replicas", type=int, default=2)
    return ap.parse_args(argv)


def model_config(args):
    """The served config: published or reduced, cut to ``--layers``."""
    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    if args.layers is not None and args.layers < 1:
        raise ValueError(f"--layers must be at least 1, got {args.layers}")
    if args.layers is not None and args.layers < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers,
                                  block_pattern=cfg.block_pattern[
                                      :args.layers])
    return cfg


def engine_config(reduced: bool) -> EngineConfig:
    """The reduced config keeps the JAX launcher's engine; the full config
    gets a 4096-token context and pages for eight such sequences."""
    if reduced:
        return EngineConfig(max_slots=8, max_len=256, total_pages=256)
    max_len, page = 4096, 16
    return EngineConfig(max_slots=8, max_len=max_len, page_size=page,
                        total_pages=8 * math.ceil(max_len / page))


def kv_bytes_per_page(cfg, page_size: int) -> int:
    """Device bytes of one page over every paged pool leaf (all layers'
    K and V, or MLA's latent rows), from the pools' shapes alone: pools
    of one page hold two (the write-off page is the second)."""
    pools = init_paged_cache(cfg, 1, page_size, device="meta")
    return sum(leaf.numel() * leaf.element_size()
               for pool in pools if "self" in pool
               for leaf in pool["self"].values()) // 2


# The HTTP mode's cluster.  Reduced: the reference launcher's numbers.
# Full width: page 16, a 1024-token context and 8 slots, each replica's
# pools sized by the model's bytes a page to at most HTTP_KV_GIB (and to
# no more than its slots can fill).
HTTP_REDUCED = dict(page_size=8, replica_pages=64, max_len=256, max_slots=8)
HTTP_FULL = dict(page_size=16, max_len=1024, max_slots=8)
HTTP_KV_GIB = 1.0


def http_cluster_config(cfg, reduced: bool) -> dict:
    """``page_size``, ``replica_pages``, ``max_len`` and ``max_slots`` of
    one replica of the HTTP mode's cluster."""
    if reduced:
        return dict(HTTP_REDUCED)
    c = dict(HTTP_FULL)
    fill = c["max_slots"] * math.ceil(c["max_len"] / c["page_size"])
    per_page = kv_bytes_per_page(cfg, c["page_size"])
    c["replica_pages"] = (fill if per_page == 0 else
                          max(1, min(fill, int(HTTP_KV_GIB * 2**30)
                                     // per_page)))
    return c


def http_gateway(cfg, params, replicas: int, *, reduced: bool, device,
                 host: str = "127.0.0.1", port: int = 0, seed: int = 0,
                 autostep: bool = True):
    """The HTTP mode: ``replicas`` engines over shared ``params`` behind
    the SLO-routed ``ClusterFrontend`` (one hop, then the backup tier),
    one page budget of ``replicas`` x ``replica_pages``, wall-clock
    telemetry, and an ``SSEGateway`` over it, not started yet (``await
    gw.start()`` on an event loop, or ``run_in_thread(gw.cluster)``)."""
    from repro_torch.core.router import RoutingPolicy, make_real_cluster
    from repro_torch.serving.gateway import SSEGateway
    from repro_torch.telemetry import ClusterTelemetry

    c = http_cluster_config(cfg, reduced)
    cluster = make_real_cluster(
        replicas, cfg, params, VIRTUAL_PERF,
        policy=RoutingPolicy(max_hops=1),
        total_pages=c["replica_pages"] * replicas,
        replica_pages=c["replica_pages"], page_size=c["page_size"],
        max_slots=c["max_slots"], max_len=c["max_len"],
        sched_cfg=SchedulerConfig(page_size=c["page_size"],
                                  prefill_emits_first_token=True),
        telemetry=ClusterTelemetry(enabled=True, wall_clock=True),
        device=device)
    return SSEGateway(cluster, host=host, port=port, autostep=autostep,
                      seed=seed)


def serve_http(args) -> dict:
    """Run the SSE gateway until SIGINT/SIGTERM, then drain gracefully.
    Returns the drained cluster's counts."""
    import asyncio
    import signal

    device = resolve_device(args.device)
    cfg = model_config(args)
    params = init_params(cfg, generator(device, args.seed), device=device)
    gw = http_gateway(cfg, params, args.replicas, reduced=args.reduced,
                      device=device, host=args.host, port=args.port,
                      seed=args.seed)
    cluster = gw.cluster

    async def amain():
        await gw.start()
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        print(f"serving {args.arch} x{args.replicas} at {gw.url} "
              f"(SSE on POST /v1/generate; Ctrl-C drains and exits)",
              flush=True)
        await stop.wait()
        print("draining in-flight streams...", flush=True)
        await gw.shutdown(drain=True)
        s = cluster.stats
        print(f"drained: served {s.served}/{s.submitted}, "
              f"attained {s.attained}, cancelled {s.cancelled}, "
              f"streams completed {gw.stats.completed}", flush=True)

    asyncio.run(amain())
    s = cluster.stats
    return {"served": s.served, "submitted": s.submitted,
            "attained": s.attained, "cancelled": s.cancelled,
            "streams_completed": gw.stats.completed}


def build(args):
    """Engine, scheduler and frontend with the trace submitted.  Returns
    (frontend, engine)."""
    device = resolve_device(args.device)
    cfg = model_config(args)
    params = init_params(cfg, generator(device, args.seed), device=device)
    engine = ServingEngine(cfg, params, engine_config(args.reduced),
                           device=device)
    sched = SLOsServeScheduler(VIRTUAL_PERF, SchedulerConfig(
        prefill_emits_first_token=True))
    fe = ServingFrontend(engine, sched, seed=args.seed)
    for r in trace(args):
        fe.submit(r)
    return fe, engine


def trace(args):
    """The scenario's requests, cut to ``--max-requests``, their stage
    lengths scaled by ``--time-scale`` (at least 4 tokens each)."""
    reqs = generate_workload(args.scenario, args.rate, args.duration,
                             args.seed)[:args.max_requests]
    for r in reqs:
        for i, s in enumerate(r.stages):
            r.stages[i] = type(s)(s.slo, max(4, int(s.length
                                                    * args.time_scale)))
    return reqs


def replay(fe) -> float:
    """Serve until idle; returns the wall seconds, device work included."""
    t0 = time.perf_counter()
    fe.run_until_idle()
    if fe.engine.device.type == "cuda":
        torch.cuda.synchronize(fe.engine.device)
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    """Serve the trace (or ``--http``: the gateway until a signal); returns
    the printed numbers."""
    args = parse_args(argv)
    if args.http:
        return serve_http(args)
    fe, engine = build(args)
    wall = replay(fe)
    stats = fe.stats
    print(f"served {stats.served}/{stats.submitted} requests "
          f"({stats.dropped} dropped), {stats.tokens_out} tokens generated "
          f"by the engine, SLO attained {stats.attained}/{stats.served} "
          f"(virtual time {fe.clock:.1f}s, wall {wall:.1f}s on "
          f"{engine.device})")
    c = engine.counters
    per_call = c["decode_tokens"] / max(c["decode_calls"], 1)
    print(f"device calls: {c['prefill_calls']} prefill chunks, "
          f"{c['decode_calls']} fused decode loops "
          f"({c['decode_tokens']} tokens, {per_call:.1f} tokens/loop)")
    return {"served": stats.served, "submitted": stats.submitted,
            "dropped": stats.dropped, "tokens_out": stats.tokens_out,
            "attained": stats.attained, "virtual_s": fe.clock,
            "wall_s": wall, "device": str(engine.device),
            "prefill_calls": c["prefill_calls"],
            "decode_calls": c["decode_calls"],
            "decode_tokens": c["decode_tokens"]}


if __name__ == "__main__":
    main()
