"""Serving launcher of the port: the SLOs-Serve scheduler driving the
PyTorch engine end to end through ``ServingFrontend``, in batch-replay
mode (port of ``repro/launch/serve.py``; the HTTP/SSE mode is not ported).

The planner runs against the same virtual-time performance model as the
JAX launcher (``cpu_scale_perf_model``), so served / attained / dropped
counts are comparable between the two; the engine executes every planned
token for real.  On the card (the default) the full published config is
served; ``--reduced`` picks the CPU-test variant, which runs on the CPU
with ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve              # CUDA
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --reduced --device cpu
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.perf_model import cpu_scale_perf_model
from repro_torch.core.scheduler import SchedulerConfig, SLOsServeScheduler
from repro_torch.core.workload import generate_workload
from repro_torch.device import generator, resolve_device
from repro_torch.models import init_params
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.frontend import ServingFrontend

VIRTUAL_PERF = cpu_scale_perf_model()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced (CPU-test) config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--scenario", default="chatbot")
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-scale", type=float, default=0.02,
                    help="shrink request lengths (1.0 = the scenario's own)")
    ap.add_argument("--max-requests", type=int, default=24)
    return ap.parse_args(argv)


def engine_config(reduced: bool) -> EngineConfig:
    """The reduced config keeps the JAX launcher's engine; the full config
    gets a 4096-token context and pages for eight such sequences."""
    if reduced:
        return EngineConfig(max_slots=8, max_len=256, total_pages=256)
    max_len, page = 4096, 16
    return EngineConfig(max_slots=8, max_len=max_len, page_size=page,
                        total_pages=8 * math.ceil(max_len / page))


def build(args):
    """Engine, scheduler and frontend with the trace submitted.  Returns
    (frontend, engine)."""
    device = resolve_device(args.device)
    cfg = (get_reduced if args.reduced else get_config)(args.arch)
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


def main(argv=None):
    fe, engine = build(parse_args(argv))
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


if __name__ == "__main__":
    main()
