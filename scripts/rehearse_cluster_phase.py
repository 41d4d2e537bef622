#!/usr/bin/env python
"""Rehearse ``chip_smoke.py``'s ``cluster_replay`` phase on the CPU.

The phase's control flow (routing, best-effort demotion, preemption,
affinity, spill, prefetch, drain) depends only on page counts and the
planner's virtual clock, not on the weights or the device, so it can be
tuned here before it costs chip time.  This runs ``cluster_phase`` at the
reduced smollm-135m width (or the full one) on the CPU: the phase's
CUDA-only calls (events, synchronize, peak memory, ``nvidia-smi``) are
replaced by host stand-ins, the plain kernel versions count as the kernel
launches, and the phase's own checks run unchanged.  Times are host
times of the CPU and mean nothing for the card.

  PYTHONPATH=src python scripts/rehearse_cluster_phase.py
  PYTHONPATH=src python scripts/rehearse_cluster_phase.py \\
      --set replica_pages=320 --set total_pages=512 --no-streams

It prints the phase's ``cluster_replay`` line (and the failed checks).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


class _HostEvent:
    def __init__(self, **_):
        self.t = None

    def record(self, *_):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class _HostCuda:
    Event = _HostEvent

    @staticmethod
    def synchronize():
        pass

    @staticmethod
    def reset_peak_memory_stats():
        pass

    @staticmethod
    def max_memory_allocated():
        return 0

    @staticmethod
    def empty_cache():
        pass


class _TorchOnHost:
    """``torch`` as the phase sees it: the device is the CPU and
    ``torch.cuda`` the host stand-ins above."""
    cuda = _HostCuda

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def device(*_):
        return torch.device("cpu")


def _count_plain_as_kernel(mod):
    for name in dir(mod):
        if name.endswith("_plain"):
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, **k):
                out = _fn(*a, **k)
                mod.COUNTS["plain"] -= 1
                mod.COUNTS["kernel"] += 1
                return out
            setattr(mod, name, counted)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="full-width smollm-135m (slow on the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override an entry of chip_smoke.CLUSTER")
    ap.add_argument("--no-streams", action="store_true",
                    help="skip the plain-generation check of the streams")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import (flash_attention, mla_paged_prefill,
                                     paged_attention, paged_prefill,
                                     paged_verify, ssd_scan)
    from repro_torch.models import init_params

    for kv in args.set:
        key, value = kv.split("=", 1)
        cs.CLUSTER[key] = type(cs.CLUSTER[key])(json.loads(value))
    cs.torch = _TorchOnHost()
    cs.card_line = lambda: "cpu rehearsal"
    if args.no_streams:
        cs.greedy_reference = lambda params, cfg, prompt, n, dev, enc=None: (
            [], [])
        cs.compare_stream = lambda got, want, margins: {"ok": True}
    for mod in (paged_attention, paged_prefill):
        _count_plain_as_kernel(mod)
    cfg = (get_config if args.full else get_reduced)("smollm-135m")
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device="cpu")
    kernels = {"decode": paged_attention, "prefill": paged_prefill,
               "verify": paged_verify, "mla_prefill": mla_paged_prefill,
               "ssd": ssd_scan, "flash": flash_attention}
    try:
        cs.cluster_phase(cfg, params, kernels, args.seed)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
