#!/usr/bin/env python
"""Rehearse ``chip_smoke.py``'s zamba2 and phi3.5-moe phases on the CPU.

The phases' control flow (the scheduler's groups and decode steps, the
slots reused, the launch counts they check) depends on page counts and
the planner's virtual clock, not on the weights or the device, so it can
be checked here before it costs chip time.  This runs
``hybrid_stream_phase`` and ``hybrid_replay_phase`` at the reduced
zamba2 width and ``moe_stream_phase`` and ``moe_replay_phase`` at the
reduced phi3.5-moe width, on the CPU with the card's slot and page counts
(``HYBRID_ENGINE``, ``MOE_ENGINE``): the phases' CUDA-only calls are
replaced by host stand-ins, the plain kernel versions count as the kernel
launches (as in ``scripts/rehearse_cluster_phase.py``), and the phases'
checks run unchanged but for the widths: ``model_full_width`` and
``model_published_widths`` fail here by design.  Times are host times of
the CPU and mean nothing for the card.

  PYTHONPATH=src python scripts/rehearse_hybrid_phase.py [--only hybrid|moe]

It prints the phases' lines (and the failed checks).
"""
from __future__ import annotations

import argparse
import ast
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# the checks that hold the card's widths, which the reduced configs lack
WIDTH_CHECKS = ("model_full_width", "model_published_widths", "depth_cut")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("hybrid", "moe"), default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from rehearse_cluster_phase import _TorchOnHost, _count_plain_as_kernel
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import (flash_attention, mla_paged_prefill,
                                     paged_attention, paged_prefill,
                                     paged_verify, ssd_scan)
    from repro_torch.models import init_params

    cs.torch = _TorchOnHost()
    cs.card_line = lambda: "cpu rehearsal"
    cs.time_ms = lambda fn: 0.0
    cs.cuda_profile = lambda fn, n=1, flush=True: None
    for mod in (paged_attention, paged_prefill, ssd_scan):
        _count_plain_as_kernel(mod)
    kernels = {"decode": paged_attention, "prefill": paged_prefill,
               "verify": paged_verify, "mla_prefill": mla_paged_prefill,
               "ssd": ssd_scan, "flash": flash_attention}
    paths = [("hybrid", cs.HYBRID_ARCH, cs.hybrid_stream_phase,
              cs.hybrid_replay_phase),
             ("moe", cs.MOE_ARCH, cs.moe_stream_phase, cs.moe_replay_phase)]
    failed = False
    for name, arch, stream, replay in paths:
        if args.only not in (None, name):
            continue
        cfg = get_reduced(arch)
        params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                             device="cpu")
        stream(cfg, params, args.seed)
        try:
            replay(cfg, params, kernels, args.seed)
        except SystemExit as exc:
            print(exc, file=sys.stderr)
            failed = failed or any(
                k not in WIDTH_CHECKS
                for k in ast.literal_eval(str(exc).split(": ", 1)[1]))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
