#!/usr/bin/env python
"""Rehearse ``chip_smoke.py``'s ``gateway_replay`` phase on the CPU.

The phase's control flow (the trace, admission, routing, preemption, the
drain, the disconnect) depends on page counts and the planner's virtual
clock, not on the weights or the device, so it can be checked here
before it costs chip time.  This runs ``gateway_phase`` at the reduced
phi4-mini width on the CPU with the card's page counts (the launcher's
full-width sizing reads the bytes a page of the published widths at the
phase's depth): the
phase's CUDA-only calls are replaced by host stand-ins, the plain kernel
versions count as the kernel launches (as in
``scripts/rehearse_cluster_phase.py``), and the phase's checks run
unchanged; ``model_full_width`` is the one that fails here by design.
Times are host times of the CPU and mean nothing for the card; the
open-loop part runs at the trace's wall-clock arrivals.

  PYTHONPATH=src python scripts/rehearse_gateway_phase.py

It prints the phase's ``gateway_replay`` line (and the failed checks).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from rehearse_cluster_phase import _TorchOnHost, _count_plain_as_kernel
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import (flash_attention, mla_paged_prefill,
                                     paged_attention, paged_prefill,
                                     paged_verify, ssd_scan)
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    cs.torch = _TorchOnHost()
    cs.card_line = lambda: "cpu rehearsal"
    for mod in (paged_attention, paged_prefill):
        _count_plain_as_kernel(mod)
    full = cs.cut_depth(get_config(cs.GATEWAY["arch"]), cs.GATEWAY["layers"])
    per_page = serve.kv_bytes_per_page
    serve.kv_bytes_per_page = lambda cfg, page: per_page(full, page)
    cfg = get_reduced(cs.GATEWAY["arch"])
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device="cpu")
    kernels = {"decode": paged_attention, "prefill": paged_prefill,
               "verify": paged_verify, "mla_prefill": mla_paged_prefill,
               "ssd": ssd_scan, "flash": flash_attention}
    try:
        cs.gateway_phase(cfg, params, kernels, args.seed)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 0 if "['model_full_width']" in str(exc) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
