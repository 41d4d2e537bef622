#!/usr/bin/env python
"""Rehearse ``chip_smoke.py``'s llama-3.2-vision phases on the CPU.

The phases' control flow (the scheduler's prefill groups and decode
steps, and so the launch counts they check) depends on the page counts
and the planner's virtual clock, not on the widths or the device, so it
can be checked here before it costs chip time.  This runs
``vlm_stream_phase`` and ``vlm_replay_phase`` at the reduced VLM's
widths (3 layers, one of them ``cross_attn``, 16 image tokens) with the
card's engine (``VLM_ENGINE``: page 16, 8 slots) and trace, on the CPU:
the phases' CUDA-only calls are replaced by host stand-ins, the plain
kernel versions count as the kernel launches (as in
``scripts/rehearse_cluster_phase.py``), and the B6 cases that the replay
must run are taken at the reduced heads and image tokens.  The phases'
checks run unchanged: ``model_published_widths`` and ``depth`` fail here
by design.  Times are host times of the CPU and mean nothing for the
card.

  PYTHONPATH=src python scripts/rehearse_vlm_phase.py [--seed 0]

It prints the phases' lines, then the launch counts the card must show
at the card's depth (``chip_smoke.vlm_config()``: the first 10 of 40
layers, 2 cross blocks) for the same prefill groups and decode steps.
"""
from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# the checks that hold the card's widths and depth, which the reduced
# config lacks
WIDTH_CHECKS = ("model_published_widths", "depth")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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
    cs.time_ms = lambda fn: 1.0
    cs.cuda_profile = lambda fn, n=1, flush=True: None
    kernels = {"decode": paged_attention, "prefill": paged_prefill,
               "verify": paged_verify, "mla_prefill": mla_paged_prefill,
               "ssd": ssd_scan, "flash": flash_attention}
    for mod in kernels.values():
        _count_plain_as_kernel(mod)
    cfg = get_reduced(cs.VLM_ARCH)
    params = cs.set_vlm_gates(init_params(
        cfg, torch.Generator().manual_seed(args.seed), device="cpu"))
    # the replay's B6 shapes at the reduced heads and image tokens
    cs.FLASH_CASES = [
        (n, B, Sq, cfg.n_image_tokens, cfg.n_heads, cfg.n_kv_heads,
         cfg.head_dim, *rest) if n.startswith("vlm_replay") else
        (n, B, Sq, Sk, H, KV, hd, *rest)
        for n, B, Sq, Sk, H, KV, hd, *rest in cs.FLASH_CASES]
    failed = False
    cs.vlm_stream_phase(cfg, params, args.seed)
    emitted = []
    emit = cs.emit
    cs.emit = lambda obj: (emitted.append(obj), emit(obj))
    try:
        cs.vlm_replay_phase(cfg, params, kernels, args.seed)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        failed = any(k not in WIDTH_CHECKS
                     for k in ast.literal_eval(str(exc).split(": ", 1)[1]))
    rec = emitted[-1]
    c = rec["counters"]
    card = cs.vlm_config()
    n_cross = card.block_pattern.count("cross_attn")
    print(json.dumps({"card_launches_at_card_depth": {
        "flash": n_cross * (c["prefill_calls"] + c["decode_steps"]),
        "prefill": card.n_layers * c["prefill_calls"],
        "decode": card.n_layers * c["decode_steps"],
        "verify": 0, "mla_prefill": 0, "ssd": 0},
        "prefill_calls": c["prefill_calls"],
        "decode_steps": c["decode_steps"]}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
