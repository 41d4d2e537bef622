#!/usr/bin/env python
"""Rehearse ``chip_smoke.py``'s ``train_mesh`` phase on the CPU.

Runs ``train_mesh_phase`` with qwen3-1.7b's reduced config (4 / 2 heads,
so the model axis of the data 2 x model 2 mesh splits heads and FFN
columns as at the published widths) on a mesh of four CPU shards, at the
phase's batch and steps with 64-token rows: the unsharded step, the
sharded step, every gate, the replicas, the resting bytes and the
collectives against ``launch/dryrun.py``'s one-shard count.  The card's
run differs in widths, sequence length and device only.  Times are the
CPU's and mean nothing for the card.

  PYTHONPATH=src python scripts/rehearse_train_mesh_phase.py

It prints the phase's line and exits non-zero if a check failed.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import (flash_attention, mla_paged_prefill,
                                     paged_attention, paged_prefill,
                                     paged_verify, ssd_scan)
    kernels = {"decode": paged_attention, "prefill": paged_prefill,
               "verify": paged_verify, "mla_prefill": mla_paged_prefill,
               "ssd": ssd_scan, "flash": flash_attention}
    spec = dict(cs.TRAIN_MESH, seq_len=64)
    try:
        cs.train_mesh_phase(kernels, "cpu", 0, dev=torch.device("cpu"),
                            cfg=get_reduced(spec["arch"]), spec=spec)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
