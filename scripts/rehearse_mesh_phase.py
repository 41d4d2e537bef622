#!/usr/bin/env python
"""Rehearse ``chip_smoke.py``'s ``mesh_replay`` phase on the CPU.

The phase's control flow (the engine's groups and decode steps, the
spec cycles, the cluster's routing, spills and prefetches, and the launch
counts it checks) depends on page counts, the planner's virtual clock and
the mesh's shard count, not on the weights or the device, so it can be
checked here before it costs chip time.  This runs ``mesh_replay_phase``
with every case's reduced config, on a mesh of ``MESH_SHARDS`` CPU
shards with the card's page and slot counts (``MESH_ENGINE``,
``MESH_CLUSTER``): the phase's CUDA-only calls are replaced by host
stand-ins (``scripts/rehearse_cluster_phase.py``) and the plain kernel
versions count as the kernel launches.  Every check runs unchanged; the
CPU's plain versions give bit-equal logits, which the card's cuBLAS need
not.  The kernel cases at shard shapes (``mesh_kernel_phase``) need the
card and are not rehearsed.  Times are host times of the CPU and mean
nothing for the card.

  PYTHONPATH=src python scripts/rehearse_mesh_phase.py

It prints the phase's lines and exits non-zero if a check failed.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _count_plain_as_kernel(mod):
    """The plain versions counted as kernel launches, under the lock the
    wrappers take (the mesh's shards launch from threads of their own)."""
    from repro_torch.kernels import bump
    for name in dir(mod):
        if name.endswith("_plain"):
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, **k):
                out = _fn(*a, **k)
                bump(mod.COUNTS, "plain", -1)
                bump(mod.COUNTS, "kernel")
                return out
            setattr(mod, name, counted)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from rehearse_cluster_phase import _TorchOnHost
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import (flash_attention, mla_paged_prefill,
                                     paged_attention, paged_prefill,
                                     paged_verify, ssd_scan)

    cs.torch = _TorchOnHost()
    cs.card_line = lambda: "cpu rehearsal"
    kernels = {"decode": paged_attention, "prefill": paged_prefill,
               "verify": paged_verify, "mla_prefill": mla_paged_prefill,
               "ssd": ssd_scan, "flash": flash_attention}
    for mod in kernels.values():
        _count_plain_as_kernel(mod)
    try:
        cs.mesh_replay_phase(kernels, args.seed, cfg_of=get_reduced)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
