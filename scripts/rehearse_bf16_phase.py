#!/usr/bin/env python
"""Rehearse ``chip_smoke.py``'s bf16 serving phases on the CPU.

The spec and MLA paths run twice in ``chip_smoke.py``: in float32
(``spec_stream``, ``spec_replay``, ``mla_stream``, ``mla_replay``) and
with ``EngineConfig(dtype=torch.bfloat16)`` (``bf16_streams`` against the
plain attention, ``bf16_spec_replay``, ``bf16_mla_replay``).  The
replays' control flow (groups, decode steps, verifies, the launch counts
they check, the pool bytes) depends on page counts and the planner's
virtual clock, not on the weights or the device, so it can be checked
here before it costs chip time.  This runs those phases at the reduced
qwen3-1.7b and deepseek-v2 widths (deepseek cut to ``MLA_CUT``'s three
layers) on the CPU with the card's slot and page counts: the phases'
CUDA-only calls are replaced by host stand-ins, and the attention
module's calls of the kernel wrappers (which run the plain versions on
the CPU) count as kernel launches, while the yardstick's plain versions,
swapped in by ``plain_paged_attention``, count as plain calls.  Times are
host times of the CPU and mean nothing for the card.

  PYTHONPATH=src python scripts/rehearse_bf16_phase.py [--only spec|mla]

It prints the phases' lines (and exits non-zero on a failed check).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _count_wrappers_as_kernels():
    """Each wrapper the attention module calls, counted as a launch of
    its kernel (its plain call moved to the kernel count)."""
    from repro_torch.kernels import (mla_paged_prefill, paged_attention,
                                     paged_prefill, paged_verify)
    from repro_torch.models import attention as at
    for name, mod in (("paged_decode_attention", paged_attention),
                      ("paged_prefill_attention", paged_prefill),
                      ("paged_verify_attention", paged_verify),
                      ("mla_paged_prefill_attention", mla_paged_prefill)):
        fn = getattr(at, name)

        def counted(*a, _fn=fn, _mod=mod, **k):
            out = _fn(*a, **k)
            _mod.COUNTS["plain"] -= 1
            _mod.COUNTS["kernel"] += 1
            return out
        setattr(at, name, counted)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("spec", "mla"), default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from rehearse_cluster_phase import _TorchOnHost
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import (flash_attention, mla_paged_prefill,
                                     paged_attention, paged_prefill,
                                     paged_verify, ssd_scan)
    from repro_torch.models import init_params

    cs.torch = _TorchOnHost()
    cs.card_line = lambda: "cpu rehearsal"
    cs.time_ms = lambda fn: 1.0        # host stand-in, never zero
    cs.cuda_profile = lambda fn, n=1, flush=True: None
    _count_wrappers_as_kernels()
    kernels = {"decode": paged_attention, "prefill": paged_prefill,
               "verify": paged_verify, "mla_prefill": mla_paged_prefill,
               "ssd": ssd_scan, "flash": flash_attention}
    bf16, seed = torch.bfloat16, args.seed
    try:
        if args.only in (None, "spec"):
            cfg = get_reduced(cs.SPEC_ARCH)
            params = init_params(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu")
            wants = cs.spec_stream_phase(cfg, params, seed)
            f32 = cs.spec_replay_phase(cfg, params, kernels, seed)
            prompts = cs.spec_prompts(cfg, seed)
            draft = cs.one_layer_draft(cfg, torch.device("cpu"), seed + 7)
            cs.kv16_streams_phase(
                "spec", cfg, params, prompts,
                lambda dtype: cs.spec_script(cfg, params, prompts, draft,
                                             dtype)[0], wants, bf16)
            cs.spec_replay_phase(cfg, params, kernels, seed, bf16, f32=f32)
        if args.only in (None, "mla"):
            cfg = dataclasses.replace(get_reduced(cs.MLA_ARCH), **cs.MLA_CUT)
            params = init_params(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu")
            wants = cs.mla_stream_phase(cfg, params, seed)
            f32 = cs.mla_replay_phase(cfg, params, kernels, seed)
            prompts = cs.script_prompts(cfg, seed + 3)
            cs.kv16_streams_phase(
                "mla", cfg, params, prompts,
                lambda dtype: cs.run_script(cfg, params, prompts,
                                            cs.STREAM_SCRIPT, max_len=256,
                                            dtype=dtype)[0], wants, bf16)
            cs.mla_replay_phase(cfg, params, kernels, seed, bf16, f32=f32)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
