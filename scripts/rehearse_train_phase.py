#!/usr/bin/env python
"""Rehearse ``chip_smoke.py``'s training and dense-cache phases on the CPU.

Runs ``dense_cache_phase``, ``train_dense_phase``, ``train_ssm_phase``
and ``train_moe_phase`` at the reduced widths of their models (the
phases' ``get_config`` is ``get_reduced`` here and the depth cuts fit the
reduced depths), with every device the phases name mapped to the CPU: the
launcher, ``train``, the card-vs-CPU step (both sides then run on the
CPU) and the launch-count checks run as on the card.  The checks that
hold the published widths, the card's step count and its memory fail
here by design; so may ``loss_falls``: the reduced models' losses start
near ln 512 and cannot fall by the 5 nats that ``train_ssm`` and
``train_moe`` ask of the published ones.  Times
are host times and mean nothing for the card.

  PYTHONPATH=src python scripts/rehearse_train_phase.py

It prints the phases' lines and the failed checks.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# the checks that hold the card's widths and scale, which the reduced
# configs lack
BY_DESIGN = ("model_published", "model_published_widths", "loss_falls")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    import repro_torch.configs as configs
    import repro_torch.device as device
    from rehearse_cluster_phase import _TorchOnHost
    from repro_torch.kernels import (flash_attention, mla_paged_prefill,
                                     paged_attention, paged_prefill,
                                     paged_verify, ssd_scan)
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params
    from repro_torch.training import train_loop

    resolve = device.resolve_device

    def on_host(dev=None):
        return resolve("cpu" if dev is None or "cuda" in str(dev) else dev)
    for mod in list(sys.modules.values()):
        if getattr(mod, "resolve_device", None) is resolve:
            mod.resolve_device = on_host
    configs.get_config = launch_train.get_config = configs.get_reduced
    cs.torch = _TorchOnHost()
    cs.SSM_TRAIN = dict(cs.SSM_TRAIN, layers=2)
    args = cs.TRAIN_DENSE_ARGS
    cs.TRAIN_DENSE_ARGS = args[:args.index("--seq-len") + 1] + ["128"] + \
        args[args.index("--seq-len") + 2:]            # a quicker rehearsal
    kernels = {"decode": paged_attention, "prefill": paged_prefill,
               "verify": paged_verify, "mla_prefill": mla_paged_prefill,
               "ssd": ssd_scan, "flash": flash_attention}
    assert train_loop.resolve_device is on_host
    failed = False
    cfg = configs.get_reduced("smollm-135m")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    phases = [lambda: cs.dense_cache_phase(cfg, params, kernels, 0)] + [
        lambda p=p: p(kernels, "cpu rehearsal", 0) for p in (
            cs.train_dense_phase, cs.train_ssm_phase, cs.train_moe_phase)]
    for phase in phases:
        try:
            phase()
        except SystemExit as exc:
            print(exc, file=sys.stderr)
            text = str(exc).split(": ", 1)[1]
            names = (ast.literal_eval(text) if text.startswith("[")
                     else [k for k, v in ast.literal_eval(text).items()
                           if not v])
            failed = failed or any(k not in BY_DESIGN for k in names)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
