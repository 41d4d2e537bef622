#!/usr/bin/env python
"""Train cut-depth models of the port on the card at several AdamW
schedules and print every step's loss, so that a training check's margin
can be set above the step-to-step noise.

Each run draws the port's seeded weights, trains on the Markov stream
(``train_loop.train``'s loop, every step's loss read) and, on one
held-out batch of the stream (the seed plus 1000), reads the loss before
and after training.  With ``--fixed-batch`` every step trains on the
stream's first batch (the loss then reads how fast the model fits it).
One JSON line a run: the schedule, the losses, the held-out
losses, the steady step time and the peak memory, beside the card's name
and power limit.

  python scripts/sweep_train_schedule.py \\
      --run mamba2-2.7b:16:4x512:40:1e-3:2 \\
      --run phi3.5-moe-42b-a6.6b:2:4x512:40:1e-3:10

``--run`` is ARCH:LAYERS:BATCHxSEQ:STEPS:LR:WARMUP (the published widths,
cut to LAYERS).  CUDA only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def held_out_loss(cfg, params, batch: int, seq_len: int, seed: int) -> float:
    from repro_torch.training.data import batches
    from repro_torch.training.train_loop import lm_loss
    b = {k: torch.from_numpy(v).long().cuda() for k, v in
         next(batches(cfg.vocab, batch, seq_len, seed + 1000)).items()}
    with torch.no_grad():
        loss, _ = lm_loss(params, cfg, b["tokens"], b["labels"])
    return float(loss)


def run(spec: str, seed: int, fixed: bool = False) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import init_params
    from repro_torch.training.data import batches
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step, trainable

    arch, layers, shape, steps, lr, warmup = spec.split(":")
    batch, seq_len = (int(x) for x in shape.split("x"))
    layers, steps, warmup, lr = int(layers), int(steps), int(warmup), float(lr)
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers,
                              block_pattern=full.block_pattern[:layers])
    torch.cuda.reset_peak_memory_stats()
    # train()'s loop with every step's loss read
    params = trainable(init_params(cfg, generator("cuda", seed),
                                   device="cuda"))
    before = held_out_loss(cfg, params, batch, seq_len, seed)
    state = init_opt_state(params)
    step_fn = make_train_step(cfg, AdamWConfig(lr=lr, total_steps=steps,
                                               warmup_steps=warmup))
    it = batches(cfg.vocab, batch, seq_len, seed)
    b = None
    losses, at = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        if b is None or not fixed:
            b = {k: torch.from_numpy(v).cuda().long() for k, v in
                 next(it).items()}
        params, state, m = step_fn(params, state, b)
        losses.append(float(m["loss"]))
        at.append(time.perf_counter() - t0)
    after = held_out_loss(cfg, params, batch, seq_len, seed)
    peak = torch.cuda.max_memory_allocated() / 2**30
    diffs = [y - x for x, y in zip(losses, losses[1:])]
    return {"fixed_batch": fixed, "arch": arch, "layers": layers,
            "batch": batch, "seq_len": seq_len, "steps": steps, "lr": lr,
            "warmup": warmup,
            "losses": losses, "held_out_before": before,
            "held_out_after": after,
            "max_step_to_step_rise": max(diffs),
            "step_ms": 1e3 * (at[-1] - at[0]) / (steps - 1),
            "peak_gib": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", action="append", required=True,
                    metavar="ARCH:LAYERS:BxS:STEPS:LR:WARMUP")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fixed-batch", action="store_true",
                    help="train every step on the stream's first batch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_train_schedule: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import set_precision
    set_precision()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for spec in args.run:
        t0 = time.perf_counter()
        rec = run(spec, args.seed, args.fixed_batch)
        rec.update({"gpu": card, "wall_s": time.perf_counter() - t0})
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
