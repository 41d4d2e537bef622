"""Training launcher of the port (port of ``repro/launch/train.py``'s
default mode): trains a config on the synthetic Markov stream with AdamW
and prints the first and last logged loss.  On the card (the default) use
``--full-config`` for the published width and depth; the reduced config
runs on the CPU with ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --full-config --batch 8 --seq-len 1024 --steps 60          # CUDA

To run a step's program over a production mesh without a card (the
counts of one shard's step on meta tensors), use ``launch/dryrun.py``:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
      --shape train_4k
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_reduced
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainResult, train


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full-config", action="store_true",
                    help="the published width and depth (card scale)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full_config else get_reduced(
        args.arch)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 2))
    res = train(cfg, steps=args.steps, batch=args.batch,
                seq_len=args.seq_len, seed=args.seed, opt_cfg=opt,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every, device=args.device)
    print(f"arch={cfg.name} steps={res.steps} "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
          f"({res.wallclock:.1f}s)")
    return res


if __name__ == "__main__":
    main()
