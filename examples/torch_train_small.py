"""Train on the synthetic Markov LM task with the PyTorch port: AdamW,
cosine schedule and checkpointing.  (The paper is a serving paper; this
exercises the training substrate.)  On the card it trains smollm-135m at
its published width; ``--reduced`` trains the reduced config.

  PYTHONPATH=src python examples/torch_train_small.py               # card
  PYTHONPATH=src python examples/torch_train_small.py --device cpu \\
      --reduced [--arch mamba2-2.7b] [--checkpoint-dir DIR]

Checkpoints go to ``--checkpoint-dir``, or to a new temporary directory
(printed) when none is named.
"""
import argparse
import tempfile

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.training.checkpoint import latest_step
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (the CPU's size)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="where the checkpoints go (default: a new "
                         "temporary directory)")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    ckpt = args.checkpoint_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    res = train(cfg, steps=args.steps, batch=8, seq_len=64,
                opt_cfg=AdamWConfig(lr=3e-3, total_steps=args.steps,
                                    warmup_steps=10),
                checkpoint_dir=ckpt, checkpoint_every=args.checkpoint_every,
                device=device)
    try:
        saved = latest_step(ckpt)
    except FileNotFoundError:              # fewer steps than one interval
        saved = None
    print(f"{cfg.name}: loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
          f"in {res.steps} steps ({res.wallclock:.0f}s on {device}); "
          f"checkpoint step {saved} in {ckpt}")
    return {"arch": cfg.name, "steps": res.steps, "loss_first": res.losses[0],
            "loss_last": res.losses[-1], "losses": res.losses,
            "wall_s": res.wallclock, "checkpoint_dir": ckpt,
            "checkpoint_step": saved}


if __name__ == "__main__":
    main()
