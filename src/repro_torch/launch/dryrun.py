"""Dry run: one shard's step program of every (arch x input shape) pair on
the production mesh, on meta tensors, with its FLOP, byte, collective and
memory counts (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles the step on 256 or 512 placeholder
devices.  Here shard (0, 0)'s program (``launch/steps.py``'s ``build``)
runs alone on the ``meta`` device (shapes, no storage, no card): its
collectives are solo ones that return the gathered shapes and count the
bytes the real ones would (``distributed/sharding.py``), and
``launch/cost_analysis.py`` counts its ops.  Every shard is alike,
because ``_fit`` keeps only axes that divide their dimension evenly.
On meta the MoE dispatch counts every local expert at the capacity of
the global batch (no per-expert count can be read), and a kernel wrapper
runs its plain version for shapes (``kernels.shapes_only``), so the
counts are the plain version's ops, not the hand kernel's.

The record has the reference's keys.  ``compile_s`` is the seconds the
shard's program took on meta; ``memory.argument_bytes`` and
``output_bytes`` are the SHARD's bytes of its inputs (parameters,
moments, batch, cache) and outputs from their specs; nothing is
compiled, so ``temp_bytes`` is None (not measured) and
``generated_code_bytes`` 0; ``flops_xla_raw``, ``bytes_xla_raw`` and
``collectives.static_unrolled`` are None (no XLA).  ``--variant opt``
is the reference's (chunked attention, absorbed MLA, remat, 8
microbatches); buffer donation has no counterpart in eager PyTorch.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.distributed.sharding import shard_nbytes
from repro_torch.launch import steps
from repro_torch.launch.cost_analysis import analyze
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import SHAPES, build, shape_supported
from repro_torch.training.tree import leaves

OPT_VARIANT = dict(attn_impl="chunked", mla_absorb=True, remat=True)
OPT_MICROBATCHES = 8


def analyze_step(cfg, shape, mesh, dtype=torch.bfloat16,
                 microbatches: int = 1) -> dict:
    """Shard (0, 0)'s program of ``shape`` (a name of ``SHAPES`` or such a
    dict) over ``mesh`` on meta: ``cost_analysis.analyze``'s counts plus
    ``memory`` (the shard's argument and output bytes)."""
    fn, args = build(cfg, shape, mesh, dtype, microbatches)
    cost = analyze(steps.run_shard0, fn, args, mesh)
    arg_bytes = sum(shard_nbytes(a.tree, a.specs, mesh)
                    for a in args if a is not None)
    out = cost.pop("result")
    if isinstance(out, tuple) and len(out) == 3 and isinstance(out[2], dict):
        out = out[:2]                       # train: params, opt (metrics)
    out_bytes = sum(t.numel() * t.element_size() for t in leaves(out))
    cost["memory"] = dict(argument_bytes=int(arg_bytes),
                          output_bytes=int(out_bytes),
                          temp_bytes=None, generated_code_bytes=0)
    return cost


def run_one(arch: str, shape: str, multi_pod: bool = False,
            out_dir: str = "experiments/dryrun",
            variant: str = "baseline") -> dict:
    cfg = get_config(arch)
    if variant == "opt":
        cfg = dataclasses.replace(cfg, **OPT_VARIANT)
    ok, reason = shape_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape, "variant": variant,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "n_chips": 512 if multi_pod else 256}
    if not ok:
        rec.update(status="skipped", reason=reason)
        _write(rec, out_dir, arch, shape, variant)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    try:
        c = analyze_step(cfg, shape, mesh,
                         microbatches=(OPT_MICROBATCHES
                                       if variant == "opt"
                                       and SHAPES[shape]["kind"] == "train"
                                       else 1))
        rec.update(
            status="ok",
            compile_s=round(time.time() - t0, 1),
            flops=float(c["flops"]),
            hlo_bytes=float(c["bytes"]),
            flops_xla_raw=None,
            bytes_xla_raw=None,
            utilization=None,
            memory=c["memory"],
            collectives=c["collectives"] | {
                "total_bytes": c["collective_bytes"],
                "static_unrolled": None},
            params=cfg.param_count(),
            params_active=cfg.active_param_count(),
            kv_bytes_per_token=cfg.kv_bytes_per_token(),
        )
    except Exception as e:  # noqa: BLE001 - record the failure, keep going
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:],
                   compile_s=round(time.time() - t0, 1))
    _write(rec, out_dir, arch, shape, variant)
    return rec


def _write(rec: dict, out_dir: str, arch: str, shape: str,
           variant: str) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}_{shape}_{rec['mesh'].replace('x', '-')}"
    if variant != "baseline":
        tag += f"_{variant}"
    if steps.SHARD_MODE["mode"] != "fsdp":
        tag += f"_{steps.SHARD_MODE['mode']}"
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--include-swa", action="store_true",
                    help="also run the beyond-paper qwen3 SWA variant")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "opt"])
    ap.add_argument("--shard", default="fsdp", choices=["fsdp", "tp"])
    args = ap.parse_args(argv)
    steps.SHARD_MODE["mode"] = args.shard

    if args.all:
        archs = list(ASSIGNED) + (["qwen3-1.7b-swa"] if args.include_swa
                                  else [])
        shapes = list(SHAPES)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        archs, shapes = [args.arch], [args.shape]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, args.multi_pod, args.out,
                          variant=args.variant)
            status = rec["status"]
            extra = ""
            if status == "ok":
                gb = rec["memory"]["argument_bytes"] / 2**30
                extra = (f"flops={rec['flops']:.3e} "
                         f"args/chip={gb:.2f}GiB "
                         f"coll={rec['collectives']['total_bytes']:.3e}B "
                         f"meta_run={rec['compile_s']}s")
            elif status == "skipped":
                extra = rec["reason"]
            else:
                extra = rec["error"][:160]
                n_fail += 1
            print(f"[{status:7s}] {arch:24s} {shape:12s} {rec['mesh']:8s} "
                  f"{extra}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
