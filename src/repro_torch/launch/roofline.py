"""Roofline terms over dry-run records (port of
``repro/launch/roofline.py``).

Reads ``experiments/dryrun/*.json`` (written by ``launch/dryrun.py``),
derives the three terms per (arch x shape x mesh) and writes a CSV and a
markdown table.  The terms are DERIVED FROM SPEC-SHEET CONSTANTS, not
measured: ``core/perf_model.py``'s ``H100_80G`` (989 TFLOP/s dense bf16,
3.35 TB/s HBM, 450 GB/s NVLink per direction), applied to the port's
counts of one shard's program:

  compute    = flops_per_chip / peak_flops
  memory     = bytes_per_chip / hbm_bw
  collective = collective_bytes_per_chip / link_bw

The dry run's counts are per shard already.  Its bytes are unfused (every
aten op's operands and results, ``launch/cost_analysis.py``), so the
memory term is an upper side.  MODEL_FLOPS uses 6·N·D for training and
2·N_active·D for inference forward passes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir DIR]
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import os

from repro_torch.core.perf_model import H100_80G

SHAPE_TOKENS = {
    "train_4k": 256 * 4096,
    "prefill_32k": 32 * 32768,
    "decode_32k": 128 * 1,
    "long_500k": 1 * 1,
}

TERMS_NOTE = ("terms derived from H100_80G spec-sheet constants applied "
              "to dry-run counts; not measured")


def analyze(rec: dict, hw=H100_80G) -> dict:
    chips = rec["n_chips"]
    flops_chip = rec["flops"]
    bytes_chip = rec["hlo_bytes"]
    coll_chip = rec["collectives"]["total_bytes"]
    t_comp = flops_chip / hw.peak_flops
    t_mem = bytes_chip / hw.hbm_bw
    t_coll = coll_chip / hw.link_bw
    dominant = max(("compute", t_comp), ("memory", t_mem),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    tokens = SHAPE_TOKENS[rec["shape"]]
    mult = 6.0 if rec["shape"] == "train_4k" else 2.0
    model_flops = mult * rec["params_active"] * tokens
    model_flops_chip = model_flops / chips
    ratio = model_flops_chip / max(flops_chip, 1.0)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "status": rec["status"],
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": model_flops,
        "useful_ratio": ratio,
        "compile_s": rec.get("compile_s"),
        "hardware": hw.name, "terms": "spec-sheet",
    }


def suggestion(row: dict) -> str:
    d = row["dominant"]
    r = row["useful_ratio"]
    if d == "memory":
        return ("cut HBM traffic: avoid S^2 softmax materialization "
                "(flash/chunked attention), fuse norms and elementwise "
                "chains, bf16 cache")
    if d == "collective":
        return ("re-shard to shrink NVLink traffic: reduce-scatter the "
                "gradients and overlap the FSDP all-gathers with compute, "
                "or keep weights replicated over data (--shard tp)")
    if r < 0.5:
        return ("compute-bound but <50% useful FLOPs: eliminate redundant "
                "compute (masked attention waste, MoE over-capacity, remat)")
    return ("near the tensor-core roofline: tune tile sizes, overlap "
            "loads with the tensor cores")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--csv", default="experiments/roofline.csv")
    ap.add_argument("--md", default="experiments/roofline.md")
    args = ap.parse_args(argv)

    rows = []
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec["mesh"], "status": rec["status"],
                         "reason": rec.get("reason", rec.get("error", ""))})
            continue
        rows.append(analyze(rec))

    os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
    keys = ["arch", "shape", "mesh", "status", "t_compute_s", "t_memory_s",
            "t_collective_s", "dominant", "useful_ratio", "compile_s",
            "hardware", "terms", "reason"]
    with open(args.csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)

    os.makedirs(os.path.dirname(args.md) or ".", exist_ok=True)
    with open(args.md, "w") as f:
        f.write(f"Roofline ({TERMS_NOTE})\n\n")
        f.write("| arch | shape | mesh | compute (s) | memory (s) | "
                "collective (s) | dominant | useful FLOP ratio | "
                "next move |\n")
        f.write("|---|---|---|---|---|---|---|---|---|\n")
        for r in rows:
            if r.get("status") != "ok":
                f.write(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"— | — | — | {r['status']} | — | "
                        f"{r.get('reason', '')[:60]} |\n")
                continue
            f.write(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
                f"| {r['t_collective_s']:.3e} | **{r['dominant']}** "
                f"| {r['useful_ratio']:.2f} | {suggestion(r)} |\n")
    print(f"wrote {args.csv} and {args.md} ({len(rows)} rows; "
          f"{TERMS_NOTE})")


if __name__ == "__main__":
    main()
