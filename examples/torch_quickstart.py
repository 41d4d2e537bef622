"""Quickstart on the PyTorch port: the SLOs-Serve planner in 40 lines.

Builds the paper's performance model for an OPT-7B-class chip, submits a
burst of requests with mixed SLOs, and prints the admission decisions and
the token-level batch plan (chunked prefill + decode interleaving).  The
planner runs on the host (``repro_torch.core``); ``--device`` names the
card the rest of the stack would serve on, and is resolved as every
entry point of the port resolves it (CUDA unless named).

  PYTHONPATH=src python examples/torch_quickstart.py                # card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

from repro_torch.core import (SchedulerConfig, SLOsServeScheduler,
                              opt_perf_model, simple_request)
from repro_torch.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="accepted for a uniform command line; the "
                         "planner has no model to reduce")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    perf = opt_perf_model(7e9)          # roofline-derived (k1, k2, b) terms
    sched = SLOsServeScheduler(perf, SchedulerConfig())

    # Three applications, three SLO profiles (paper Table 1):
    reqs = [
        #                        prompt out   TTFT-slowdown  TPOT
        simple_request(0, 0.0,   1400,  200,  3.0,           0.100),  # summ.
        simple_request(1, 0.0,    850,  300,  5.0,           0.050),  # coder
        simple_request(2, 0.0,    760,  260,  5.0,           0.100),  # chat
        simple_request(3, 0.0,   6000,  100,  1.2,           0.050),  # infeas.
    ]

    plan = sched.plan(now=0.0, running=[], new=reqs, mem_free=10_000)

    print(f"device: {device}")
    print("admitted:", [r.rid for r in plan.admitted])
    print("declined:", [r.rid for r in plan.declined],
          "(handled by best-effort tier / routing, paper §4)")
    print(f"\nfirst planned batches ({len(plan.batches)} total):")
    batches = []
    for i, b in enumerate(plan.batches[:6]):
        parts = ", ".join(f"r{e.rid}:{e.kind.value[:3]}x{e.n_tokens}"
                          for e in b.entries)
        print(f"  batch {i}: {b.est_duration * 1e3:5.1f} ms  [{parts}] "
              f"+{b.prefill_budget} spare")
        batches.append({"ms": b.est_duration * 1e3,
                        "entries": [(e.rid, e.kind.value, e.n_tokens)
                                    for e in b.entries],
                        "spare": b.prefill_budget})
    return {"admitted": [r.rid for r in plan.admitted],
            "declined": [r.rid for r in plan.declined],
            "n_batches": len(plan.batches), "batches": batches}


if __name__ == "__main__":
    main()
