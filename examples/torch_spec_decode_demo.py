"""SLO-adaptive speculative decoding on the PyTorch port, end to end: the
DP scheduler PLANS per-SLO-class draft lengths (spec_planner co-optimized
with admission), the engine executes draft+verify batches with those
lengths (on the card the verify window runs through the hand-written
verify kernel), and a per-class acceptance EWMA feeds the observed accept
rate back into the next plan, so the draft length adapts online instead
of being a fixed knob (§3.2.3).

The run starts from an optimistic acceptance prior (0.7).  The 1-layer
random-weight draft agrees with the target far less often, so watch the
EWMA collapse and the planned draft length shrink toward autoregressive:
speculation tokens are only spent where the observed acceptance earns
them.  On the card the target is smollm-135m at its published width;
``--reduced`` takes the reduced config.

  PYTHONPATH=src python examples/torch_spec_decode_demo.py          # card
  PYTHONPATH=src python examples/torch_spec_decode_demo.py --device cpu \\
      --reduced
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.perf_model import opt_perf_model
from repro_torch.core.request import simple_request
from repro_torch.core.scheduler import SchedulerConfig, SLOsServeScheduler
from repro_torch.device import generator, resolve_device
from repro_torch.models import init_params
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.frontend import ServingFrontend

ARCH = "smollm-135m"
PAGE = 16
# Two SLO classes: a tight-TPOT tier that NEEDS speculation to hold its
# deadline at the planner's acceptance estimate, and a relaxed chat tier.
TIGHT, LOOSE = 0.0125, 0.1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (the CPU's size)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = (get_reduced if args.reduced else get_config)(ARCH)
    params = init_params(cfg, generator(device, 0), device=device)
    dcfg = dataclasses.replace(cfg, name="draft", n_layers=1,
                               block_pattern=("attn",))
    dparams = init_params(dcfg, generator(device, 7), device=device)

    eng = ServingEngine(cfg, params,
                        EngineConfig(max_slots=4, max_len=128, page_size=PAGE,
                                     total_pages=96),
                        draft=(dcfg, dparams), device=device)
    perf = opt_perf_model(7e9, spec=True)
    sched = SLOsServeScheduler(perf, SchedulerConfig(
        page_size=PAGE, prefill_emits_first_token=True, spec_alpha=0.7))
    fe = ServingFrontend(eng, sched)  # attaches the per-class accept EWMA

    rng = np.random.default_rng(0)
    for rid, tpot in enumerate([TIGHT, TIGHT, LOOSE]):
        req = simple_request(rid, 0.0, prompt=48, output=40,
                             ttft_slowdown=8.0, tpot=tpot)
        fe.submit(req, prompt=rng.integers(1, cfg.vocab, 48).tolist())

    print(f"{cfg.name} on {device}")
    print(f"{'step':>4} {'planned sl per tier':>24} "
          f"{'EWMA alpha per tier':>28} {'acc/drafted':>12}")
    step, planned = 0, []
    while not fe.idle and step < 40:
        fe.step()
        step += 1
        tiers, sls, alphas = sched.last_spec_plan or ((), None, None)
        est = sched.estimator
        a = {t: round(est.alpha(t), 3) for t in tiers} if est else {}
        sl = dict(zip(tiers, sls)) if sls else "AR (no speculation)"
        planned.append(list(sls) if sls else None)
        c = eng.counters
        print(f"{step:>4} {str(sl):>24} {str(a):>28} "
              f"{c['spec_accepted_tokens']:>5}/{c['spec_drafted_tokens']}")

    c = eng.counters
    s = fe.stats
    acc = c["spec_accepted_tokens"] / max(c["spec_drafted_tokens"], 1)
    print(f"\nserved {s.served} requests, {s.tokens_out} tokens; "
          f"drafted {c['spec_drafted_tokens']} spec tokens, "
          f"accepted {c['spec_accepted_tokens']} ({acc:.0%}, the EWMA the "
          f"planner adapted to)")
    print(f"verify ops: fused={c['verify_fused_ops']} "
          f"gather-attn={c['verify_attn_ops']} "
          f"scatter={c['verify_scatter_ops']}")
    print("draft lengths were PLANNED per SLO tier by the DP scheduler and "
          "re-fit every round from the observed acceptance, not a CLI "
          "flag.")
    return {"steps": step, "served": s.served, "submitted": s.submitted,
            "tokens_out": s.tokens_out,
            "drafted": c["spec_drafted_tokens"],
            "accepted": c["spec_accepted_tokens"], "accept_rate": acc,
            "verify_calls": c["spec_verify_calls"],
            "verify_fused_ops": c["verify_fused_ops"],
            "planned_draft_lengths": planned, "idle": fe.idle}


if __name__ == "__main__":
    main()
