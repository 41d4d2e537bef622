"""Multi-replica serving with SLO-driven request routing on the PyTorch
port (paper §4.2).

The same story told three times:
  1. the virtualized event simulator (``ClusterSim``) at paper-scale
     lengths: four replicas behind the centralized controller;
  2. the REAL cluster runtime (``ClusterFrontend``): two port engine
     replicas executing every token (on the card smollm-135m at its
     published width through the hand-written kernels; ``--reduced``: the
     reduced config), with SLO-verdict routing, a shared page budget,
     best-effort demotion and page-pressure preemption;
  3. prefix-affinity routing: two prompt *families* (shared system
     prompts) over two replicas: the affinity hint keeps each family on
     the replica that already caches its prefix, beating round-robin's
     hit rate.

  PYTHONPATH=src python examples/torch_multi_replica.py             # card
  PYTHONPATH=src python examples/torch_multi_replica.py --device cpu \\
      --reduced
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.core import opt_perf_model
from repro_torch.core.perf_model import cpu_scale_perf_model
from repro_torch.core.request import simple_request
from repro_torch.core.router import (RoutingPolicy, make_real_cluster,
                                     make_slos_serve_cluster)
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.workload import bursty_arrivals, generate_workload
from repro_torch.device import generator, resolve_device
from repro_torch.models import init_params

ARCH = "smollm-135m"
VIRT = cpu_scale_perf_model()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (the CPU's size)")
    return ap.parse_args(argv)


def simulate(perf) -> dict:
    """Section 1: {n: the simulator's numbers} for one and four
    replicas."""
    out = {}
    for n in (1, 4):
        sim = make_slos_serve_cluster(n, perf)
        reqs = generate_workload("coder", 4.0 * n, 40.0, seed=7)
        res = sim.run(reqs)
        routed = sum(1 for r in res.records if r.hops > 0)
        print(f"{n} replica(s): {res.n_requests} reqs @ {4.0 * n:.0f}/s  "
              f"attainment={res.attainment:.2%}  routed={routed}  "
              f"best-effort={res.n_best_effort}  "
              f"preemptions={res.n_preemptions}")
        out[n] = {"n_requests": res.n_requests,
                  "attainment": res.attainment, "routed": routed,
                  "best_effort": res.n_best_effort,
                  "preemptions": res.n_preemptions}
    return out


def real_cluster(cfg, params, rng, device) -> dict:
    """Section 2: a bursty trace over two replicas and one page budget."""
    cluster = make_real_cluster(
        2, cfg, params, VIRT,
        policy=RoutingPolicy(max_hops=1),
        total_pages=32, replica_pages=16, page_size=4, max_slots=8,
        max_len=64,
        sched_cfg=SchedulerConfig(page_size=4, prefill_emits_first_token=True),
        device=device)
    times = bursty_arrivals(3.0, 6.0, rng, burst_factor=4.0, burst_frac=0.25,
                            period=6.0)
    for i, t in enumerate(times):
        cluster.submit(simple_request(
            i, float(t), prompt=int(rng.integers(14, 26)),
            output=int(rng.integers(8, 16)), ttft_slowdown=8.0, tpot=0.15))
    stats = cluster.run_until_idle()
    print(f"2 replicas: {stats.submitted} reqs (bursty)  "
          f"served={stats.served}  attained={stats.attained}  "
          f"routed={stats.routed}  best-effort={stats.best_effort}  "
          f"preemptions={stats.preempted}  tokens={stats.tokens_out}")
    assert cluster.budget.used == 0, "page budget must drain to zero"
    return {"submitted": stats.submitted, "served": stats.served,
            "attained": stats.attained, "routed": stats.routed,
            "best_effort": stats.best_effort, "preempted": stats.preempted,
            "tokens_out": stats.tokens_out,
            "budget_used_after": cluster.budget.used}


def run_families(cfg, params, families, prefix_affinity: bool,
                 device) -> dict:
    """Section 3: twelve requests of two prompt families, routed with or
    without the prefix-affinity hint."""
    cl = make_real_cluster(
        2, cfg, params, VIRT,
        policy=RoutingPolicy(max_hops=1, prefix_affinity=prefix_affinity),
        total_pages=64, replica_pages=32, page_size=4, max_slots=8,
        max_len=64,
        sched_cfg=SchedulerConfig(page_size=4,
                                  prefill_emits_first_token=True),
        device=device)
    frng = np.random.default_rng(11)
    for i in range(12):
        # random family per request: round-robin placement decorrelates
        # from the family, affinity re-correlates it
        fam = families[int(frng.integers(0, 2))]
        prompt = fam + frng.integers(1, cfg.vocab, 4).tolist()
        cl.submit(simple_request(i, 0.3 * i, prompt=len(prompt), output=6,
                                 ttft_slowdown=8.0, tpot=0.15),
                  prompt=prompt)
    st = cl.run_until_idle()
    hit_rate = st.prefix_hit_tokens / (12 * 24)
    per_rep = [d.engine.counters["prefix_hit_tokens"] for d in cl.drivers]
    mode = "affinity" if prefix_affinity else "round-robin"
    print(f"{mode:>11}: served={st.served}  "
          f"prefix_hit_tokens={st.prefix_hit_tokens} "
          f"(hit-rate {hit_rate:.0%} of prompt tokens)  "
          f"per-replica={per_rep}  affinity_routed={st.affinity_routed}")
    assert cl.budget.used == 0
    return {"served": st.served, "prefix_hit_tokens": st.prefix_hit_tokens,
            "per_replica": per_rep, "affinity_routed": st.affinity_routed,
            "budget_used_after": cl.budget.used}


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    perf = opt_perf_model(7e9)

    print("== virtualized cluster (event simulator, paper-scale lengths) ==")
    sim = simulate(perf)

    cfg = (get_reduced if args.reduced else get_config)(ARCH)
    print()
    print(f"== real cluster (2 port engine replicas of {cfg.name} on "
          f"{device}, token-by-token) ==")
    params = init_params(cfg, generator(device, 0), device=device)
    rng = np.random.default_rng(7)
    real = real_cluster(cfg, params, rng, device)

    print()
    print("== prefix-affinity routing (2 prompt families, 2 replicas) ==")
    families = [rng.integers(1, cfg.vocab, 20).tolist() for _ in range(2)]
    rr = run_families(cfg, params, families, False, device)
    aff = run_families(cfg, params, families, True, device)
    print(f"prefix-affinity serves "
          f"{aff['prefix_hit_tokens'] - rr['prefix_hit_tokens']} more "
          f"prompt tokens from cache than round-robin")
    return {"simulator": sim, "real": real, "round_robin": rr,
            "affinity": aff}


if __name__ == "__main__":
    main()
