"""The port's serving frontend and launcher against the JAX ones: the same
chatbot trace (five requests, lengths at time_scale 0.02) replayed on
smollm-135m-reduced with the same virtual-time perf model gives equal
served / attained / dropped / tokens_out counts and engine call counts.
The control plane runs in virtual time, so the counts must match exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as jcfgs                                   # noqa: E402
import repro.core.perf_model as jperf                           # noqa: E402
import repro.core.scheduler as jsched                           # noqa: E402
import repro.core.workload as jwork                             # noqa: E402
import repro.models as jmodels                                  # noqa: E402
import repro.serving.engine as jengine                          # noqa: E402
import repro.serving.frontend as jfront                         # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.launch import serve                            # noqa: E402

ARGV = ["--reduced", "--device", "cpu", "--max-requests", "5",
        "--duration", "4", "--seed", "3"]
COUNTERS = ("prefill_calls", "decode_calls", "decode_tokens")


def _jax_replay(args):
    """What ``repro.launch.serve.main`` does, returning the frontend."""
    cfg = jcfgs.get_reduced(args.arch)
    params = jmodels.init_params(jax.random.PRNGKey(args.seed), cfg)
    eng = jengine.ServingEngine(cfg, params, jengine.EngineConfig(
        max_slots=8, max_len=256, total_pages=256))
    sched = jsched.SLOsServeScheduler(jperf.cpu_scale_perf_model(),
                                      jsched.SchedulerConfig(
                                          prefill_emits_first_token=True))
    fe = jfront.ServingFrontend(eng, sched, seed=args.seed)
    reqs = jwork.generate_workload(args.scenario, args.rate, args.duration,
                                   args.seed)[:args.max_requests]
    for r in reqs:
        for i, s in enumerate(r.stages):
            r.stages[i] = type(s)(s.slo, max(4, int(s.length
                                                    * args.time_scale)))
        fe.submit(r)
    fe.run_until_idle()
    return fe, params


def test_launcher_counts_match_jax(monkeypatch):
    args = serve.parse_args(ARGV)
    jfe, jparams = _jax_replay(args)
    # same weights as the reference (the counts do not depend on them, the
    # streams do): bridge them in place of the port's seeded init
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    monkeypatch.setattr(serve, "init_params", lambda *a, **k: tparams)
    fe, eng = serve.build(args)
    serve.replay(fe)
    assert 4 <= fe.stats.submitted <= 5
    for key in ("submitted", "served", "attained", "dropped", "tokens_out"):
        assert getattr(fe.stats, key) == getattr(jfe.stats, key), key
    assert fe.stats.tokens_out > 0
    for key in COUNTERS:
        assert eng.counters[key] == jfe.engine.counters[key], key
    assert fe.clock == pytest.approx(jfe.clock)


def test_layers_option_cuts_depth_not_the_schedule():
    """``--layers N`` serves the config's first N layers at its widths, and
    the replay's counts do not move: the planner's virtual clock and the
    page counts, not the depth, set the schedule."""
    full = serve.parse_args(ARGV)
    cut = serve.parse_args(ARGV + ["--layers", "1"])
    fe_full, eng_full = serve.build(full)
    fe_cut, eng_cut = serve.build(cut)
    assert eng_full.cfg.n_layers > 1
    assert eng_cut.cfg.n_layers == len(eng_cut.cfg.block_pattern) == 1
    assert eng_cut.cfg.block_pattern == eng_full.cfg.block_pattern[:1]
    for key in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                "vocab"):
        assert getattr(eng_cut.cfg, key) == getattr(eng_full.cfg, key), key
    serve.replay(fe_full)
    serve.replay(fe_cut)
    for key in ("submitted", "served", "attained", "dropped", "tokens_out"):
        assert getattr(fe_cut.stats, key) == getattr(fe_full.stats, key), key
    for key in COUNTERS:
        assert eng_cut.counters[key] == eng_full.counters[key], key
    assert fe_cut.clock == pytest.approx(fe_full.clock)
    with pytest.raises(ValueError):
        serve.model_config(serve.parse_args(ARGV + ["--layers", "0"]))
