"""The port's speculative decoding against the JAX engine on the same
bridged weights and the same planner batches.

* Streams and the ``spec_*`` counters of draft + verify cycles equal the
  JAX engine's.  On reduced smollm-135m with the 1-layer draft from seed 7
  that the reference's tests use (always rejected): the greedy stream, the
  progress guarantee, and a preempt/readmit replay that must equal the
  uninterrupted stream exactly.  On reduced qwen3-1.7b (qk-norm) with a
  perturbed copy of the target as the draft, accepted in part: rejection,
  rollback of both caches, the bonus token, then more cycles.
* The draft pool's size and its charge to a shared page budget equal the
  reference's, and the budget is conserved through a stream.
* The frontend on the reference demo's trace (three requests in two SLO
  tiers, a speculation-planning scheduler) serves the same requests with
  the same tokens, acceptance and planned draft lengths per step.

A stream difference counts as a fault unless the reference's top-2 logit
margin at the first differing token is below 1e-4 (a tie)."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as jcfgs                                   # noqa: E402
import repro.core.batch as jbatch                               # noqa: E402
import repro.core.perf_model as jperf                           # noqa: E402
import repro.core.request as jrequest                           # noqa: E402
import repro.core.scheduler as jsched                           # noqa: E402
import repro.core.slo as jslo                                   # noqa: E402
import repro.models as jmodels                                  # noqa: E402
import repro.serving.engine as jengine                          # noqa: E402
import repro.serving.frontend as jfront                         # noqa: E402
import repro.serving.kvcache as jkv                             # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_reduced                     # noqa: E402
import repro_torch.core.perf_model as tperf                     # noqa: E402
import repro_torch.core.request as trequest                     # noqa: E402
import repro_torch.core.scheduler as tsched                     # noqa: E402
import repro_torch.serving.frontend as tfront                   # noqa: E402
from repro_torch.core.batch import Batch                        # noqa: E402
from repro_torch.core.slo import StageKind                      # noqa: E402
from repro_torch.models import logits_fn, model_forward         # noqa: E402
from repro_torch.serving.engine import (EngineConfig,           # noqa: E402
                                        ServingEngine)
from repro_torch.serving.kvcache import SharedPageBudget        # noqa: E402

ARCH = "smollm-135m"
NEAR_ARCH = "qwen3-1.7b"        # the partial-accept scenario's model
ECFG = dict(max_slots=4, max_len=128, total_pages=64)
DEMO_ECFG = dict(max_slots=4, max_len=128, page_size=16, total_pages=96)
TIE_MARGIN = 1e-4
NOISE = 0.02            # relative perturbation of the partial-accept draft
SPEC = ("spec_draft_calls", "spec_verify_calls", "spec_accepted_tokens",
        "spec_drafted_tokens", "decode_calls", "decode_tokens",
        "prefill_calls")

P_NAIVE = np.random.default_rng(2).integers(0, 512, 16).tolist()
P_PREEMPT = np.random.default_rng(6).integers(0, 512, 16).tolist()
P_PROGRESS = list(range(1, 13))
P_ROLLBACK = np.random.default_rng(3).integers(1, 512, 21).tolist()


# ------------------------------ scenarios ------------------------------ #
# Each runs one request on an engine of either package; ``ns`` supplies
# the package's Batch class and StageKind.
def _prefill(eng, ns, rid, prompt):
    assert eng.add_request(rid, prompt, expected_total=64)
    b = ns.Batch()
    b.add(rid, ns.PREFILL, len(prompt))
    return eng.execute(b).get(rid, [])


def _spec(eng, ns, rid, k, rounds=None, until=None, got=None):
    got = [] if got is None else got
    n = 0
    while (rounds is not None and n < rounds) or \
            (until is not None and len(got) < until):
        b = ns.Batch(spec_step=k)
        b.add(rid, ns.DECODE, k + 1)
        out = eng.execute(b).get(rid, [])
        assert len(out) >= 1                  # progress guarantee
        got += out
        n += 1
    return got


def scenario_naive(eng, ns, rid=1):
    return _spec(eng, ns, rid, 3, until=11,
                 got=_prefill(eng, ns, rid, P_NAIVE))


def scenario_progress(eng, ns, rid=1):
    return _spec(eng, ns, rid, 4, rounds=4,
                 got=_prefill(eng, ns, rid, P_PROGRESS))


def scenario_preempt_ref(eng, ns, rid=1):
    return _spec(eng, ns, rid, 3, rounds=5,
                 got=_prefill(eng, ns, rid, P_PREEMPT))


def scenario_rollback(eng, ns, rid=1):
    """Draft lengths 3, 1, 5 and 8 in turn: partial acceptance rolls back
    both caches mid-window, and the next cycle overwrites the stale rows."""
    got = _prefill(eng, ns, rid, P_ROLLBACK)
    for k in (3, 1, 5, 8, 3, 5):
        got = _spec(eng, ns, rid, k, rounds=1, got=got)
    return got


class _NS:
    def __init__(self, batch_cls, kind):
        self.Batch = batch_cls
        self.PREFILL, self.DECODE = kind.PREFILL, kind.DECODE


JNS = _NS(jbatch.Batch, jslo.StageKind)
TNS = _NS(Batch, StageKind)


def _draft_cfg(cfg):
    return dataclasses.replace(cfg, name=cfg.name + "-draft", n_layers=1,
                               block_pattern=("attn",))


def _perturbed(tree):
    rng = np.random.default_rng(11)
    return jax.tree.map(
        lambda a: (a + NOISE * np.std(a) * rng.standard_normal(a.shape)
                   ).astype(a.dtype) if a.ndim >= 2 else a, tree)


# the reference init jitted: one compile for the whole tree instead of one
# per eager op (seconds per model); its values agree with the eager init's
# to an ulp, and both sides of every comparison get the same numbers
_jax_init = jax.jit(jmodels.init_params, static_argnums=(1,))


def _init(jcfg, seed):
    return jax.tree.map(np.asarray,
                        _jax_init(jax.random.PRNGKey(seed), jcfg))


@pytest.fixture(scope="module")
def ref():
    """JAX weights as numpy (smollm target and 1-layer draft, qwen3 target
    and its perturbed copy) and the JAX engine's streams and counter
    deltas per scenario, all on one engine per draft."""
    jcfg = jcfgs.get_reduced(ARCH)
    tgt = _init(jcfg, 0)
    dft = _init(_draft_cfg(jcfg), 7)
    qcfg = jcfgs.get_reduced(NEAR_ARCH)
    qtgt = _init(qcfg, 0)
    near = _perturbed(qtgt)
    out = {ARCH: (jcfg, tgt), NEAR_ARCH: (qcfg, qtgt), "dft": dft,
           "near": near}
    eng = jengine.ServingEngine(jcfg, tgt, jengine.EngineConfig(**ECFG),
                                draft=(_draft_cfg(jcfg), dft))
    for rid, fn in enumerate((scenario_naive, scenario_progress,
                              scenario_preempt_ref), 1):
        c0 = dict(eng.counters)
        stream = fn(eng, JNS, rid)
        eng.finish(rid)
        out[fn.__name__] = (stream, {k: eng.counters[k] - c0[k]
                                     for k in SPEC})
    eng = jengine.ServingEngine(qcfg, qtgt, jengine.EngineConfig(**ECFG),
                                draft=(qcfg, near))
    stream = scenario_rollback(eng, JNS)
    out["scenario_rollback"] = (stream, {k: eng.counters[k] for k in SPEC})
    return out


def _port(ref, draft="dft", ecfg=ECFG, kv_budget=None):
    """A port engine on a bridged target and draft: the smollm target with
    the 1-layer draft, or the qwen3 target with its perturbed copy."""
    arch = ARCH if draft == "dft" else NEAR_ARCH
    cfg = get_reduced(arch)
    p = bridge.params_from_numpy(ref[arch][1], device="cpu")
    dcfg = _draft_cfg(cfg) if draft == "dft" else cfg
    d = bridge.params_from_numpy(ref[draft], device="cpu")
    return ServingEngine(cfg, p, EngineConfig(**ecfg), draft=(dcfg, d),
                         kv_budget=kv_budget, device="cpu")


def _assert_stream(got, want, prompt, ref, arch=ARCH):
    if got == want:
        return
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    assert i < min(len(got), len(want)), (got, want)
    jcfg, jparams = ref[arch]
    h, _, _ = jmodels.model_forward(jparams, jcfg,
                                    jnp.asarray([prompt + want[:i]]))
    top = np.sort(np.asarray(jmodels.logits_fn(jparams, jcfg, h))[0, -1])
    margin = float(top[-1] - top[-2])
    assert margin < TIE_MARGIN, (
        f"stream differs at token {i} with reference margin {margin}: "
        f"{got} vs {want}")
    warnings.warn(f"tie at token {i} (reference top-2 margin {margin})")


def _check(ref, name, eng, got, prompt, arch=ARCH):
    want, counters = ref[name]
    _assert_stream(got, want, prompt, ref, arch)
    if got == want:
        for k in SPEC:
            assert eng.counters[k] == counters[k], k


def _greedy(eng, prompt, n):
    """Plain full-causal greedy generation of the port's target."""
    toks = list(prompt)
    for _ in range(n):
        h, _, _ = model_forward(eng.params, eng.cfg, torch.tensor([toks]))
        toks.append(int(torch.argmax(logits_fn(eng.params, eng.cfg,
                                               h[0, -1]))))
    return toks[len(prompt):]


# -------------------------------- tests -------------------------------- #
def test_spec_decode_matches_naive(ref):
    eng = _port(ref)
    got = scenario_naive(eng, TNS)
    _check(ref, "scenario_naive", eng, got, P_NAIVE)
    assert eng.counters["spec_verify_calls"] > 0
    assert got[:11] == _greedy(eng, P_NAIVE, 11)


def test_spec_decode_progress_guarantee(ref):
    """Even with a useless draft, every verify emits at least one token."""
    eng = _port(ref)
    got = scenario_progress(eng, TNS)
    _check(ref, "scenario_progress", eng, got, P_PROGRESS)
    assert eng.counters["spec_accepted_tokens"] == 0


def test_spec_decode_rollback_parity(ref):
    """A draft that agrees in part: accepted prefixes, rejections and the
    bonus token, each followed by more cycles over the stale rows."""
    eng = _port(ref, draft="near")
    got = scenario_rollback(eng, TNS)
    _check(ref, "scenario_rollback", eng, got, P_ROLLBACK, NEAR_ARCH)
    c = eng.counters
    assert 0 < c["spec_accepted_tokens"] < c["spec_drafted_tokens"]
    assert got == _greedy(eng, P_ROLLBACK, len(got))
    # every verify went through the verify kernel's entry point, once per
    # layer; the unfused verify path does not exist in the port
    assert c["verify_fused_ops"] == eng.cfg.n_layers * c["spec_verify_calls"]
    assert c["verify_scatter_ops"] == c["verify_attn_ops"] == 0


def test_spec_decode_preempt_replays_bit_identical(ref):
    """Preempted after two cycles, the request replays its recompute
    prefill, the draft cache re-syncs from scratch, and the stream equals
    the uninterrupted one exactly."""
    want = scenario_preempt_ref(_port(ref), TNS)
    _assert_stream(want, ref["scenario_preempt_ref"][0], P_PREEMPT, ref)
    eng = _port(ref)
    got = _spec(eng, TNS, 1, 3, rounds=2,
                got=_prefill(eng, TNS, 1, P_PREEMPT))
    n_before = len(got)
    assert eng.preempt(1) > 0
    assert eng.kv.used_pages == 0 and eng.spec.kv.used_pages == 0
    ctx = eng.reqs[1]
    assert eng.readmit(1, len(ctx.pending) + 16)
    while ctx.pending:                        # recompute: no emission
        b = Batch()
        b.add(1, StageKind.PREFILL, min(len(ctx.pending), 64))
        assert eng.execute(b).get(1, []) == []
    got = _spec(eng, TNS, 1, 3, rounds=3, got=got)
    assert len(got) > n_before
    n = min(len(got), len(want))
    assert got[:n] == want[:n]


def _jax_budget_engine(ref, pages):
    jcfg, jparams = ref[ARCH]
    budget = jkv.SharedPageBudget(pages)
    eng = jengine.ServingEngine(jcfg, jparams, jengine.EngineConfig(**ECFG),
                                draft=(_draft_cfg(jcfg), ref["dft"]),
                                kv_budget=budget)
    return eng, budget


def test_spec_decoder_draft_pool_budget_accounting(ref):
    """The draft pool is right-sized and charged to the shared budget in
    target-page equivalents, as the reference's; the budget is conserved
    through a spec-decoded stream."""
    jeng, _ = _jax_budget_engine(ref, 256)
    budget = SharedPageBudget(256)
    eng = _port(ref, kv_budget=budget)
    spec = eng.spec
    assert spec.budget_pages == jeng.spec.budget_pages > 0
    assert spec.kv.total_pages == jeng.spec.kv.total_pages

    def conserved():
        assert budget.used == eng.kv.used_pages + spec.budget_pages
    conserved()
    _prefill(eng, TNS, 1, list(range(1, 17)))
    conserved()
    _spec(eng, TNS, 1, 3, rounds=2)
    conserved()
    eng.finish(1)
    conserved()
    assert eng.kv.used_pages == 0 and spec.kv.used_pages == 0


def test_spec_decoder_pool_shrinks_under_budget_pressure(ref):
    """A nearly exhausted shared budget shrinks the draft pool, as the
    reference's does, and never overdraws."""
    jeng, jbudget = _jax_budget_engine(ref, 8)
    budget = SharedPageBudget(8)
    eng = _port(ref, kv_budget=budget)
    assert eng.spec.budget_pages == jeng.spec.budget_pages <= 8
    assert eng.spec.kv.total_pages == jeng.spec.kv.total_pages < 32
    assert budget.used == jbudget.used == eng.spec.budget_pages


# ------------------------------ frontend ------------------------------- #
TIGHT, LOOSE = 0.0125, 0.1


def _demo(mods, eng):
    """The reference demo's trace (examples/spec_decode_demo.py): three
    requests, two tight-TPOT and one loose, with a speculation-planning
    scheduler; returns the frontend and the planned draft lengths and
    acceptance totals after each step."""
    perf_model, request, sched_mod, front = mods
    sched = sched_mod.SLOsServeScheduler(
        perf_model.opt_perf_model(7e9, spec=True),
        sched_mod.SchedulerConfig(page_size=16, prefill_emits_first_token=True,
                                  spec_alpha=0.7))
    fe = front.ServingFrontend(eng, sched)
    assert sched.estimator is not None       # the draft arms the planner
    rng = np.random.default_rng(0)
    for rid, tpot in enumerate([TIGHT, TIGHT, LOOSE]):
        req = request.simple_request(rid, 0.0, prompt=48, output=40,
                                     ttft_slowdown=8.0, tpot=tpot)
        fe.submit(req, prompt=rng.integers(1, eng.cfg.vocab, 48).tolist())
    steps = []
    while not fe.idle and len(steps) < 40:
        fe.step()
        plan = sched.last_spec_plan
        steps.append((tuple(plan[1]) if plan and plan[1] else None,
                      eng.counters["spec_accepted_tokens"],
                      eng.counters["spec_drafted_tokens"]))
    return fe, steps


def test_spec_frontend_matches_jax_demo(ref):
    jcfg, jparams = ref[ARCH]
    jeng = jengine.ServingEngine(jcfg, jparams,
                                 jengine.EngineConfig(**DEMO_ECFG),
                                 draft=(_draft_cfg(jcfg), ref["dft"]))
    jfe, jsteps = _demo((jperf, jrequest, jsched, jfront), jeng)
    eng = _port(ref, ecfg=DEMO_ECFG)
    fe, steps = _demo((tperf, trequest, tsched, tfront), eng)
    assert fe.stats.served == jfe.stats.served == 3
    assert fe.stats.tokens_out == jfe.stats.tokens_out
    assert steps == jsteps
    assert eng.counters["spec_verify_calls"] > 0
    for key in SPEC:
        assert eng.counters[key] == jeng.counters[key], key
