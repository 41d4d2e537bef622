"""The engine's prefix options against the reference on bridged weights:
the environment defaults of ``EngineConfig``, page-granular prefix
matching (``token_level_prefix=False``, ``PagedKVManager(token_level=
False)``), prefix-aware admission in the frontend, and a cluster built
with ``token_level_prefix=False``.

The manager scenarios are those of ``tests/test_prefix_token_level.py``
(six request programs whose prompts diverge mid-page), driven through
one engine of each package: probe hits, block tables, hit tokens, CoW
copies and streams must be equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as jcfgs                                   # noqa: E402
import repro.core.batch as jbatch                               # noqa: E402
import repro.core.perf_model as jperf                           # noqa: E402
import repro.core.request as jreq                               # noqa: E402
import repro.core.router as jrouter                             # noqa: E402
import repro.core.scheduler as jsched                           # noqa: E402
import repro.core.slo as jslo                                   # noqa: E402
import repro.models as jmodels                                  # noqa: E402
import repro.serving.engine as jengine                          # noqa: E402
import repro.serving.frontend as jfront                         # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.core import (batch, perf_model, request,       # noqa: E402
                              router, scheduler, slo)
from repro_torch.serving import engine, frontend                # noqa: E402

ARCH = "smollm-135m"
PAGE = 4
TIE_BREAK_KEYS = ("attained", "attainment")
ENV = ("REPRO_SHARE_PREFIX", "REPRO_TOKEN_LEVEL_PREFIX", "REPRO_HOST_SPILL",
       "REPRO_HOST_SPILL_PAGES")

_jax_init = jax.jit(jmodels.init_params, static_argnums=(1,))


class Side:
    """One package's engine, frontend and cluster entry points."""

    def __init__(self, E, F, B, S, R, Rq, Sch, P, cfg, params, **dev):
        self.E, self.F, self.B, self.S = E, F, B, S
        self.R, self.Rq, self.Sch = R, Rq, Sch
        self.perf = P.cpu_scale_perf_model()
        self.cfg, self.params, self.dev = cfg, params, dev

    def engine(self, **kw):
        return self.E.ServingEngine(self.cfg, self.params,
                                    self.E.EngineConfig(**kw), **self.dev)


@pytest.fixture(scope="module")
def sides():
    jcfg = jcfgs.get_reduced(ARCH)
    jparams = _jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return (Side(jengine, jfront, jbatch, jslo, jrouter, jreq, jsched, jperf,
                 jcfg, jparams),
            Side(engine, frontend, batch, slo, router, request, scheduler,
                 perf_model, get_reduced(ARCH), tparams, device="cpu"))


# ------------------------- environment defaults ------------------------- #
@pytest.mark.parametrize("env", [
    {},
    {"REPRO_SHARE_PREFIX": "0", "REPRO_TOKEN_LEVEL_PREFIX": "off"},
    {"REPRO_SHARE_PREFIX": "1", "REPRO_TOKEN_LEVEL_PREFIX": "false"},
    {"REPRO_HOST_SPILL": "1"},
    {"REPRO_HOST_SPILL": "on", "REPRO_HOST_SPILL_PAGES": "12"},
    {"REPRO_HOST_SPILL": "0", "REPRO_HOST_SPILL_PAGES": "40"},
])
def test_engine_config_env_defaults_match_reference(monkeypatch, env):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    fields = ("share_prefix", "token_level_prefix", "host_spill_pages",
              "prefix_aware_admission")
    got, want = engine.EngineConfig(), jengine.EngineConfig()
    assert ({f: getattr(got, f) for f in fields}
            == {f: getattr(want, f) for f in fields})
    # an explicit field wins over the environment, read per instantiation
    assert engine.EngineConfig(share_prefix=True).share_prefix is True
    assert engine.EngineConfig(host_spill_pages=3).host_spill_pages == 3
    monkeypatch.setenv("REPRO_TOKEN_LEVEL_PREFIX", "1")
    assert engine.EngineConfig().token_level_prefix is True


# ------------------- page-granular matching (manager) ------------------- #
def toks(scen, *vals):
    base = 1 + scen * 80
    return [base + v for v in vals]


def _two_share_then_diverge(scen, shared_len, uniq_len, decode):
    shared = toks(scen, *range(shared_len))
    r1 = shared + toks(scen, *range(40, 40 + uniq_len))
    r2 = shared + toks(scen, *range(60, 60 + uniq_len))
    return [("req", 0, r1), ("prefill", 0, len(r1)), ("decode", 0, decode),
            ("req", 1, r2), ("prefill", 1, len(r2)), ("decode", 1, decode)]


def _chatbot(scen):
    shared = toks(scen, *range(9))
    r1 = shared + toks(scen, *range(30, 36))
    r2 = shared + toks(scen, *range(50, 56))
    return [("req", 0, r1), ("prefill", 0, 7), ("prefill", 0, len(r1) - 7),
            ("decode", 0, 4),
            ("req", 1, r2), ("prefill", 1, len(r2)), ("decode", 1, 4)]


def _toolllm(scen):
    sys_p = toks(scen, *range(10))
    tool1 = toks(scen, *range(20, 27))
    tool2 = tool1[:3] + toks(scen, *range(70, 74))
    return [("req", 0, sys_p), ("prefill", 0, len(sys_p)), ("decode", 0, 2),
            ("extend", 0, tool1), ("prefill", 0, len(tool1)),
            ("decode", 0, 2),
            ("req", 1, sys_p[:6] + toks(scen, *range(40, 45))),
            ("prefill", 1, 11), ("decode", 1, 2),
            ("extend", 1, tool2), ("prefill", 1, len(tool2)),
            ("decode", 1, 2)]


def _agent(scen):
    stage1 = toks(scen, *range(11))
    stage2 = stage1 + toks(scen, *range(20, 26))
    stage3 = stage2[:14] + toks(scen, *range(60, 66))
    return [("req", 0, stage1), ("prefill", 0, len(stage1)),
            ("decode", 0, 2),
            ("req", 1, stage2), ("prefill", 1, len(stage2)),
            ("decode", 1, 2),
            ("req", 2, stage3), ("prefill", 2, len(stage3)),
            ("decode", 2, 2)]


# the six mixes of tests/test_prefix_token_level.py, in its sorted order
SCENARIOS = {
    "agent": _agent,
    "chatbot": _chatbot,
    "coder": lambda s: _two_share_then_diverge(s, 13, 6, 2),
    "reasoning": lambda s: _two_share_then_diverge(s, 5, 2, 6),
    "summarizer": lambda s: _two_share_then_diverge(s, 18, 4, 3),
    "toolllm": _toolllm,
}


def _run_scenarios(side, eng):
    """Every scenario program on one engine; the trace of probe hits,
    block tables and counters after each step, and the streams."""
    trace, streams = [], {}
    for si, name in enumerate(SCENARIOS):
        rids = []
        for kind, local, arg in SCENARIOS[name](si):
            rid = si * 10 + local
            if kind == "req":
                trace.append(("probe", rid, eng.kv.probe_prefix(list(arg))))
                assert eng.add_request(rid, list(arg),
                                       expected_total=len(arg) + 24)
                rids.append(rid)
                streams[rid] = []
            elif kind == "extend":
                eng.reqs[rid].pending.extend(arg)
            else:
                b = side.B.Batch()
                b.add(rid, side.S.StageKind.PREFILL if kind == "prefill"
                      else side.S.StageKind.DECODE, arg)
                streams[rid] += [int(t) for t in eng.execute(b).get(rid, [])]
            trace.append((rid, np.asarray(eng.kv.block_tables).tolist(),
                          int(eng.counters["prefix_hit_tokens"]),
                          int(eng.kv.cow_copies),
                          int(eng.kv.partial_hit_tokens)))
        for rid in rids:
            eng.finish(rid)
    return trace, streams


def test_page_granular_matching_matches_reference(sides):
    kw = dict(max_slots=6, max_len=128, page_size=PAGE, total_pages=128,
              share_prefix=True, token_level_prefix=False)
    jside, tside = sides
    want = _run_scenarios(jside, jside.engine(**kw))
    tok_eng = tside.engine(**kw)
    assert tok_eng.kv.token_level is False
    got = _run_scenarios(tside, tok_eng)
    assert got[0] == want[0]
    assert got[1] == want[1]
    # page-granular: hits, but no boundary-page head
    assert got[0][-1][2] > 0 and got[0][-1][4] == 0
    # the same programs with token-level matching hit strictly more, and
    # stream the same tokens
    token = _run_scenarios(tside, tside.engine(
        **{**kw, "token_level_prefix": True}))
    assert token[1] == got[1]
    assert token[0][-1][2] > got[0][-1][2]


def test_manager_page_granular_probe_matches_reference(sides):
    """Manager alone: a prompt diverging mid-page after two full pages hits
    8 tokens page-granular (11 token-level), on both packages."""
    import repro.serving.kvcache as jkv
    from repro_torch.serving.kvcache import PagedKVManager
    base = list(range(100, 116))
    div = base[:11] + [7, 8, 9]
    out = []
    for make in (jkv.PagedKVManager, PagedKVManager):
        hits = []
        for token_level in (False, True):
            kw = dict(total_pages=16, page_size=PAGE, max_seqs=4, max_len=64,
                      share_prefix=True, token_level=token_level)
            if make is PagedKVManager:
                kw["device"] = "cpu"
                kv = make(get_reduced(ARCH), **kw)
            else:
                kv = make(jcfgs.get_reduced(ARCH), **kw)
            assert kv.admit(1, len(base), tokens=base)
            kv.seq_len[kv.seq_of[1]] = len(base)
            kv.register_prefix(1, base)
            hits.append(kv.probe_prefix(div))
            assert kv.admit(2, len(div), tokens=div)
            hits.append((list(kv.tables[2]), int(kv.cow_copies),
                         int(kv.partial_hit_tokens)))
        out.append(hits)
    assert out[1] == out[0]
    assert out[1][0] == 8 and out[1][2] == 11


# ---------------------- prefix-aware admission -------------------------- #
def _frontend_run(side, prefix_aware):
    """Four requests over one 16-token prompt (two with a shared head and
    a different tail) into a 10-page pool: admissions under page
    pressure, with the reservation shaved by the probed hit or not."""
    eng = side.engine(max_slots=8, max_len=64, page_size=PAGE,
                      total_pages=10, share_prefix=True,
                      prefix_aware_admission=prefix_aware)
    fe = side.F.ServingFrontend(eng, side.Sch.SLOsServeScheduler(
        side.perf, side.Sch.SchedulerConfig(
            page_size=PAGE, prefill_emits_first_token=True)), seed=0)
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, 512, 16).tolist()
    prompts = {0: prompt, 1: prompt, 2: prompt[:12] + [3, 5, 7, 9],
               3: prompt}
    admitted, streams = [], {}
    add = eng.add_request

    def spy(rid, *a, **k):
        ok = add(rid, *a, **k)
        admitted.append((rid, bool(ok)))
        return ok
    eng.add_request = spy
    for rid, p in prompts.items():
        fe.submit(side.Rq.simple_request(rid, 0.05 * rid, prompt=16,
                                         output=16, ttft_slowdown=5.0,
                                         tpot=0.1),
                  prompt=list(p),
                  on_token=lambda r, t: streams.setdefault(r, []).extend(
                      int(x) for x in t))
    fe.run_until_idle()
    return (admitted, dataclasses.asdict(fe.stats), streams,
            int(eng.counters["prefix_hit_tokens"]))


def test_prefix_aware_admission_matches_reference(sides):
    jside, tside = sides
    want = _frontend_run(jside, True)
    got = _frontend_run(tside, True)
    assert got == want
    # under pressure: the pool cannot hold every request at once
    assert got[1]["dropped"] >= 1 or not all(ok for _, ok in got[0])
    assert got[3] > 0


@pytest.mark.parametrize("package", ["jax", "port"])
def test_prefix_aware_admission_flips_one_admission(sides, package):
    """The reference's ``test_prefix_aware_admission_flip`` on each
    package: a request whose prompt is resident is declined by the full
    reservation and admitted with the shaved one, its hit mapped, not
    re-prefilled."""
    side = sides[package == "port"]
    prompt = np.random.default_rng(9).integers(1, 512, 16).tolist()

    def admit_second(prefix_aware):
        eng = side.engine(max_slots=8, max_len=64, page_size=PAGE,
                          total_pages=10, share_prefix=True,
                          prefix_aware_admission=prefix_aware)
        drv = side.F.ReplicaDriver(eng, side.Sch.SLOsServeScheduler(
            side.perf, side.Sch.SchedulerConfig(page_size=PAGE)))
        assert eng.add_request(1, prompt, expected_total=20)
        b = side.B.Batch()
        b.add(1, side.S.StageKind.PREFILL, 16)
        eng.execute(b)
        r = side.Rq.simple_request(2, 0.0, prompt=16, output=16,
                                   ttft_slowdown=5.0, tpot=0.1)
        drv.prompts[r.rid] = prompt
        ok = drv._admit(r, 0.0)
        return ok, (eng.kv.length(2) if ok else None)

    assert admit_second(False) == (False, None)
    assert admit_second(True) == (True, 15)


# ------------------- a page-granular cluster ---------------------------- #
def test_cluster_page_granular_matches_reference(sides):
    out = []
    for side in sides:
        cl = side.R.make_real_cluster(
            2, side.cfg, side.params, side.perf,
            policy=side.R.RoutingPolicy(max_hops=1), total_pages=32,
            replica_pages=16, page_size=PAGE, max_slots=8, max_len=64,
            sched_cfg=side.Sch.SchedulerConfig(
                page_size=PAGE, prefill_emits_first_token=True),
            token_level_prefix=False, **side.dev)
        assert all(d.engine.kv.token_level is False for d in cl.drivers)
        rng = np.random.default_rng(4)
        system = rng.integers(1, 512, 14).tolist()
        streams = {}
        for rid in range(6):
            prompt = system + rng.integers(1, 512, 3 + rid).tolist()
            cl.submit(side.Rq.simple_request(
                rid, 0.02 * rid, prompt=len(prompt), output=6,
                ttft_slowdown=8.0, tpot=0.15), prompt=prompt,
                on_token=lambda r, t: streams.setdefault(r, []).extend(
                    int(x) for x in t))
        for _ in range(400):
            if cl.idle:
                break
            cl.step()
        out.append((cl.stats.as_dict(), streams))
    (want, wstreams), (got, gstreams) = out
    assert gstreams == wstreams
    assert set(got) == set(want)
    for k in want:
        if k not in TIE_BREAK_KEYS:
            assert got[k] == want[k], k
    assert got["prefix_hit_tokens"] > 0 and got["partial_hit_tokens"] == 0
    assert 0 <= got["attained"] <= got["served"] == 6
