"""The port's KV host spill tier against the JAX package's
(``tests/test_kv_spill.py``): the same sequence of admissions, releases
and evictions on a port manager and a JAX manager, both over the same
seeded page contents, leaves equal counters, indexes and page tables;
an evicted chain spills and its prefetch restores the page contents bit
for bit; ``probe_prefix`` equals what ``admit`` delivers under a starved
budget; chain export and install are idempotent and never leave a chain
in both indexes; in the engine a prefetch is queued at admission and
flushed inside ``execute()``, and greedy streams are bit-identical with
the tier on and off (and equal the JAX engine's)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as jcfgs                                   # noqa: E402
import repro.core.batch as jbatch                               # noqa: E402
import repro.core.slo as jslo                                   # noqa: E402
import repro.models as jmodels                                  # noqa: E402
import repro.serving.engine as jengine                          # noqa: E402
import repro.serving.kvcache as jkv                             # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.core.batch import Batch                        # noqa: E402
from repro_torch.core.slo import StageKind                      # noqa: E402
from repro_torch.serving.engine import (EngineConfig,           # noqa: E402
                                        ServingEngine)
from repro_torch.serving.kvcache import (PagedKVManager,        # noqa: E402
                                         kv_page_bytes)

ARCH = "smollm-135m"
PAGE = 4
KV = dict(total_pages=8, page_size=PAGE, max_seqs=4, max_len=64,
          share_prefix=True, host_spill_pages=16)
COUNTERS = ("spilled_pages", "prefetched_pages", "host_evictions",
            "spilled_hit_tokens", "prefetch_flushes", "prefix_evictions",
            "pages_grabbed", "host_used", "cow_copies", "partial_head_copies",
            "partial_hit_tokens", "chain_hits")


def _pair(seed=0, **over):
    """A JAX manager and a port manager over the same seeded pools."""
    kw = {**KV, **over}
    jm = jkv.PagedKVManager(jcfgs.get_reduced(ARCH), **kw)
    rng = np.random.default_rng(seed)
    jm.pools = jax.tree.map(
        lambda a: jax.numpy.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), jm.pools)
    tm = PagedKVManager(get_reduced(ARCH), device="cpu", **kw)
    tm.pools = bridge.pools_from_numpy(jax.tree.map(np.asarray, jm.pools),
                                       device="cpu")
    return jm, tm


def _same_state(jm, tm):
    for name in COUNTERS:
        assert getattr(tm, name) == getattr(jm, name), name
    assert tm.prefix_index == jm.prefix_index
    assert list(tm.host_index) == list(jm.host_index)
    assert tm.tables == jm.tables
    assert list(tm.cached) == list(jm.cached)
    assert not set(tm.prefix_index) & set(tm.host_index)
    assert tm.host_used == len(tm.host_index) <= tm.host_spill_pages
    pools = bridge.pools_to_numpy(tm.pools)
    for a, b in zip(jax.tree.leaves(pools), jax.tree.leaves(jm.pools)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _host(data):
    """A ``_page_to_host`` result as numpy leaves (either package)."""
    return [np.asarray(x) for x in jax.tree.leaves(
        data, is_leaf=lambda t: isinstance(t, torch.Tensor))]


def _both(jm, tm, fn):
    out = fn(jm), fn(tm)
    assert out[0] == out[1]
    return out[1]


def _publish(m, rid, tokens):
    assert m.admit(rid, len(tokens), tokens=tokens)
    m.seq_len[m.seq_of[rid]] = len(tokens)
    m.register_prefix(rid, tokens)


def test_forced_eviction_spills_then_prefetch_restores_content():
    base = list(range(100, 120))                       # 5 full pages
    jm, tm = _pair()
    for m in (jm, tm):
        _publish(m, 1, base + [777])
    chain = list(tm.tables[1][:5])
    keys = [tm.page_key[p] for p in chain]
    snaps = [_host(tm._page_to_host(p)) for p in chain]
    for m in (jm, tm):
        m.release(1)
        assert m.admit(2, 8 * PAGE)                    # drains the pool
    assert tm.spilled_pages == 5
    assert not tm.prefix_index                         # never both tiers
    for key, snap in zip(keys, snaps):
        assert [a.tobytes() for a in _host(tm.host_index[key].data)] == \
            [a.tobytes() for a in snap]
    _same_state(jm, tm)
    for m in (jm, tm):
        m.release(2)
    fresh = base + [888]
    assert _both(jm, tm, lambda m: m.probe_prefix(fresh)) == 5 * PAGE
    for m in (jm, tm):
        assert m.admit(3, len(fresh), tokens=fresh)
        assert m.length(3) == 5 * PAGE                 # probe == delivered
        assert m.prefetched_pages == 5 and m.prefetch_flushes == 0
    # the pool still holds the other request's bytes until the flush
    assert _both(jm, tm, lambda m: m.flush_prefetch()) == 5
    for i, p in enumerate(tm.tables[3][:5]):
        assert [a.tobytes() for a in _host(tm._page_to_host(p))] == \
            [a.tobytes() for a in snaps[i]], i
    assert tm.host_used == 0
    _same_state(jm, tm)


def test_probe_matches_delivery_under_starved_budget():
    tokens = list(range(200, 220))
    jm, tm = _pair(seed=1)
    for m in (jm, tm):
        _publish(m, 1, tokens)
        m.release(1)
        assert m.admit(2, 8 * PAGE)                    # spill all 5
        m.release(2)
        assert m.admit(9, 6 * PAGE)                    # 2 pages grabbable
    hit = _both(jm, tm, lambda m: m.probe_prefix(tokens))
    assert hit == 2 * PAGE
    assert _both(jm, tm, lambda m: m.prefix_discounts(tokens)) == (8, 0, 2)
    for m in (jm, tm):
        assert m.admit(3, hit, tokens=tokens)
        assert m.length(3) == hit
    assert tm.prefetched_pages == 2
    _both(jm, tm, lambda m: m.flush_prefetch())
    _same_state(jm, tm)


def test_spill_of_a_queued_prefetch_uses_the_queued_copy():
    """A prefetched page evicted before its flush spills from the queued
    host copy (its device page does not hold the bytes yet); the re-grab
    drops the stale queued copy."""
    tokens = list(range(300, 312))                     # 3 pages
    jm, tm = _pair(seed=2, total_pages=4)
    for m in (jm, tm):
        _publish(m, 1, tokens + [5])
        m.release(1)
        assert m.admit(2, 4 * PAGE)                    # spill 3
        m.release(2)
        assert m.admit(3, 3 * PAGE + 1, tokens=tokens + [6])  # prefetch
        assert len(m._pending_prefetch) == 3
        m.release(3)                                   # still queued
        assert m.admit(4, 4 * PAGE)                    # re-spill them
        assert not m._pending_prefetch
    assert tm.spilled_pages == 6
    _same_state(jm, tm)
    for m in (jm, tm):
        m.release(4)
        assert m.admit(5, 3 * PAGE + 1, tokens=tokens + [7])
        m.flush_prefetch()
    _same_state(jm, tm)


def test_export_install_idempotent_and_never_both_indexes():
    tokens = list(range(400, 424))                     # 6 pages
    (ja, ta), (jb, tb) = _pair(seed=3), _pair(seed=4)
    jc, tc = _pair(seed=5, host_spill_pages=4)
    for m in (ja, ta):
        _publish(m, 1, tokens + [1])
        m.release(1)
    roots = _both(ja, ta, lambda m: m.root_chains())
    assert len(roots) == 1
    chains = {m: m.export_chain(roots[0]) for m in (ja, ta)}
    assert [e[:3] for e in chains[ja]] == [e[:3] for e in chains[ta]]
    for (_, _, _, jd), (_, _, _, td) in zip(chains[ja], chains[ta]):
        assert [a.tobytes() for a in _host(jd)] == \
            [a.tobytes() for a in _host(td)]
    assert len(chains[ta]) == 6

    def install(dst, src):
        return _both(*dst, lambda m: m.install_host_chain(
            chains[src[0] if m is dst[0] else src[1]]))
    assert install((jb, tb), (ja, ta)) == 6
    assert install((jb, tb), (ja, ta)) == 0            # idempotent
    assert install((ja, ta), (ja, ta)) == 0            # all device-resident
    assert _both(jb, tb, lambda m: m.probe_prefix(tokens + [2])) == 24
    # a 4-page host tier keeps the chain's last 4 pages (LRU)
    assert install((jc, tc), (ja, ta)) == 6
    assert tc.host_evictions == 2 and tc.host_used == 4
    assert _both(jc, tc, lambda m: m.probe_prefix(tokens + [2])) == 0
    for pair in ((ja, ta), (jb, tb), (jc, tc)):
        _same_state(*pair)
    # spill tier off: installs decline
    off = PagedKVManager(get_reduced(ARCH), device="cpu",
                         **{**KV, "host_spill_pages": 0})
    assert off.install_host_chain(chains[ta]) == 0


def test_prefetch_seconds_scales_with_pages_and_link():
    cfg = get_reduced(ARCH)
    slow = PagedKVManager(cfg, device="cpu", **{**KV, "h2d_gbps": 1.0})
    fast = PagedKVManager(cfg, device="cpu", **{**KV, "h2d_gbps": 64.0})
    assert slow.prefetch_seconds(6) == pytest.approx(
        6 * kv_page_bytes(cfg, PAGE) / 1e9)
    assert slow.prefetch_seconds(6) > fast.prefetch_seconds(6) \
        > fast.prefetch_seconds(0) == 0.0
    jm = jkv.PagedKVManager(jcfgs.get_reduced(ARCH), **KV)
    assert PagedKVManager(cfg, device="cpu", **KV).prefetch_seconds(3) \
        == jm.prefetch_seconds(3)


# ------------------------------- engine --------------------------------- #
@pytest.fixture(scope="module")
def weights():
    jcfg = jcfgs.get_reduced(ARCH)
    jparams = jax.jit(jmodels.init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return jcfg, jparams, tparams


def toks(scen, *vals):
    return [1 + scen * 80 + v for v in vals]


PROMPT = toks(3, *range(16))
FILLER = toks(4, *range(32))
ENGINE = dict(max_slots=6, max_len=128, page_size=PAGE, total_pages=12)


def _serve(eng, B, K, rid, prompt, decode=4):
    assert eng.add_request(rid, prompt, expected_total=len(prompt) + 8)
    out = []
    if eng.reqs[rid].pending:
        b = B()
        b.add(rid, K.PREFILL, len(eng.reqs[rid].pending))
        out += eng.execute(b).get(rid, [])
    for _ in range(decode):
        b = B()
        b.add(rid, K.DECODE, 1)
        out += eng.execute(b).get(rid, [])
    eng.finish(rid)
    return out


def _deferred_run(eng, B, K):
    """Serve PROMPT, evict its chain by a filler, then admit PROMPT again:
    the prefetch is queued at admission and flushed by ``execute()``."""
    first = _serve(eng, B, K, 1, PROMPT)
    _serve(eng, B, K, 2, FILLER, decode=0)
    assert eng.kv.spilled_pages >= 2 and eng.kv.prefetch_flushes == 0
    assert eng.add_request(3, PROMPT, expected_total=len(PROMPT) + 8)
    assert eng.kv._pending_prefetch and eng.kv.prefetch_flushes == 0
    b = B()
    b.add(3, K.PREFILL, len(eng.reqs[3].pending))
    out = eng.execute(b).get(3, [])
    assert eng.kv.prefetch_flushes == 1 and not eng.kv._pending_prefetch
    for _ in range(4):
        b = B()
        b.add(3, K.DECODE, 1)
        out += eng.execute(b).get(3, [])
    eng.finish(3)
    return first, out


def test_prefetch_deferred_from_admit_and_flushed_inside_execute(weights):
    jcfg, jparams, tparams = weights
    jeng = jengine.ServingEngine(jcfg, jparams, jengine.EngineConfig(
        host_spill_pages=32, **ENGINE))
    want = _deferred_run(jeng, jbatch.Batch, jslo.StageKind)
    eng = ServingEngine(get_reduced(ARCH), tparams,
                        EngineConfig(host_spill_pages=32, **ENGINE),
                        device="cpu")
    got = _deferred_run(eng, Batch, StageKind)
    assert got[1] == got[0]                    # bit-identical greedy stream
    assert got == want
    for name in COUNTERS:
        assert getattr(eng.kv, name) == getattr(jeng.kv, name), name


def test_streams_bit_identical_with_spill_on_and_off(weights):
    """Two passes over prompt families sharing prefixes (the second pass
    re-sends every prompt): streams are equal on a roomy pool, an
    undersized pool with the tier off and one with it on, and the tier-on
    engine spilled and prefetched along the way."""
    _, _, tparams = weights
    fams = [toks(s, *range(9 + 2 * s)) for s in range(4)]
    prompts = [f + toks(s, *range(40 + r, 46 + r))
               for s, f in enumerate(fams) for r in (0, 20)]
    variants = {"big": dict(total_pages=128, host_spill_pages=0),
                "small-off": dict(total_pages=20, host_spill_pages=0),
                "small-on": dict(total_pages=20, host_spill_pages=64)}
    results = {}
    for name, over in variants.items():
        eng = ServingEngine(get_reduced(ARCH), tparams, EngineConfig(
            **{**ENGINE, **over}), device="cpu")
        results[name] = [_serve(eng, Batch, StageKind, 10 * p + i, pr, 3)
                         for p in range(2) for i, pr in enumerate(prompts)]
        if name == "small-on":
            assert eng.kv.spilled_pages > 0 and eng.kv.prefetched_pages > 0
            assert eng.kv.spilled_hit_tokens > 0
        if name == "small-off":
            assert eng.kv.spilled_pages == 0 and eng.kv.prefix_evictions > 0
    assert results["small-off"] == results["big"]
    assert results["small-on"] == results["big"]
