"""The port's ServingEngine against the JAX engine on the same bridged
weights and the same planner batches: chunked prefill (the second chunk
starting mid-page), multi-request batched decode, a prefix-sharing hit
with a copy-on-write boundary page, sharing on and off, and a
preempt/readmit replay.

Greedy streams must be equal.  A difference counts as a fault unless the
reference's top-2 logit margin at the first differing step is below 1e-4;
that case is a tie (float32 sums in another order can flip an argmax
between two near-equal logits) and is reported as a warning.  Inside the
port, the preempted replay must equal the uninterrupted run exactly."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as jcfgs                                   # noqa: E402
import repro.core.batch as jbatch                               # noqa: E402
import repro.core.slo as jslo                                   # noqa: E402
import repro.models as jmodels                                  # noqa: E402
import repro.serving.engine as jengine                          # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.core.batch import Batch                        # noqa: E402
from repro_torch.core.slo import StageKind                      # noqa: E402
from repro_torch.serving.engine import (EngineConfig,           # noqa: E402
                                        ServingEngine)

TIE_MARGIN = 1e-4
ECFG = dict(max_slots=4, max_len=128, total_pages=64)
ARCH = "smollm-135m"

rng = np.random.default_rng(0)
P1 = rng.integers(1, 512, 34).tolist()               # two full pages
P2 = P1[:20] + rng.integers(1, 512, 8).tolist()      # page + 4-token head
P3 = P1[:32]             # hit capped at 31: its write CoWs a shared page

# (rid, kind, n) entries per batch; "P"/"D" = prefill/decode
SCRIPT = [
    [(1, "P", 10)], [(1, "P", 24)],                  # mid-page 2nd chunk
    [(1, "D", 1)], [(1, "D", 1)], [(1, "D", 5)],
    "admit 2 3",                                     # prefix hit + CoW head
    [(2, "P", 28), (3, "P", 32)],
    [(1, "D", 2), (2, "D", 2), (3, "D", 2)],
    [(1, "D", 3), (2, "D", 3), (3, "D", 3)],
]
PREEMPT_AT = 7          # replay run: preempt rid 2 before this batch


def _run(eng, batch_cls, kinds, preempt=False):
    """Drive an engine through SCRIPT; returns {rid: stream}."""
    streams = {1: [], 2: [], 3: []}
    assert eng.add_request(1, P1, expected_total=48)
    for i, step in enumerate(SCRIPT):
        if step == "admit 2 3":
            assert eng.add_request(2, P2, expected_total=48)
            assert eng.add_request(3, P3, expected_total=48)
            continue
        if preempt and i == PREEMPT_AT:
            assert eng.preempt(2) > 0
            assert eng.readmit(2, len(eng.reqs[2].pending) + 16)
            b = batch_cls()
            b.add(2, kinds["P"], len(eng.reqs[2].pending))
            assert eng.execute(b).get(2, []) == []    # replay: no emission
        b = batch_cls()
        for rid, kind, n in step:
            b.add(rid, kinds[kind], n)
        for rid, toks in eng.execute(b).items():
            streams[rid] += toks
    return streams


# the reference init jitted: one compile for the whole tree instead of one
# per eager op (seconds per model); its values agree with the eager init's
# to an ulp, and both sides of every comparison get the same numbers
_jax_init = jax.jit(jmodels.init_params, static_argnums=(1,))


@pytest.fixture(scope="module")
def reference():
    jcfg = jcfgs.get_reduced(ARCH)
    jparams = _jax_init(jax.random.PRNGKey(0), jcfg)
    eng = jengine.ServingEngine(jcfg, jparams, jengine.EngineConfig(
        share_prefix=True, **ECFG))
    kinds = {"P": jslo.StageKind.PREFILL, "D": jslo.StageKind.DECODE}
    streams = _run(eng, jbatch.Batch, kinds)
    assert eng.counters["prefix_hit_tokens"] > 0
    assert eng.kv.partial_head_copies > 0
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, jparams, params, streams, dict(eng.counters)


def _port(params, **kw):
    return ServingEngine(get_reduced(ARCH), params, EngineConfig(**ECFG, **kw),
                         device="cpu")


def _assert_streams_equal(got, want, prompt, jcfg, jparams):
    if got == want:
        return
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    assert len(got) == len(want) or i < min(len(got), len(want)), (got, want)
    toks = jnp.asarray([prompt + want[:i]], jnp.int32)
    h, _, _ = jmodels.model_forward(jparams, jcfg, toks)
    top = np.sort(np.asarray(jmodels.logits_fn(jparams, jcfg, h))[0, -1])
    margin = float(top[-1] - top[-2])
    assert margin < TIE_MARGIN, (
        f"stream differs at step {i} with reference margin {margin}: "
        f"{got} vs {want}")
    warnings.warn(f"tie at step {i} (reference top-2 margin {margin})")


@pytest.mark.parametrize("share", [True, False])
def test_streams_match_jax(reference, share):
    jcfg, jparams, params, want, jcounters = reference
    eng = _port(params, share_prefix=share)
    got = _run(eng, Batch, {"P": StageKind.PREFILL, "D": StageKind.DECODE})
    prompts = {1: P1, 2: P2, 3: P3}
    for rid in got:
        assert len(got[rid]) > 1
        _assert_streams_equal(got[rid], want[rid], prompts[rid], jcfg,
                              jparams)
    for key in ("prefill_calls", "decode_calls", "decode_tokens"):
        assert eng.counters[key] == jcounters[key], key
    if share:
        assert eng.counters["prefix_hit_tokens"] == \
            jcounters["prefix_hit_tokens"]
        assert eng.kv.partial_head_copies > 0 and eng.kv.cow_copies > 0
    else:
        assert eng.counters["prefix_hit_tokens"] == 0


def test_preempt_replay_is_bit_identical(reference):
    _, _, params, _, _ = reference
    kinds = {"P": StageKind.PREFILL, "D": StageKind.DECODE}
    want = _run(_port(params), Batch, kinds)
    eng = _port(params)
    got = _run(eng, Batch, kinds, preempt=True)
    assert eng.counters["preemptions"] == 1
    assert got == want


def test_unported_engine_options_raise(reference):
    """Mesh-sharded serving is ported (``tests/test_torch_mesh_serving.py``):
    a mesh must be a ``ServingMesh``, and a two-shard CPU mesh builds."""
    from repro_torch.distributed.sharding import make_serving_mesh
    _, _, params, _, _ = reference
    cfg = get_reduced(ARCH)
    with pytest.raises(TypeError):
        ServingEngine(cfg, params, EngineConfig(mesh=object(), **ECFG),
                      device="cpu")
    eng = ServingEngine(cfg, params, EngineConfig(
        mesh=make_serving_mesh(["cpu"] * 2), **ECFG))
    assert eng.device == torch.device("cpu") and len(eng.kv.shard_pools) == 2
    # encoder conditioning is ported: the request is admitted with its
    # states and shares no prefix pages
    eng = _port(params)
    assert eng.add_request(1, P1, 48, enc_states=torch.zeros(1, 4, 8))
    assert eng.reqs[1].enc_states.shape == (1, 4, 8)
    assert eng._share_tokens(P1, eng.reqs[1].enc_states) is None


def test_sampled_stream_does_not_depend_on_prefill_split(reference):
    """With temperature > 0, a prefill chunk whose sample is discarded
    draws no random numbers, so the split does not change the stream."""
    _, _, params, _, _ = reference
    streams = []
    for chunks in ((34,), (10, 24)):
        eng = _port(params, temperature=1.0, seed=5)
        assert eng.add_request(1, P1, expected_total=48)
        got = []
        for n in chunks:
            b = Batch()
            b.add(1, StageKind.PREFILL, n)
            got += eng.execute(b).get(1, [])
        b = Batch()
        b.add(1, StageKind.DECODE, 6)
        streams.append(got + eng.execute(b).get(1, []))
    assert len(streams[0]) == 7 and streams[0] == streams[1]


def test_sampling_matches_jax():
    """Greedy is the exact argmax; temperature / top-k draws cannot follow
    jax.random's stream, so they are compared in distribution: each
    token's frequency over 4000 draws lies within 4.5 binomial standard
    deviations of the reference's, top-k never leaves the top k."""
    from repro.serving.sampling import sample as jax_sample
    from repro_torch.serving.sampling import sample
    logits = np.random.default_rng(1).standard_normal((6, 50)).astype(
        np.float32)
    assert sample(torch.from_numpy(logits)).tolist() == \
        np.asarray(jax_sample(jnp.asarray(logits))).tolist()
    n, temp = 4000, 0.7
    row = np.array([1.0, 0.5, 0.0, -0.5, 2.0], np.float32)
    gen = torch.Generator().manual_seed(0)
    got = sample(torch.from_numpy(np.tile(row, (n, 1))), gen, temp)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    want = jax.vmap(lambda k: jax_sample(jnp.asarray(row), k, temp))(keys)
    p_got = np.bincount(got.numpy(), minlength=5) / n
    p_want = np.bincount(np.asarray(want), minlength=5) / n
    p = np.exp(row / temp) / np.exp(row / temp).sum()
    sd = np.sqrt(2 * p * (1 - p) / n)          # sd of a difference
    assert (np.abs(p_got - p_want) <= 4.5 * sd + 1e-12).all(), (p_got, p_want)
    top = sample(torch.from_numpy(np.tile(row, (200, 1))), gen, temp,
                 top_k=2)
    assert set(top.tolist()) <= {0, 4}
