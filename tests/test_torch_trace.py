"""The port's trace format (``repro_torch/core/trace.py``) against the
reference's (``repro/core/trace.py``): the same arguments give equal
``TraceEntry`` lists, ``save_trace`` writes the same bytes, each package
reads the other's file, and ``to_request`` / ``to_payload`` agree field
by field."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.trace as jtrace                               # noqa: E402
from repro_torch.core import trace                              # noqa: E402

CASES = [  # rate, duration, kwargs
    (4.0, 4.0, dict(seed=0, time_scale=0.25, max_stage_tokens=128,
                    vocab=200064)),
    (3.0, 8.0, dict(seed=3, time_scale=0.02, max_stage_tokens=16,
                    vocab=256)),
    (2.0, 6.0, dict(seed=7, mix=("chatbot", "toolllm"), time_scale=0.1)),
    (1.5, 5.0, dict(seed=11, mix=("reasoning",), time_scale=1.0,
                    vocab=512)),
]


def _fields(entry):
    return dataclasses.asdict(entry)


@pytest.mark.parametrize("rate,duration,kw", CASES)
def test_generate_trace_matches_reference(rate, duration, kw):
    want = jtrace.generate_trace(rate, duration, **kw)
    got = trace.generate_trace(rate, duration, **kw)
    assert want
    assert [_fields(e) for e in got] == [_fields(e) for e in want]
    assert [e.slo_class() for e in got] == [e.slo_class() for e in want]
    assert [e.total_tokens() for e in got] == [e.total_tokens()
                                               for e in want]


def test_chip_trace_shape():
    """The trace the card's gateway phase replays: 18 entries covering the
    six scenarios, 2612 prefill and 1272 decode tokens, at most 532
    tokens and 6 stages in one request."""
    t = trace.generate_trace(4.0, 4.0, seed=0, time_scale=0.25,
                             max_stage_tokens=128, vocab=200064)
    assert len(t) == 18
    assert {e.scenario for e in t} == set(trace.SIX_SCENARIO_MIX)
    assert sum(n for e in t for k, n, _ in e.stages if k == "prefill") == 2612
    assert sum(n for e in t for k, n, _ in e.stages if k == "decode") == 1272
    assert max(e.total_tokens() for e in t) == 532
    assert max(len(e.stages) for e in t) == 6


def test_save_and_load_cross_packages(tmp_path):
    entries = trace.generate_trace(3.0, 6.0, seed=5, time_scale=0.05,
                                   vocab=300)
    jentries = jtrace.generate_trace(3.0, 6.0, seed=5, time_scale=0.05,
                                     vocab=300)
    mine, theirs = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    trace.save_trace(entries, str(mine))
    jtrace.save_trace(jentries, str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    assert trace.load_trace(str(theirs)) == entries
    assert ([_fields(e) for e in jtrace.load_trace(str(mine))]
            == [_fields(e) for e in entries])


def test_request_and_payload_match_reference():
    kw = dict(seed=2, time_scale=0.05, max_stage_tokens=32, vocab=128)
    for e, je in zip(trace.generate_trace(4.0, 5.0, **kw),
                     jtrace.generate_trace(4.0, 5.0, **kw)):
        assert e.to_payload() == je.to_payload()
        assert e.as_dict() == je.as_dict()
        for rid in (None, 99):
            r, jr = e.to_request(rid), je.to_request(rid)
            assert (r.rid, r.arrival) == (jr.rid, jr.arrival)
            assert ([(s.kind.value, s.length, s.slo.ttft_slowdown,
                      s.slo.tpot) for s in r.stages]
                    == [(s.kind.value, s.length, s.slo.ttft_slowdown,
                         s.slo.tpot) for s in jr.stages])
            assert r.total_tokens() == jr.total_tokens()


def test_unknown_scenario_raises():
    for gen in (trace.generate_trace, jtrace.generate_trace):
        with pytest.raises(ValueError):
            gen(1.0, 1.0, mix=("chatbot", "nope"))
