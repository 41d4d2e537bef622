"""The port's examples (``examples/torch_*.py``) run in-process on the
CPU at the reduced configs (``--device cpu --reduced``), each through its
``main(argv) -> dict``, with the invariants of the reference example's
story:

* ``torch_quickstart``: its admitted, declined and batch-plan lines equal
  those of the reference ``examples/quickstart.py`` (run with ``runpy``;
  ``repro.core`` imports no JAX);
* ``torch_serve_e2e``: every request of the launcher's trace served;
* ``torch_spec_decode_demo``: the three requests served, speculation
  planned, drafted and verified, the planned draft length falling back
  to autoregressive as the EWMA learns the draft's acceptance;
* ``torch_multi_replica``: the simulator section equals
  ``repro.core.router.make_slos_serve_cluster``'s results for one and four
  replicas, the page budgets drain to 0, prefix affinity saves at least as
  many prompt tokens as round-robin;
* ``torch_train_small``: the loss falls over a few steps and a checkpoint
  lands in the directory given.

With ``--device`` left at its default (CUDA) each example raises here."""
import contextlib
import importlib.util
import io
import runpy
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
CPU = ["--device", "cpu", "--reduced"]
NAMES = ("torch_quickstart", "torch_serve_e2e", "torch_spec_decode_demo",
         "torch_multi_replica", "torch_train_small")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = _example(name).main(argv)
    return res, out.getvalue()


def _plan_lines(text):
    """The plan's lines, each batch's entries sorted: decode jobs due at
    one time leave the planner's heap in ``id()`` order (both packages'
    ``scheduler.py``), which varies from run to run."""
    keep = ("admitted:", "declined:", "first planned", "batch ")
    out = []
    for ln in text.splitlines():
        if not ln.strip().startswith(keep):
            continue
        if "[" in ln:
            head, rest = ln.split("[", 1)
            body, tail = rest.split("]", 1)
            ln = f"{head}[{', '.join(sorted(body.split(', ')))}]{tail}"
        out.append(ln)
    return out


def test_quickstart_plan_equals_the_reference():
    res, text = _run("torch_quickstart", CPU)
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        runpy.run_path(str(EXAMPLES / "quickstart.py"), run_name="__main__")
    want = _plan_lines(ref.getvalue())
    assert len(want) == 3 + min(6, res["n_batches"])
    assert _plan_lines(text) == want
    assert res["admitted"] == [2, 0, 1] and res["declined"] == [3]


def test_serve_e2e_serves_the_trace():
    res, text = _run("torch_serve_e2e", CPU)
    assert res["served"] == res["submitted"] > 0
    assert res["dropped"] == 0 and res["tokens_out"] > 0
    assert res["device"] == "cpu"
    assert f"served {res['served']}/{res['submitted']}" in text


def test_spec_decode_demo_adapts_the_draft_length():
    res, _ = _run("torch_spec_decode_demo", CPU)
    assert res["idle"] and res["served"] == res["submitted"] == 3
    assert res["tokens_out"] == 3 * 40
    assert res["drafted"] > 0 and 0 <= res["accepted"] <= res["drafted"]
    assert res["verify_calls"] > 0 and res["verify_fused_ops"] > 0
    assert res["planned_draft_lengths"][0]          # speculation planned
    assert res["planned_draft_lengths"][-1] is None  # then autoregressive


def test_multi_replica_story_and_simulator_match_the_reference():
    from repro.core import opt_perf_model
    from repro.core.router import make_slos_serve_cluster
    from repro.core.workload import generate_workload
    res, _ = _run("torch_multi_replica", CPU)
    for n in (1, 4):
        ref = make_slos_serve_cluster(n, opt_perf_model(7e9)).run(
            generate_workload("coder", 4.0 * n, 40.0, seed=7))
        assert res["simulator"][n] == {
            "n_requests": ref.n_requests, "attainment": ref.attainment,
            "routed": sum(1 for r in ref.records if r.hops > 0),
            "best_effort": ref.n_best_effort,
            "preemptions": ref.n_preemptions}
    real = res["real"]
    assert real["budget_used_after"] == 0 and real["served"] > 0
    assert real["tokens_out"] > 0
    rr, aff = res["round_robin"], res["affinity"]
    assert rr["budget_used_after"] == aff["budget_used_after"] == 0
    assert rr["served"] == aff["served"] == 12
    assert aff["prefix_hit_tokens"] >= rr["prefix_hit_tokens"]
    assert aff["affinity_routed"] > 0 == rr["affinity_routed"]


def test_train_small_loss_falls_and_checkpoints(tmp_path):
    """40 steps of the reduced smollm: the loss falls 6.264 -> 6.148,
    where the same steps at lr 0 give losses in 6.250 .. 6.304 (a drop of
    at most 0.014), hence the margin of 0.06 nats."""
    res, text = _run("torch_train_small",
                     CPU + ["--steps", "40", "--checkpoint-every", "20",
                            "--checkpoint-dir", str(tmp_path)])
    assert res["steps"] == 40
    assert res["loss_last"] <= res["loss_first"] - 0.06
    assert res["checkpoint_step"] == 40
    assert (tmp_path / "ckpt_00000040.npz").exists()
    assert str(tmp_path) in text


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", NAMES)
def test_default_device_raises_without_a_card(name, tmp_path):
    argv = ["--checkpoint-dir", str(tmp_path)] if name == NAMES[-1] else []
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main(argv)
