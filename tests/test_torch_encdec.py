"""The port's encoder-decoder and cross-attention path against the JAX
package: kernel B6's plain version (``flash_attention_bh``, CPU dispatch)
and the port's oracle ``ref_attention_bh`` against the Pallas kernel in
interpret mode (``flash_attention_bh`` and its GQA wrapper
``ops.attention``), whisper's encoder, the logits of whisper and of the
llama-3.2-vision VLM with encoder / image states, the encoder pytree in
the bridge, and the serving engine's greedy streams on the same batches
as the JAX engine (two lanes with different encoder states in one
prefill group, a mid-page second chunk, frozen decode lanes, a preempt
replay).  Both packages run the same weights (the JAX init, bridged; the
VLM's tanh gates set to 1, as in ``tests/test_engine.py``, since they are
0 at init) and the same numpy inputs.

Tolerances: attention outputs atol 1e-5 (float32 sums in another order
than XLA's), the encoder 1e-5, logits 1e-4 (two decoder layers over two
encoder layers of float32 matmuls).  Greedy streams must be equal: a
difference counts as a fault unless the reference's top-2 logit margin
there is below 1e-4 (a tie)."""
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
import repro.models.encdec as jencdec                           # noqa: E402
import repro.serving.engine as jengine                          # noqa: E402
from repro.kernels import ops as jops                           # noqa: E402
from repro.kernels.flash_attention import (                     # noqa: E402
    flash_attention_bh as jax_flash_bh)
from repro.kernels.ref import ref_attention_bh as jax_ref_bh    # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config, get_reduced         # noqa: E402
from repro_torch.core.batch import Batch                        # noqa: E402
from repro_torch.core.slo import StageKind                      # noqa: E402
from repro_torch.device import generator                        # noqa: E402
from repro_torch.kernels import flash_attention as fa           # noqa: E402
from repro_torch.kernels.ref import ref_attention_bh            # noqa: E402
from repro_torch.models import (encdec_forward, encoder_forward,  # noqa: E402
                                init_encdec_params, logits_fn,
                                model_forward)
from repro_torch.serving.engine import (EngineConfig,           # noqa: E402
                                        ServingEngine)

WHISPER, VLM = "whisper-large-v3", "llama-3.2-vision-11b"
TOL = 1e-5
ATOL_LOGITS = 1e-4
TIE_MARGIN = 1e-4
ECFG = dict(max_slots=4, max_len=64, total_pages=32)


def _np(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------ kernel B6 ------------------------------- #
# BH, Sq, Sk, hd, causal, q_offset, kv_len, block_q, block_k: the TPU
# kernel itself, with blocks that divide Sq and Sk (its own precondition)
BH_CASES = [
    (3, 24, 24, 32, True, 0, None, 8, 12),  # square causal
    (2, 16, 40, 64, False, 0, None, 16, 20),  # bidirectional, Sq != Sk
    (2, 16, 40, 32, True, 9, 30, 16, 20),   # chunk at an offset, kv_len < Sk
    (2, 8, 40, 64, False, 0, 33, 8, 40),    # cross-style, masked tail
]


@pytest.mark.parametrize("BH,Sq,Sk,hd,causal,q_offset,kv_len,bq,bk",
                         BH_CASES)
def test_flash_plain_matches_pallas_interpret(BH, Sq, Sk, hd, causal,
                                              q_offset, kv_len, bq, bk):
    q, k, v = (_np(BH, Sq, hd, seed=1), _np(BH, Sk, hd, seed=2),
               _np(BH, Sk, hd, seed=3))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    want = np.asarray(jax_flash_bh(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), block_q=bq, block_k=bk,
                                   interpret=True, **kw))
    got = fa.flash_attention_bh(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    oracle = ref_attention_bh(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(
        oracle.numpy(),
        np.asarray(jax_ref_bh(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw)), atol=TOL, rtol=0)


# B, Sq, Sk, H, KV, hd, causal, q_offset, kv_len: the GQA wrapper, whose
# reference pads Sq and Sk to its 8-row blocks (13, 21 are no multiples)
GQA_CASES = [
    (2, 13, 21, 4, 2, 32, True, 0, None),
    (1, 13, 21, 4, 1, 64, False, 0, None),
    (2, 5, 21, 6, 2, 32, True, 16, 21),
    (2, 1, 21, 4, 2, 32, False, 0, 17),     # one decode row
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,q_offset,kv_len",
                         GQA_CASES)
def test_attention_gqa_matches_ops_attention(B, Sq, Sk, H, KV, hd, causal,
                                             q_offset, kv_len):
    q = _np(B, Sq, H, hd, seed=4)
    k, v = _np(B, Sk, KV, hd, seed=5), _np(B, Sk, KV, hd, seed=6)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    want = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), block_q=8, block_k=8,
                                     interpret=True, **kw))
    got = fa.attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert got.shape == (B, Sq, H, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_flash_wrapper_dispatch_and_counts():
    q, k, v = (torch.from_numpy(_np(2, 5, 32, seed=7)),
               torch.from_numpy(_np(2, 9, 32, seed=8)),
               torch.from_numpy(_np(2, 9, 32, seed=9)))
    before = dict(fa.COUNTS)
    out = fa.flash_attention_bh(q, k, v, causal=True, q_offset=4)
    assert fa.COUNTS["plain"] == before["plain"] + 1
    assert fa.COUNTS["kernel"] == before["kernel"]
    np.testing.assert_allclose(
        out.numpy(), ref_attention_bh(q, k, v, causal=True,
                                      q_offset=4).numpy(), atol=TOL)
    with pytest.raises(RuntimeError):
        fa.flash_attention_bh(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError):
        fa.attention(torch.zeros(1, 2, 3, 32), torch.zeros(1, 2, 2, 32),
                     torch.zeros(1, 2, 2, 32))


# ------------------------------- models --------------------------------- #
def _jax_params(arch):
    jcfg = jcfgs.get_reduced(arch)
    if jcfg.arch_type == "encdec":
        jp = jencdec.init_encdec_params(jax.random.PRNGKey(0), jcfg)
    else:
        jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
        for seg in jp["segments"]:
            if "p" in seg and "cross" in seg["p"]:
                seg["p"]["cross"]["gate"] = jnp.ones((), jnp.float32)
    return jcfg, jp


@pytest.fixture(scope="module")
def whisper():
    jcfg, jp = _jax_params(WHISPER)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    cfg = get_reduced(WHISPER)
    frames = _np(3, cfg.encoder.n_frames, cfg.d_model, seed=10)
    jenc = np.array(jax.jit(jencdec.encoder_forward, static_argnums=1)(
        jp["encoder"], jcfg, jnp.asarray(frames)))
    return jcfg, jp, cfg, params, frames, jenc


@pytest.fixture(scope="module")
def vlm():
    jcfg, jp = _jax_params(VLM)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    cfg = get_reduced(VLM)
    imgs = _np(3, cfg.n_image_tokens, cfg.d_model, seed=11)
    return jcfg, jp, cfg, params, imgs, imgs


def test_encoder_forward_matches_jax(whisper):
    _, _, cfg, params, frames, jenc = whisper
    plain0 = fa.COUNTS["plain"]
    got = encoder_forward(params["encoder"], cfg, torch.from_numpy(frames))
    assert fa.COUNTS["plain"] - plain0 == cfg.encoder.n_layers
    np.testing.assert_allclose(got.numpy(), jenc, atol=TOL, rtol=0)


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_logits_with_enc_states_match_jax(arch, whisper, vlm):
    jcfg, jp, cfg, params, _, enc = whisper if arch == WHISPER else vlm
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (3, 11))
    jh, _, _ = jax.jit(jmodels.model_forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(toks, jnp.int32), enc_states=jnp.asarray(enc))
    want = np.asarray(jmodels.logits_fn(jp, jcfg, jh))
    n_cross = sum(k == "cross_attn" for k in cfg.block_pattern)
    plain0 = fa.COUNTS["plain"]
    h, _, _ = model_forward(params, cfg, torch.from_numpy(toks),
                         enc_states=torch.from_numpy(enc))
    # B6 for every causal self-attention and every cross-attention
    assert fa.COUNTS["plain"] - plain0 == cfg.n_layers + n_cross
    np.testing.assert_allclose(logits_fn(params, cfg, h).numpy(), want,
                               atol=ATOL_LOGITS, rtol=0)
    if arch == WHISPER:
        h2, _, _ = encdec_forward(params, cfg, torch.from_numpy(_np(
            3, cfg.encoder.n_frames, cfg.d_model, seed=10)),
            torch.from_numpy(toks))
        np.testing.assert_allclose(logits_fn(params, cfg, h2).numpy(), want,
                                   atol=ATOL_LOGITS, rtol=0)


def test_bridge_and_init_keep_the_encoder_pytree(whisper):
    jcfg, jp, cfg, params, _, _ = whisper
    own = init_encdec_params(cfg, generator(torch.device("cpu"), 0),
                             device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {jax.tree_util.keystr(path): tuple(np.shape(a))
            for path, a in flat_j}

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(shapes(v, f"{prefix}['{k}']"))
            return out
        if isinstance(tree, list):
            out = {}
            for i, v in enumerate(tree):
                out.update(shapes(v, f"{prefix}[{i}]"))
            return out
        return {prefix: tuple(tree.shape)}
    assert shapes(params) == want
    assert shapes(own) == want
    assert "encoder" in own and own["encoder"]["layers"]["attn"][
        "wq"].shape[0] == cfg.encoder.n_layers
    full = get_config(WHISPER)
    assert (full.n_layers, full.encoder.n_layers, full.d_model,
            full.n_heads, full.head_dim, full.d_ff, full.vocab,
            full.encoder.n_frames) == (32, 32, 1280, 20, 64, 5120, 51866, 1500)


# ------------------------------- engine --------------------------------- #
rng = np.random.default_rng(13)
P1 = rng.integers(1, 512, 20).tolist()
P2 = rng.integers(1, 512, 13).tolist()
# (rid, kind, n) entries per batch; "P"/"D" = prefill/decode.  The first
# group holds rids 1 and 2 (different states) in the 16-token bucket; rid
# 1's second chunk starts mid-page at 12; lanes freeze at uneven budgets
SCRIPT = [
    [(1, "P", 12), (2, "P", 13)],
    [(1, "P", 8), (2, "D", 3)],
    [(1, "D", 4), (2, "D", 2)],
    [(1, "D", 2), (2, "D", 3)],
]
PREEMPT_AT = 3          # replay run: preempt rid 2 before this batch


def _run(eng, batch_cls, kinds, encs, preempt=False):
    streams = {1: [], 2: []}
    assert eng.add_request(1, P1, expected_total=40, enc_states=encs[1])
    assert eng.add_request(2, P2, expected_total=40, enc_states=encs[2])
    for i, step in enumerate(SCRIPT):
        if preempt and i == PREEMPT_AT:
            assert eng.preempt(2) > 0
            assert eng.readmit(2, len(eng.reqs[2].pending) + 8)
            b = batch_cls()
            b.add(2, kinds["P"], len(eng.reqs[2].pending))
            assert eng.execute(b).get(2, []) == []    # replay: no emission
        b = batch_cls()
        for rid, kind, n in step:
            b.add(rid, kinds[kind], n)
        for rid, toks in eng.execute(b).items():
            streams[rid] += toks
    return streams


@pytest.fixture(scope="module")
def jax_streams(whisper, vlm):
    out = {}
    for arch, model in ((WHISPER, whisper), (VLM, vlm)):
        jcfg, jp, _, _, _, enc = model
        eng = jengine.ServingEngine(jcfg, jp, jengine.EngineConfig(**ECFG))
        kinds = {"P": jslo.StageKind.PREFILL, "D": jslo.StageKind.DECODE}
        encs = {1: jnp.asarray(enc[0:1]), 2: jnp.asarray(enc[1:2])}
        out[arch] = (_run(eng, jbatch.Batch, kinds, encs),
                     dict(eng.counters))
    return out


def _port(cfg, params):
    return ServingEngine(cfg, params, EngineConfig(**ECFG), device="cpu")


def _assert_streams_equal(got, want, prompt, enc, jcfg, jp):
    if got == want:
        return
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    assert len(got) == len(want) or i < min(len(got), len(want)), (got, want)
    toks = jnp.asarray([prompt + want[:i]], jnp.int32)
    h, _, _ = jmodels.model_forward(jp, jcfg, toks,
                                    enc_states=jnp.asarray(enc))
    top = np.sort(np.asarray(jmodels.logits_fn(jp, jcfg, h))[0, -1])
    margin = float(top[-1] - top[-2])
    assert margin < TIE_MARGIN, (
        f"stream differs at step {i} with reference margin {margin}: "
        f"{got} vs {want}")
    warnings.warn(f"tie at step {i} (reference top-2 margin {margin})")


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_streams_match_jax_engine(arch, whisper, vlm, jax_streams):
    jcfg, jp, cfg, params, _, enc = whisper if arch == WHISPER else vlm
    want, jcounters = jax_streams[arch]
    eng = _port(cfg, params)
    kinds = {"P": StageKind.PREFILL, "D": StageKind.DECODE}
    encs = {1: torch.from_numpy(enc[0:1]), 2: torch.from_numpy(enc[1:2])}
    got = _run(eng, Batch, kinds, encs)
    for rid, prompt in ((1, P1), (2, P2)):
        assert len(got[rid]) > 1
        _assert_streams_equal(got[rid], want[rid], prompt, enc[rid - 1:rid],
                              jcfg, jp)
    for key in ("prefill_calls", "decode_calls", "decode_tokens"):
        assert eng.counters[key] == jcounters[key], key
    assert eng.counters["prefix_hit_tokens"] == 0   # conditioned: no sharing


def test_preempt_replay_is_bit_identical(whisper):
    _, _, cfg, params, _, enc = whisper
    kinds = {"P": StageKind.PREFILL, "D": StageKind.DECODE}
    encs = {1: torch.from_numpy(enc[0:1]), 2: torch.from_numpy(enc[1:2])}
    want = _run(_port(cfg, params), Batch, kinds, encs)
    eng = _port(cfg, params)
    got = _run(eng, Batch, kinds, encs, preempt=True)
    assert eng.counters["preemptions"] == 1
    assert eng.reqs[2].enc_states is not None
    assert got == want


def test_encoder_state_changes_the_stream(whisper):
    _, _, cfg, params, _, enc = whisper
    streams = []
    for e in (enc[0:1], enc[2:3]):
        eng = _port(cfg, params)
        assert eng.add_request(1, P1, expected_total=40,
                               enc_states=torch.from_numpy(e))
        b = Batch()
        b.add(1, StageKind.PREFILL, len(P1))
        got = eng.execute(b)[1]
        b = Batch()
        b.add(1, StageKind.DECODE, 6)
        streams.append(got + eng.execute(b)[1])
    assert len(streams[0]) == len(streams[1]) == 7
    assert streams[0] != streams[1]


# ----------------------- spec decoding, enc-dec ------------------------- #
CROSS_SCALE = 0.3       # the target's cross-attention output, scaled down
P_SPEC = np.random.default_rng(3).integers(1, 512, 21).tolist()
SPEC_KS = (3, 1, 5, 8, 3, 5)
SPEC_KEYS = ("spec_draft_calls", "spec_verify_calls", "spec_accepted_tokens",
             "spec_drafted_tokens", "prefill_calls")


def _spec_models(jp):
    """The whisper target with its cross-attention output scaled by
    CROSS_SCALE, and as draft its own decoder without cross-attention (the
    draft sees no encoder states, in both packages): the draft then
    agrees with the target in part.  Returns numpy trees (target,
    draft)."""
    tgt = jax.tree.map(np.array, jp)
    cross = tgt["segments"][0]["p"]["cross"]
    cross["wo"] = cross["wo"] * np.float32(CROSS_SCALE)
    cross["bo"] = cross["bo"] * np.float32(CROSS_SCALE)
    dft = {k: v for k, v in tgt.items() if k != "encoder"}
    dft["segments"] = [{"p": {k: v for k, v in tgt["segments"][0]["p"].items()
                              if k not in ("cross", "norm_x")}}]
    return tgt, dft


def _draft_of(cfg):
    import dataclasses
    return dataclasses.replace(cfg, name=cfg.name + "-draft",
                               arch_type="dense", encoder=None,
                               block_pattern=("attn",) * cfg.n_layers)


def _spec_run(eng, batch_cls, kinds, enc):
    assert eng.add_request(1, P_SPEC, expected_total=60, enc_states=enc)
    b = batch_cls()
    b.add(1, kinds["P"], len(P_SPEC))
    got = eng.execute(b).get(1, [])
    for k in SPEC_KS:
        b = batch_cls(spec_step=k)
        b.add(1, kinds["D"], k + 1)
        out = eng.execute(b).get(1, [])
        assert len(out) >= 1                  # progress guarantee
        got += out
    return got


def test_spec_decode_over_encdec_target_matches_jax_engine(whisper):
    """Speculative decoding over the reduced whisper target, the request's
    encoder states passed to every verify: the stream, acceptance and
    counters equal the JAX engine's, and the draft is accepted in part."""
    jcfg, jp, cfg, _, _, jenc = whisper
    tgt, dft = _spec_models(jp)
    kinds_j = {"P": jslo.StageKind.PREFILL, "D": jslo.StageKind.DECODE}
    jeng = jengine.ServingEngine(jcfg, tgt, jengine.EngineConfig(**ECFG),
                                 draft=(_draft_of(jcfg), dft))
    want = _spec_run(jeng, jbatch.Batch, kinds_j, jnp.asarray(jenc[0:1]))
    eng = ServingEngine(cfg, bridge.params_from_numpy(tgt, device="cpu"),
                        EngineConfig(**ECFG),
                        draft=(_draft_of(cfg),
                               bridge.params_from_numpy(dft, device="cpu")),
                        device="cpu")
    kinds = {"P": StageKind.PREFILL, "D": StageKind.DECODE}
    got = _spec_run(eng, Batch, kinds, torch.from_numpy(jenc[0:1]))
    _assert_streams_equal(got, want, P_SPEC, jenc[0:1], jcfg, tgt)
    c = eng.counters
    assert 0 < c["spec_accepted_tokens"] < c["spec_drafted_tokens"]
    if got == want:
        for key in SPEC_KEYS:
            assert c[key] == jeng.counters[key], key
    assert c["verify_fused_ops"] == cfg.n_layers * c["spec_verify_calls"]
