"""The kernels' bf16 inputs and the launch layer's bf16 steps in the port
against the JAX package, on the CPU at reduced sizes.

* B1 over bf16 queries and pages, B6 and B5 over bf16 inputs: the plain
  versions (what the wrappers run for CPU tensors) against the Pallas
  kernels in interpret mode, one shape each from the reference's own
  kernel tests (``tests/test_kernels.py``).  Both widen the same bf16
  inputs, sum in float32 and round once, so every element lies within one
  bf16 rounding of the Pallas function's float32 result over the widened
  inputs, ``2^-8 |pallas32| + 1e-5``, and at most one bf16 step from the
  Pallas kernel's own bf16 output: far inside the reference tests' 3e-2,
  2e-2 and 5e-2.  B5's final state is held the same way against the
  sequential oracle ``ref_ssd``.
* B5's plain version on float32 inputs gives what it gave before it
  learned to widen bf16 ones, bit for bit (a frozen copy below).
* Every architecture's bf16 ``make_prefill_step`` and ``make_serve_step``
  run on real CPU tensors (reduced configs, 2 x 32 tokens, one serve
  step; the VLM and whisper with their bf16 ``_enc_input`` states), and
  the logits' and every cache leaf's shapes and dtypes equal those of the
  reference's steps (``jax.eval_shape``).  For smollm-135m, mamba2-2.7b,
  zamba2-7b and whisper-large-v3 the values are held against the
  reference's jitted bf16 steps on the same weights: each leaf within
  2^-5 of its largest reference value, the next tokens equal.  Why 2^-5:
  both packages round every bf16 product and activation (2^-8 each), but
  in other orders and places: the reference promotes with ``jnp``'s rules
  and runs the SSD's einsums in bf16, while B5 and B6 (and their plain
  versions) accumulate in float32 and round once.  At these depths the
  two differ by at most 1.4e-2 of a leaf's largest value (mamba2's and
  zamba2's states); 2^-5 leaves twice that."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as jcfgs                                   # noqa: E402
import repro.launch.steps as jsteps                             # noqa: E402
import repro.models.transformer as jtransformer                 # noqa: E402
from repro.kernels import ops                                   # noqa: E402
from repro.kernels.ref import ref_ssd                           # noqa: E402
from repro.models.encdec import init_encdec_params as jinit_encdec  # noqa
from repro_torch.configs import _MODULES, get_reduced           # noqa: E402
from repro_torch.device import generator                        # noqa: E402
from repro_torch.kernels import flash_attention as fa           # noqa: E402
from repro_torch.kernels import paged_attention as pa           # noqa: E402
from repro_torch.kernels import ssd_scan as sk                  # noqa: E402
from repro_torch.launch import steps                            # noqa: E402
from repro_torch.models import init_params                      # noqa: E402
from repro_torch.models.encdec import init_encdec_params        # noqa: E402
from repro_torch.models.transformer import init_cache           # noqa: E402
from repro_torch.training.tree import flatten, leaves, tree_map  # noqa: E402

BF16 = torch.bfloat16
ROUNDING, ATOL = 2.0 ** -8, 1e-5       # one bf16 rounding
STEP_RTOL = 2.0 ** -5
ARCHS = sorted(_MODULES)
VALUE_ARCHS = ("smollm-135m", "mamba2-2.7b", "zamba2-7b",
               "whisper-large-v3")


def _np(t):
    return t.float().numpy()


def _one_rounding(got, want32):
    """``got`` (bf16) within one bf16 rounding of the float32 ``want32``."""
    err = np.abs(_np(got) - np.asarray(want32, np.float32))
    lim = ROUNDING * np.abs(np.asarray(want32, np.float32)) + ATOL
    assert (err <= lim).all(), float((err - lim).max())


def _one_step(got, want16):
    """``got`` and ``want16`` (both bf16) at most one bf16 step apart."""
    w = np.asarray(want16, np.float32)
    np.testing.assert_array_less(np.abs(_np(got) - w),
                                 2 * ROUNDING * np.abs(w) + ATOL)


def _bf(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(BF16)


def _j(t, dtype=jnp.bfloat16):
    return jnp.asarray(_np(t), dtype)


# ----------------------------- kernels --------------------------------- #
def test_plain_decode_bf16_query_matches_pallas():
    """B1 with bf16 q over bf16 pages (tests/test_kernels.py's GQA 4:1
    case): the output is bf16, one rounding from the Pallas function."""
    B, H, KV, hd, page, max_pages = 3, 8, 2, 32, 8, 6
    rng = np.random.default_rng(0)
    n_pages = B * max_pages + 4
    q, kp, vp = (_bf(rng, B, H, hd), _bf(rng, n_pages, page, KV, hd),
                 _bf(rng, n_pages, page, KV, hd))
    table = rng.permutation(n_pages)[:B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    lens = rng.integers(1, max_pages * page, size=B).astype(np.int32)
    args = (_j(kp), _j(vp), jnp.asarray(table), jnp.asarray(lens))
    want32 = ops.paged_attention(_j(q, jnp.float32), *args, interpret=True)
    want16 = ops.paged_attention(_j(q), *args, interpret=True)
    n0 = pa.COUNTS["plain"]
    got = pa.paged_decode_attention(q, kp, vp, torch.from_numpy(table),
                                    torch.from_numpy(lens))
    assert pa.COUNTS["plain"] == n0 + 1
    assert got.dtype == BF16 and want16.dtype == jnp.bfloat16
    _one_rounding(got, want32)
    _one_step(got, want16)


def test_plain_flash_bf16_matches_pallas():
    """B6 over bf16 q, k, v through the GQA wrapper (the reference test's
    GQA shape, causal, q at the cache's tail)."""
    B, Sq, Sk, H, KV, hd = 2, 64, 64, 4, 2, 32
    rng = np.random.default_rng(1)
    q, k, v = _bf(rng, B, Sq, H, hd), _bf(rng, B, Sk, KV, hd), \
        _bf(rng, B, Sk, KV, hd)
    kw = dict(causal=True, q_offset=Sk - Sq)
    jkw = dict(kw, block_q=64, block_k=64, interpret=True)
    want32 = ops.attention(*(_j(t, jnp.float32) for t in (q, k, v)), **jkw)
    want16 = ops.attention(*(_j(t) for t in (q, k, v)), **jkw)
    n0 = fa.COUNTS["plain"]
    got = fa.attention(q, k, v, **kw)
    assert fa.COUNTS["plain"] == n0 + 1
    assert got.dtype == BF16 and want16.dtype == jnp.bfloat16
    _one_rounding(got, want32)
    _one_step(got, want16)


def test_plain_ssd_bf16_matches_pallas():
    """B5 over bf16 x, B and C (the reference test's (2, 128, 4, 32, 16)
    in chunks of 32; dt and A float32): y one rounding from the Pallas
    function, the final state (bf16, as ssd_chunked returns it) one
    rounding from the sequential oracle's."""
    B, S, H, P, N, chunk = 2, 128, 4, 32, 16, 32
    rng = np.random.default_rng(2)
    xh, Bm, Cm = _bf(rng, B, S, H, P), _bf(rng, B, S, N), _bf(rng, B, S, N)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((B, S, H)).astype(np.float32))) \
        * 0.5
    A = -torch.exp(torch.from_numpy(
        rng.standard_normal(H).astype(np.float32)) * 0.3)
    jdt, jA = jnp.asarray(dt.numpy()), jnp.asarray(A.numpy())
    want32 = ops.ssd(_j(xh, jnp.float32), jdt, jA, _j(Bm, jnp.float32),
                     _j(Cm, jnp.float32), chunk=chunk, interpret=True)
    want16 = ops.ssd(_j(xh), jdt, jA, _j(Bm), _j(Cm), chunk=chunk,
                     interpret=True)
    _, state32 = ref_ssd(_j(xh, jnp.float32), jdt, jA, _j(Bm, jnp.float32),
                         _j(Cm, jnp.float32))
    n0 = sk.COUNTS["plain"]
    y, hT = sk.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk)
    assert sk.COUNTS["plain"] == n0 + 1
    assert y.dtype == hT.dtype == BF16 and want16.dtype == jnp.bfloat16
    _one_rounding(y, want32)
    _one_step(y, want16)
    _one_rounding(hT, state32)


def _frozen_ssd_chunked_plain(xh, dt, A, Bm, Cm, chunk, init_state=None):
    """B5's plain version as it was before it widened bf16 inputs (float32
    inputs only), kept to hold the new one to it bit for bit."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xc = xh.reshape(Bsz, nc, chunk, H, P).transpose(0, 1)
    dtc = dt.reshape(Bsz, nc, chunk, H).transpose(0, 1)
    Bc = Bm.reshape(Bsz, nc, chunk, N).transpose(0, 1)
    Cc = Cm.reshape(Bsz, nc, chunk, N).transpose(0, 1)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    h = (torch.zeros(Bsz, H, P, N) if init_state is None
         else init_state.float())
    ys = []
    for c in range(nc):
        xk, dtk, Bk, Ck = xc[c], dtc[c], Bc[c], Cc[c]
        dA = dtk.float() * A[None, None, :]
        seg = torch.cumsum(dA, dim=1)
        diff = seg[:, :, None, :] - seg[:, None, :, :]
        diff = torch.where(mask[None, :, :, None], diff, -1e30)
        decay = torch.exp(diff)
        cb = torch.einsum("bln,bmn->blm", Ck, Bk)
        att = cb[..., None] * decay
        y_intra = torch.einsum("blmh,bmh,bmhp->blhp", att, dtk, xk)
        y_inter = torch.einsum("bln,blh,bhpn->blhp", Ck,
                               torch.exp(seg).to(Ck.dtype), h.to(Ck.dtype))
        decay_to_end = torch.exp(seg[:, -1:, :] - seg)
        st = torch.einsum("bln,blh,blh,blhp->bhpn", Bk, dtk,
                          decay_to_end.to(Bk.dtype), xk)
        h = (h * torch.exp(dA.sum(dim=1))[..., None, None] + st.float())
        ys.append((y_intra + y_inter).to(xh.dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y, h.to(xh.dtype)


@pytest.mark.parametrize("with_state", [False, True])
def test_plain_ssd_float32_unchanged(with_state):
    """On float32 inputs B5's plain version is the frozen one bit for bit
    (three chunks, with and without an initial state)."""
    B, S, H, P, N, chunk = 2, 48, 3, 16, 8, 16
    g = torch.Generator().manual_seed(4)
    xh, Bm, Cm = (torch.randn(*s, generator=g)
                  for s in ((B, S, H, P), (B, S, N), (B, S, N)))
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.linspace(1.0, 16.0, H)
    h0 = torch.randn(B, H, P, N, generator=g) if with_state else None
    y, hT = sk.ssd_chunked_plain(xh, dt, A, Bm, Cm, chunk, h0)
    wy, wh = _frozen_ssd_chunked_plain(xh, dt, A, Bm, Cm, chunk, h0)
    assert y.dtype == hT.dtype == torch.float32
    assert torch.equal(y, wy) and torch.equal(hT, wh)


# --------------------------- launch steps ------------------------------ #
def _ref_init(jc):
    return jinit_encdec if jc.arch_type == "encdec" else \
        jtransformer.init_params


def _enc_rows(cfg):
    """The modality frontend's rows ``steps._enc_input`` stubs (0: none)."""
    if cfg.arch_type == "vlm":
        return cfg.n_image_tokens
    return cfg.encoder.n_frames if cfg.arch_type == "encdec" else 0


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_steps_run_with_the_reference_dtypes(arch):
    """The port's bf16 prefill and serve steps on real CPU tensors (the
    SSM models' raised before their output projection promoted as jnp
    does); logits and cache leaves with the reference's shapes and dtypes;
    for ``VALUE_ARCHS`` the values against the reference's jitted steps
    on the same weights."""
    cfg, jc = get_reduced(arch), jcfgs.get_reduced(arch)
    init = init_encdec_params if cfg.arch_type == "encdec" else init_params
    params = init(cfg, generator(torch.device("cpu"), 3), BF16,
                  device="cpu")
    rng = np.random.default_rng(3)
    Bn, S, max_len = 2, 32, 64
    tokens = rng.integers(0, cfg.vocab, (Bn, S)).astype(np.int32)
    n = _enc_rows(cfg)
    enc = _bf(rng, Bn, n, cfg.d_model) if n else None
    with torch.no_grad():
        tlog, tcache = steps.make_prefill_step(cfg)(
            params, torch.from_numpy(tokens),
            init_cache(cfg, Bn, max_len, BF16, device="cpu"), enc)
        prefilled = tree_map(torch.clone, tcache)   # the serve step writes
        nxt = tlog[:, -1].float().argmax(-1).to(torch.int32)[:, None]
        pos0 = torch.full((Bn,), S, dtype=torch.int32)
        ttok, tcache2 = steps.make_serve_step(cfg)(params, nxt, tcache,
                                                   pos0, enc)
    # the reference's shapes and dtypes, traced without compiling
    jenc_s = (jax.ShapeDtypeStruct((Bn, n, jc.d_model), jnp.bfloat16)
              if n else None)
    jp_s = jax.eval_shape(lambda: _ref_init(jc)(jax.random.PRNGKey(0), jc,
                                                jnp.bfloat16))
    jc_s = jax.eval_shape(lambda: jtransformer.init_cache(jc, Bn, max_len,
                                                          jnp.bfloat16))
    jlog_s, jcache_s = jax.eval_shape(
        jsteps.make_prefill_step(jc), jp_s,
        jax.ShapeDtypeStruct((Bn, S), jnp.int32), jc_s, jenc_s)
    jtok_s, jcache2_s = jax.eval_shape(
        jsteps.make_serve_step(jc), jp_s,
        jax.ShapeDtypeStruct((Bn, 1), jnp.int32), jcache_s,
        jax.ShapeDtypeStruct((Bn,), jnp.int32), jenc_s)
    assert tuple(tlog.shape) == jlog_s.shape
    assert str(tlog.dtype).split(".")[-1] == jlog_s.dtype.name
    assert tuple(ttok.shape) == jtok_s.shape and ttok.dtype == torch.int32
    for tree, jtree in ((prefilled, jcache_s), (tcache2, jcache2_s)):
        paths, got = flatten(tree)
        want = leaves(jtree)
        assert len(got) == len(want)
        for path, g, w in zip(paths, got, want):
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).split(".")[-1] == w.dtype.name, path
    assert torch.isfinite(tlog.float()).all()
    if arch not in VALUE_ARCHS:
        return
    jp = tree_map(lambda t: _j(t, jnp.bfloat16 if t.dtype == BF16
                               else jnp.float32), params)
    jenc = None if enc is None else _j(enc)
    jlog, jcache = jax.jit(jsteps.make_prefill_step(jc))(
        jp, jnp.asarray(tokens),
        jtransformer.init_cache(jc, Bn, max_len, jnp.bfloat16), jenc)
    jtok, jcache2 = jax.jit(jsteps.make_serve_step(jc))(
        jp, jnp.asarray(_np(nxt).astype(np.int32)), jcache,
        jnp.asarray(_np(pos0).astype(np.int32)), jenc)

    def close(g, w, name):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=STEP_RTOL * np.abs(w).max(),
                                   err_msg=name)
    close(tlog, jlog, "prefill logits")
    for tree, jtree in ((prefilled, jcache), (tcache2, jcache2)):
        for path, g, w in zip(*flatten(tree), leaves(jtree)):
            close(g, w, path)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
