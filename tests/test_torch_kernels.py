"""Paged kernels of the port (B1 decode, B2 fused prefill, B3 fused verify)
against the JAX
package: the same numpy-seeded inputs go through the JAX Pallas kernels in
interpret mode, the JAX oracles, and the port's plain versions (what the
wrappers run for CPU tensors) and loop oracles.

Tolerances: outputs are float32 and agree to atol 1e-5 on valid rows (the
sums run in another order than XLA's); page pools after a write are
copies and must match bit for bit.  Output rows past ``chunk_len`` are not
compared with JAX: the port defines them as zeros, the Pallas kernel as
attention over the lane's history, and no caller reads them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ops                                  # noqa: E402
from repro.kernels.ref import ref_paged_decode as jax_ref_decode  # noqa: E402
from repro.kernels.ref import ref_paged_prefill as jax_ref_prefill  # noqa: E402
from repro.kernels.paged_prefill import (                       # noqa: E402
    paged_verify_attention as jax_paged_verify)
from repro_torch.kernels import paged_attention as pa          # noqa: E402
from repro_torch.kernels import paged_prefill as pp            # noqa: E402
from repro_torch.kernels import paged_verify as pv             # noqa: E402
from repro_torch.kernels.ref import (ref_paged_decode,         # noqa: E402
                                     ref_paged_prefill)

ATOL = 1e-5


def _inputs(seed, B, S, H, KV, hd, page, max_pages):
    """numpy inputs: q (B,S,H,hd), k/v_new (B,S,KV,hd), pools with 3 spare
    pages, a permuted block table."""
    rng = np.random.default_rng(seed)
    n_pages = B * max_pages + 3
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    table = rng.permutation(n_pages)[:B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    return (f(B, S, H, hd), f(B, S, KV, hd), f(B, S, KV, hd),
            f(n_pages, page, KV, hd), f(n_pages, page, KV, hd), table)


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


# ------------------------------ B1: decode ------------------------------ #
@pytest.mark.parametrize("B,H,KV,hd,page,max_pages,window", [
    (3, 6, 2, 32, 8, 6, None),      # G 3, hd 32, page 8
    (2, 4, 2, 64, 16, 4, None),     # G 2, hd 64, page 16
    (3, 9, 3, 64, 16, 5, 20),       # smollm's group, window over pages
    (3, 4, 2, 32, 8, 6, 7),         # window inside one page
])
def test_decode_matches_jax(B, H, KV, hd, page, max_pages, window):
    q, _, _, kp, vp, table = _inputs(B + hd, B, 1, H, KV, hd, page, max_pages)
    q = q[:, 0]
    lens = np.array([1, page + 3, max_pages * page][:B], np.int32)
    want = np.asarray(ops.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), window=window, interpret=True))
    oracle = np.asarray(jax_ref_decode(jnp.asarray(q), jnp.asarray(kp),
                                       jnp.asarray(vp), table, lens,
                                       window=window))
    tq, tkp, tvp, tt, tl = _t(q, kp, vp, table, lens)
    n0 = pa.COUNTS["plain"]
    got = pa.paged_decode_attention(tq, tkp, tvp, tt, tl, window=window)
    assert pa.COUNTS["plain"] == n0 + 1          # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), oracle, atol=ATOL, rtol=0)
    ref = ref_paged_decode(tq, tkp, tvp, tt, tl, window=window)
    np.testing.assert_allclose(ref.numpy(), oracle, atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_poisoned_pages_do_not_leak(window):
    """Keys past seq_len, below the window and on unmapped pages may hold
    anything: poisoning them leaves the output unchanged."""
    B, H, KV, hd, page, max_pages = 2, 6, 2, 32, 8, 4
    q, _, _, kp, vp, table = _inputs(7, B, 1, H, KV, hd, page, max_pages)
    lens = np.array([11, 26], np.int32)
    tq, tkp, tvp, tt, tl = _t(q[:, 0], kp, vp, table, lens)
    clean = pa.paged_decode_attention(tq, tkp, tvp, tt, tl, window=window)
    pos = np.arange(max_pages * page)
    kpp, vpp = kp.copy(), vp.copy()
    mapped = set(table.ravel().tolist())
    for pid in range(kp.shape[0]):
        if pid not in mapped:
            kpp[pid] = vpp[pid] = 1e4
    for b in range(B):
        bad = pos >= lens[b]
        if window is not None:
            bad |= pos < lens[b] - window
        for i, pid in enumerate(table[b]):
            m = bad.reshape(max_pages, page)[i]
            kpp[pid, m] = vpp[pid, m] = 1e4
    tkp2, tvp2 = _t(kpp, vpp)
    dirty = pa.paged_decode_attention(tq, tkp2, tvp2, tt, tl, window=window)
    np.testing.assert_allclose(dirty.numpy(), clean.numpy(), atol=ATOL, rtol=0)


# --------------------------- B2: fused prefill --------------------------- #
@pytest.mark.parametrize("B,S,H,KV,hd,page,max_pages,window", [
    (3, 8, 6, 2, 32, 8, 4, None),    # G 3, hd 32, page 8, mid-page start
    (3, 16, 4, 2, 64, 16, 3, None),  # G 2, hd 64, page 16
    (3, 12, 6, 2, 32, 8, 6, 5),      # window smaller than the chunk
    (2, 8, 9, 3, 64, 16, 3, 20),     # smollm's group, window over pages
])
def test_prefill_matches_jax(B, S, H, KV, hd, page, max_pages, window):
    """Lanes mix a mid-page start, an aligned start with a padded tail and
    a masked lane (chunk_len 0)."""
    q, kn, vn, kp, vp, table = _inputs(S + hd, B, S, H, KV, hd, page,
                                       max_pages)
    pos0 = np.array([3, page, 0][:B], np.int32)
    clen = np.array([S, S // 2, 0][:B], np.int32)
    jout, jkp, jvp = ops.paged_prefill(
        *map(jnp.asarray, (q, kn, vn, kp, vp, table, pos0, clen)),
        window=window, interpret=True)
    tq, tkn, tvn, tkp, tvp, tt, tp, tc = _t(q, kn, vn, kp, vp, table, pos0,
                                            clen)
    rout, rkp, rvp = ref_paged_prefill(tq, tkn, tvn, tkp, tvp, tt, tp, tc,
                                       window=window)
    n0 = pp.COUNTS["plain"]
    out, kp2, vp2 = pp.paged_prefill_attention(tq, tkn, tvn, tkp, tvp, tt,
                                               tp, tc, window=window)
    assert pp.COUNTS["plain"] == n0 + 1
    assert kp2 is tkp and vp2 is tvp              # pools updated in place
    for got in (kp2, rkp):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jkp))
    for got in (vp2, rvp):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jvp))
    for b in range(B):
        n = int(clen[b])
        for got in (out, rout):
            np.testing.assert_allclose(got[b, :n].numpy(),
                                       np.asarray(jout[b, :n]),
                                       atol=ATOL, rtol=0)
        assert not out[b, n:].any()                # padded rows are zeros


def test_ref_prefill_matches_jax_oracle():
    """The port's loop oracle against the JAX one (kernels/ref.py), with a
    window, a mid-page start and a masked lane."""
    B, S, H, KV, hd, page, max_pages, window = 3, 6, 6, 2, 32, 4, 4, 5
    q, kn, vn, kp, vp, table = _inputs(2, B, S, H, KV, hd, page, max_pages)
    pos0 = np.array([3, page, 0], np.int32)
    clen = np.array([S, S // 2, 0], np.int32)
    wout, wkp, wvp = jax_ref_prefill(
        *map(jnp.asarray, (q, kn, vn, kp, vp)), table, pos0, clen,
        window=window)
    out, rkp, rvp = ref_paged_prefill(*_t(q, kn, vn, kp, vp, table, pos0,
                                          clen), window=window)
    np.testing.assert_array_equal(rkp.numpy(), np.asarray(wkp))
    np.testing.assert_array_equal(rvp.numpy(), np.asarray(wvp))
    for b in range(B):
        n = int(clen[b])
        np.testing.assert_allclose(out[b, :n].numpy(),
                                   np.asarray(wout[b, :n]), atol=ATOL, rtol=0)


def test_prefill_masked_lane_writes_nothing():
    """A padded lane (chunk_len 0) aliases lane 0's block table, as the
    engine pads prefill groups: its rows must never reach the pages."""
    B, S, H, KV, hd, page, max_pages = 2, 8, 4, 2, 32, 4, 4
    q, kn, vn, kp, vp, table = _inputs(3, B, S, H, KV, hd, page, max_pages)
    table[1] = table[0]
    kn[1] = vn[1] = 1e6
    pos0 = np.array([0, 0], np.int32)
    clen = np.array([S, 0], np.int32)
    tq, tkn, tvn, tkp, tvp, tt, tp, tc = _t(q, kn, vn, kp, vp, table, pos0,
                                            clen)
    out, kp2, vp2 = pp.paged_prefill_attention(tq, tkn, tvn, tkp, tvp, tt,
                                               tp, tc)
    _, wkp, wvp = ref_paged_prefill(*_t(q[:1], kn[:1], vn[:1], kp, vp,
                                        table[:1], pos0[:1], clen[:1]))
    np.testing.assert_array_equal(kp2.numpy(), wkp.numpy())
    np.testing.assert_array_equal(vp2.numpy(), wvp.numpy())
    assert np.isfinite(out.numpy()).all()


@pytest.mark.parametrize("window", [None, 3])
def test_prefill_poisoned_and_untouched_pages(window):
    """Positions no query of the chunk may see (past kv_len, below the
    widest window, unmapped pages) may hold anything; pages outside the
    write set come back untouched."""
    B, S, H, KV, hd, page, max_pages = 2, 8, 4, 2, 32, 4, 6
    q, kn, vn, kp, vp, table = _inputs(5, B, S, H, KV, hd, page, max_pages)
    pos0 = np.array([5, 0], np.int32)
    clen = np.array([S, S], np.int32)
    tq, tkn, tvn, tt, tp, tc = _t(q, kn, vn, table, pos0, clen)
    clean, kp_after, _ = pp.paged_prefill_attention(
        tq, tkn, tvn, *_t(kp, vp), tt, tp, tc, window=window)
    written = set()
    for b in range(B):
        for i in range(int(clen[b])):
            written.add(int(table[b, (pos0[b] + i) // page]))
    for pid in range(kp.shape[0]):
        if pid not in written:
            np.testing.assert_array_equal(kp_after[pid].numpy(), kp[pid])
    pos = np.arange(max_pages * page)
    kpp, vpp = kp.copy(), vp.copy()
    mapped = set(table.ravel().tolist())
    for pid in range(kp.shape[0]):
        if pid not in mapped:
            kpp[pid] = vpp[pid] = 1e4
    for b in range(B):
        bad = pos >= pos0[b] + S
        if window is not None:
            bad |= pos <= pos0[b] - window
        for i, pid in enumerate(table[b]):
            m = bad.reshape(max_pages, page)[i]
            kpp[pid, m] = vpp[pid, m] = 1e4
    dirty, _, _ = pp.paged_prefill_attention(
        tq, tkn, tvn, *_t(kpp, vpp), tt, tp, tc, window=window)
    np.testing.assert_allclose(dirty.numpy(), clean.numpy(), atol=ATOL,
                               rtol=0)


def test_prefill_then_decode_sees_the_chunk():
    """The decode path reads what the prefill wrote: decoding the chunk's
    last query over the written pages equals the prefill's last row (same
    query, same keys)."""
    B, S, H, KV, hd, page, max_pages = 1, 9, 6, 2, 32, 8, 2
    q, kn, vn, kp, vp, table = _inputs(11, B, S, H, KV, hd, page, max_pages)
    tq, tkn, tvn, tkp, tvp, tt = _t(q, kn, vn, kp, vp, table)
    zero = torch.zeros(1, dtype=torch.int32)
    full, _, _ = pp.paged_prefill_attention(
        tq, tkn, tvn, tkp.clone(), tvp.clone(), tt, zero,
        torch.tensor([S], dtype=torch.int32))
    pp.paged_prefill_attention(tq, tkn, tvn, tkp, tvp, tt, zero,
                               torch.tensor([S], dtype=torch.int32))
    dec = pa.paged_decode_attention(tq[:, S - 1].contiguous(), tkp, tvp, tt,
                                    torch.tensor([S], dtype=torch.int32))
    np.testing.assert_allclose(dec.numpy(), full[:, S - 1].numpy(),
                               atol=ATOL, rtol=0)


# ---------------------------- B3: fused verify --------------------------- #
@pytest.mark.parametrize("B,S,H,KV,hd,page,max_pages,pos0,clen,window", [
    (1, 8, 4, 2, 32, 8, 6, [11], [5], None),          # mid-page, clen < S
    (2, 16, 6, 2, 32, 8, 5, [19, 0], [9, 0], None),   # S 16, masked lane
    (1, 16, 4, 2, 64, 16, 4, [37], [9], 20),          # window over pages
])
def test_verify_matches_jax(B, S, H, KV, hd, page, max_pages, pos0, clen,
                            window):
    """The verify window (sl + 1 rows, bucketed to S) over a paged
    history: the port's plain version against the JAX entry point in
    interpret mode; pools bit-equal, padded rows zeros."""
    q, kn, vn, kp, vp, table = _inputs(S + hd + B, B, S, H, KV, hd, page,
                                       max_pages)
    pos0 = np.array(pos0, np.int32)
    clen = np.array(clen, np.int32)
    jout, jkp, jvp = jax_paged_verify(
        *map(jnp.asarray, (q, kn, vn, kp, vp, table, pos0, clen)),
        window=window, interpret=True)
    n0 = dict(pv.COUNTS)
    out, kp2, vp2 = pv.paged_verify_attention(
        *_t(q, kn, vn, kp, vp, table, pos0, clen), window=window)
    assert pv.COUNTS == {"kernel": n0["kernel"], "plain": n0["plain"] + 1}
    np.testing.assert_array_equal(kp2.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(vp2.numpy(), np.asarray(jvp))
    for b in range(B):
        n = int(clen[b])
        np.testing.assert_allclose(out[b, :n].numpy(), np.asarray(jout[b, :n]),
                                   atol=ATOL, rtol=0)
        assert not out[b, n:].any()


def test_verify_split_count():
    """About two blocks per SM, capped by the pages a lane can hold."""
    assert pv.n_splits(1, 8, 16, 64, None, 132) == 33
    assert pv.n_splits(1, 8, 16, 4, None, 132) == 4
    assert pv.n_splits(1, 8, 16, 400, 4096, 132) == 33
    assert pv.n_splits(1, 8, 16, 400, 40, 132) == 4    # 39 keys: 4 pages
    assert pv.n_splits(8, 32, 16, 64, None, 132) == 2
    assert pv.n_splits(64, 32, 16, 64, None, 132) == 1
