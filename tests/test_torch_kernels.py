"""Paged kernels of the port (B1 decode, B2 fused prefill, B3 fused verify)
against the JAX
package: the same numpy-seeded inputs go through the JAX Pallas kernels in
interpret mode, the JAX oracles, and the port's plain versions (what the
wrappers run for CPU tensors) and loop oracles.  The CUDA kernels' host-side
regime and split choices and their decompositions of the work (B1-B6) and
3xTF32 products are emulated here in float64 / float32 torch.

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
from repro.kernels.flash_attention import (                     # noqa: E402
    flash_attention_bh as jax_flash_bh)
from repro.kernels.ref import ref_mla_paged_prefill as jax_ref_mla  # noqa: E402
import repro.models.ssm as jssm                                 # noqa: E402
from repro_torch.kernels import flash_attention as fa          # noqa: E402
from repro_torch.kernels import mla_paged_prefill as mk        # noqa: E402
from repro_torch.kernels import paged_attention as pa          # noqa: E402
from repro_torch.kernels import paged_prefill as pp            # noqa: E402
from repro_torch.kernels import paged_verify as pv             # noqa: E402
from repro_torch.kernels import ssd_scan as sk                 # noqa: E402
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
    (2, 4, 4, 112, 16, 3, None),    # zamba2's G 1 at head dim 112
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
    (3, 8, 4, 4, 112, 16, 3, None),  # zamba2's G 1 at head dim 112
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
    """One wave of blocks (one per SM), capped so that a split of the keys
    a lane can hold gives each of a block's 4 warps a 16-key tile."""
    assert pv.n_splits(1, 8, 16, 64, None, 132) == 16   # the spec replay
    assert pv.n_splits(1, 8, 16, 160, None, 132) == 16  # 2000 keys
    assert pv.n_splits(1, 8, 16, 4, None, 132) == 1     # 64 keys: 1 block
    assert pv.n_splits(1, 8, 16, 16, None, 132) == 4
    assert pv.n_splits(1, 8, 16, 400, 4096, 132) == 16
    assert pv.n_splits(1, 8, 16, 400, 40, 132) == 1     # 39 keys: 4 pages
    assert pv.n_splits(2, 3, 16, 64, None, 132) == 16   # smollm's group
    assert pv.n_splits(8, 32, 16, 64, None, 132) == 1
    assert pv.n_splits(64, 32, 16, 64, None, 132) == 1


def test_split_workspace():
    """Scratch in csrc/split_merge.cuh's layout.  With one split B1 and B2
    write the output themselves and get none; every B3 block writes its
    partial for the in-kernel merge, so it asks for scratch
    (direct=False)."""
    shapes = [(2, 3, 5, 8), (2, 3, 5, 8), (2, 3, 5, 8, 64)]
    ws, ptrs = pa.split_workspace(2, 3, 5, 8, 64, "cpu")
    assert [tuple(t.shape) for t in ws] == shapes
    assert ptrs == [t.data_ptr() for t in ws]
    assert pa.split_workspace(2, 3, 1, 8, 64, "cpu") == ([], [None] * 3)
    ws, ptrs = pa.split_workspace(2, 3, 1, 8, 64, "cpu", direct=False)
    assert [tuple(t.shape) for t in ws] == [s[:2] + (1,) + s[3:]
                                            for s in shapes]
    assert ptrs == [t.data_ptr() for t in ws]


# ------------------- the CUDA kernels' decompositions ------------------- #
# The kernels themselves run only on the card; these tests hold their
# host-side split counts and emulate, in float64 torch, the way they cut
# the work (key splits, query tiles, the merge) and the 3xTF32 products.
def test_decode_split_count():
    """B1: about two blocks per SM, capped by the pages a lane can hold
    (the table width, or the pages a window touches)."""
    assert pa.n_splits(8, 3, 16, 256, None, 132) == 11
    assert pa.n_splits(1, 3, 16, 256, None, 132) == 88
    assert pa.n_splits(1, 3, 16, 28, None, 132) == 28
    assert pa.n_splits(8, 20, 16, 28, None, 132) == 2
    assert pa.n_splits(4, 8, 16, 400, 4096, 132) == 9
    assert pa.n_splits(1, 8, 16, 400, 40, 132) == 4    # 39 keys: 4 pages
    assert pa.n_splits(64, 32, 16, 64, None, 132) == 1


def test_prefill_split_count():
    """B2: no split when the query tiles give every SM a block, else
    enough splits for about two blocks per SM, capped by the key tiles a
    query tile can see."""
    assert pp.n_splits(8, 512, 3, 3, 16, 256, None, 132) == 1
    assert pp.n_splits(1, 8, 3, 3, 16, 256, None, 132) == 64
    assert pp.n_splits(1, 8, 3, 3, 16, 16, None, 132) == 4
    assert pp.n_splits(4, 64, 1, 20, 16, 28, None, 132) == 4
    assert pp.n_splits(1, 16, 2, 8, 16, 400, 100, 132) == 2  # 115 keys
    assert pp.n_splits(4, 512, 2, 8, 16, 400, 4096, 132) == 1
    assert pp.n_splits(1, 512, 2, 8, 16, 400, 4096, 132) == 5
    assert pp.n_splits(8, 64, 3, 2, 8, 32, None, 132) == 4


def _partial(q, k, v, valid):
    """One split's (m, l, acc) for query rows q (R, hd) over keys k/v
    (T, hd) with validity (R, T): masked keys contribute exactly 0; a row
    with no valid key keeps m = NEG_INF, l = 0, acc = 0."""
    s = torch.where(valid, q @ k.T, pa.NEG_INF)
    m = s.max(-1).values if s.shape[1] else torch.full(
        (q.shape[0],), pa.NEG_INF, dtype=q.dtype)
    p = torch.where(valid, torch.exp(s - m[:, None]), 0.0)
    return m, p.sum(-1), p @ v


def _merge(parts):
    """The merge launch (csrc/split_merge.cuh): splits with l > 0 only."""
    m = torch.stack([p[0] for p in parts])                  # (ns, R)
    l = torch.stack([p[1] for p in parts])
    acc = torch.stack([p[2] for p in parts])                # (ns, R, hd)
    mx = torch.where(l > 0, m, pa.NEG_INF).max(0).values
    c = torch.where(l > 0, torch.exp(m - mx), 0.0)
    den = (l * c).sum(0).clamp(min=1e-30)
    return (acc * c[..., None]).sum(0) / den[..., None]


def _split_decode(q, kp, vp, table, seq_lens, scale, window, ns):
    """csrc/paged_decode.cu's decomposition: per (lane, KV head) the pages
    [lo, ceil(seq_len / page)) are cut into ns balanced shares, each share
    a partial over its keys, then merged."""
    B, H, hd = q.shape
    _, page, KVH, _ = kp.shape
    G = H // KVH
    out = torch.empty(B, H, hd, dtype=torch.float64)
    for b in range(B):
        n = int(seq_lens[b])
        key_lo = max(n - window, 0) if window else 0
        pg_lo = key_lo // page
        n_pg = max(min((n + page - 1) // page, table.shape[1]) - pg_lo, 0)
        for h in range(KVH):
            qg = q[b, h * G:(h + 1) * G].double() * scale
            parts = []
            for s in range(ns):
                lo = pg_lo + s * n_pg // ns
                hi = pg_lo + (s + 1) * n_pg // ns
                start = max(key_lo, lo * page)
                pos = torch.arange(start, max(start, min(n, hi * page)))
                rows = table[b].long()[pos // page] * page + pos % page
                k = kp.reshape(-1, KVH, hd)[rows, h].double()
                v = vp.reshape(-1, KVH, hd)[rows, h].double()
                parts.append(_partial(qg, k, v, torch.ones(
                    G, len(pos), dtype=torch.bool)))
            out[b, h * G:(h + 1) * G] = _merge(parts)
    return out


@pytest.mark.parametrize("H,KV,hd,page,lens,window", [
    (9, 3, 64, 16, [1, 17, 200], None),
    (4, 4, 32, 8, [5, 64, 33], None),
    (8, 4, 128, 16, [100, 60, 16], 40),
    (4, 4, 112, 16, [1, 60, 33], None),    # zamba2's head dim
])
def test_decode_split_decomposition(H, KV, hd, page, lens, window):
    """Every split count from 1 to past the longest lane's pages (so that
    some shares are empty) gives the plain version's result within 1e-5."""
    B, max_pages = len(lens), 14
    q, _, _, kp, vp, table = _inputs(11, B, 1, H, KV, hd, page, max_pages)
    q, kp, vp, table = _t(q[:, 0], kp, vp, table)
    sl = torch.tensor(lens, dtype=torch.int32)
    want = pa.paged_decode_plain(q, kp, vp, table, sl, scale=hd ** -0.5,
                                 window=window).double()
    for ns in range(1, max(lens) // page + 4):
        got = _split_decode(q, kp, vp, table, sl, hd ** -0.5, window, ns)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)


def _split_prefill(q, kn, vn, kp, vp, table, pos0, clen, scale, window, ns):
    """csrc/paged_prefill.cu's decomposition: per (lane, KV head) the S*G
    rows (position-major) are cut into tiles of ROWS_PER_BLOCK; a tile's
    key range [k_lo, q_last] is cut into KEY_TILE-key tiles shared out
    over ns splits; history keys come from the pages as they were before
    the launch, the chunk's keys from k_new / v_new; split 0 of the tile
    holding a position's first row writes it.  Returns (out, k_pages,
    v_pages), the pools updated in place."""
    B, S, H, hd = q.shape
    _, page, KVH, _ = kp.shape
    G = H // KVH
    R, BM, BN = S * G, pp.ROWS_PER_BLOCK, pp.KEY_TILE
    kp0, vp0 = kp.clone(), vp.clone()
    out = torch.zeros(B, S, H, hd, dtype=torch.float64)
    writes = {}
    for b in range(B):
        p0, n_tok = int(pos0[b]), int(clen[b])
        for h in range(KVH):
            for r0 in range(0, R, BM):
                live_end = min(r0 + BM, R, n_tok * G)
                for i in range(-(-r0 // G), min(-(-(r0 + BM) // G), n_tok)):
                    writes[(b, i, h)] = writes.get((b, i, h), 0) + 1
                    slot = int(table[b, (p0 + i) // page])
                    kp[slot, (p0 + i) % page, h] = kn[b, i, h]
                    vp[slot, (p0 + i) % page, h] = vn[b, i, h]
                if live_end <= r0:
                    continue
                rows = torch.arange(r0, live_end)
                qpos = p0 + rows // G
                k_lo = max(int(qpos[0]) - window + 1, 0) if window else 0
                k_hi = int(qpos[-1]) + 1
                n_tiles = -(-(k_hi - k_lo) // BN)
                qr = q[b, rows // G, h * G + rows % G].double() * scale
                parts = []
                for s in range(ns):
                    t_lo, t_hi = s * n_tiles // ns, (s + 1) * n_tiles // ns
                    kpos = torch.arange(k_lo + t_lo * BN,
                                        min(k_lo + t_hi * BN, k_hi))
                    hist = kpos < p0
                    slots = table[b].long()[kpos.clamp(max=p0 - 1).clamp(
                        min=0) // page]
                    off = kpos.clamp(min=0) % page
                    k = torch.where(hist[:, None], kp0[slots, off, h],
                                    kn[b, (kpos - p0).clamp(min=0), h])
                    v = torch.where(hist[:, None], vp0[slots, off, h],
                                    vn[b, (kpos - p0).clamp(min=0), h])
                    valid = kpos[None] <= qpos[:, None]
                    if window:
                        valid &= kpos[None] > qpos[:, None] - window
                    parts.append(_partial(qr, k.double(), v.double(), valid))
                out[b, rows // G, h * G + rows % G] = _merge(parts)
    assert all(c == 1 for c in writes.values())      # one writer per row
    return out, kp, vp


@pytest.mark.parametrize("S,H,KV,hd,page,pos0,clen,window", [
    (8, 9, 3, 64, 16, [477, 30], [2, 0], None),     # the replay's bucket
    (64, 9, 3, 64, 16, [0, 100], [64, 30], None),   # rows straddle tiles
    (64, 4, 4, 32, 8, [37, 3], [64, 1], None),      # G 1
    (32, 8, 4, 128, 16, [150, 0], [20, 32], 40),    # G 2, a window
    (32, 4, 4, 112, 16, [99, 0], [17, 32], None),   # zamba2's replay bucket
])
def test_prefill_split_decomposition(S, H, KV, hd, page, pos0, clen, window):
    """The kernel's tiling and key splits (1 to more key tiles than a
    query tile sees) give the plain version's output within 1e-5 and its
    pools bit for bit, each chunk row written once."""
    B, max_pages = 2, 40
    q, kn, vn, kp, vp, table = _t(*_inputs(12, B, S, H, KV, hd, page,
                                           max_pages))
    p0 = torch.tensor(pos0, dtype=torch.int32)
    cl = torch.tensor(clen, dtype=torch.int32)
    want, wkp, wvp = pp.prefill_math(q, kn, vn, kp.clone(), vp.clone(),
                                     table, p0, cl, scale=hd ** -0.5,
                                     window=window)
    for ns in (1, 2, 3, 7):
        got, gkp, gvp = _split_prefill(q, kn, vn, kp.clone(), vp.clone(),
                                       table, p0, cl, hd ** -0.5, window, ns)
        torch.testing.assert_close(gkp, wkp, rtol=0, atol=0)
        torch.testing.assert_close(gvp, wvp, rtol=0, atol=0)
        np.testing.assert_allclose(got.numpy(), want.double().numpy(),
                                   atol=ATOL, rtol=0)


def _tf32_rna(x):
    """cvt.rna.tf32.f32: round to nearest (ties away from zero) to 10
    mantissa bits, i.e. the low 13 bits of the float32 cleared."""
    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """What the tensor core reads of a float32 operand: its low 13 bits
    dropped."""
    return (x.float().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _product_3xtf32(a, b):
    """a @ b as csrc/paged_prefill.cu computes it: big = rna(x), small =
    x - big (exact), read as TF32 by truncation; small·big + big·small +
    big·big, each product of TF32 values exact, summed in float32."""
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    as_, bs = _tf32_trunc(a - ab), _tf32_trunc(b - bb)
    return ((as_.double() @ bb.double()).float()
            + (ab.double() @ bs.double()).float()
            + (ab.double() @ bb.double()).float())


@pytest.mark.parametrize("hd", [32, 64, 112, 128])
def test_3xtf32_products_hold_the_card_check(hd):
    """At B2's head dims, scores q·kᵀ (q, k standard normal: |s| up to about
    4 sqrt(hd)) and the attention output P·V from 3xTF32 products stay
    within 2e-5 of float64 (the card check allows 1e-4), while one TF32
    product (the tensor core's plain mode) misses 1e-4."""
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((64, hd)).astype(
        np.float32)) for _ in range(3))
    exact = q.double() @ k.double().T
    s3 = _product_3xtf32(q, k.T)
    one = (_tf32_rna(q).double() @ _tf32_rna(k).double().T)
    assert (s3.double() - exact).abs().max() < 2e-5
    assert (one - exact).abs().max() > 1e-4
    p = torch.softmax(exact * hd ** -0.5, -1)
    o_exact = p @ v.double()
    o3 = _product_3xtf32(p.float(), v)
    assert (o3.double() - o_exact).abs().max() < 2e-5


def _attention_3xtf32(q, k, v, scale):
    """Attention as the tensor-core kernels compute it: scores from 3xTF32
    products, the softmax in float32, P·V from 3xTF32 products."""
    p = torch.softmax(_product_3xtf32(q, k.T) * scale, -1)
    return _product_3xtf32(p, v)


def _attention_f64(q, k, v, scale):
    p = torch.softmax((q.double() @ k.double().T) * scale, -1)
    return p @ v.double()


@pytest.mark.parametrize("hd", [32, 64, 112, 128])
def test_flash_3xtf32_holds_the_card_check(hd):
    """B6's products at its head dims over whisper's 1500 encoder frames:
    a 16-row query tile's output from 3xTF32 scores and P·V stays within
    2e-5 of float64 (the card check allows 1e-4)."""
    rng = np.random.default_rng(100 + hd)
    q = torch.from_numpy(rng.standard_normal((16, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1500, hd)).astype(
        np.float32)) for _ in range(2))
    got = _attention_3xtf32(q, k, v, hd ** -0.5)
    assert (got.double() - _attention_f64(q, k, v, hd ** -0.5)).abs().max() \
        < 2e-5


@pytest.mark.parametrize("n_keys", [135, 256])
def test_mla_3xtf32_holds_the_card_check(n_keys):
    """B4's products at deepseek-v2's widths: 576-wide logits ([q_lat |
    q_rope] against [ckv | krope]) and the 512-wide context against ckv,
    over the replay's 135 keys and a 256-token chunk, within 2e-5 of
    float64 (the card check allows 1e-4); the logits are summed from two
    288-column depth halves, as the kernel's warps form them."""
    rng = np.random.default_rng(n_keys)
    q = torch.from_numpy(rng.standard_normal((16, 576)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((n_keys, 576)).astype(
        np.float32))
    scale = 192 ** -0.5
    s = (_product_3xtf32(q[:, :288], k[:, :288].T)
         + _product_3xtf32(q[:, 288:], k[:, 288:].T))
    got = _product_3xtf32(torch.softmax(s * scale, -1), k[:, :512])
    want = _attention_f64(q, k, k[:, :512], scale)
    assert (got.double() - want).abs().max() < 2e-5


def test_flash_regime_and_split_count():
    """B6: warps sharing a 16-row group by Sq (every warp busy down to one
    row); key splits that make the least of waves of blocks times (key
    tiles per block + 1), the fewest on a tie: none for the encoder."""
    assert [fa.warps_per_rows(s) for s in (1, 16, 17, 32, 33, 64, 65, 1500)] \
        == [8, 8, 4, 4, 2, 2, 1, 1]
    assert [fa.rows_per_block(s) for s in (1, 20, 40, 1500)] \
        == [16, 32, 64, 128]
    assert fa.n_splits(20, 1500, 1500, 132) == 1        # encoder, 240 tiles
    assert fa.n_splits(160, 1, 1500, 132) == 4          # 8-lane decode step
    assert fa.n_splits(20, 1, 1500, 132) == 6           # 1-lane decode step
    assert fa.n_splits(20, 16, 1500, 132) == 6          # 1-lane prefill bucket
    assert fa.n_splits(20, 128, 1500, 132) == 6         # 20 128-row tiles
    assert fa.n_splits(60, 16, 1500, 132) == 2
    assert fa.n_splits(40, 32, 1500, 132) == 3
    assert fa.n_splits(4, 700, 700, 132) == 4
    assert fa.n_splits(160, 20, 200, 132) == 2
    assert fa.n_splits(1280, 1, 1500, 132) == 1
    assert fa.n_splits(20, 1, 64, 132) == 1             # one key tile
    assert fa.n_splits(20, 1, 0, 132) == 1
    assert fa.longest_row_keys(77, 500, True, 200, 260) == 260
    assert fa.longest_row_keys(45, 101, True, 20, 101) == 65
    assert fa.longest_row_keys(1, 1500, False, 0, 9999) == 1500


def test_mla_split_count():
    """B4: one block per SM at most (226 KB of shared memory each): no
    split from 132 row tiles up, else as many splits as fit in one wave,
    capped by the 32-key tiles of the table width."""
    assert mk.n_splits(1, 16, 128, 16, 64, 132) == 2     # the replay: 64 tiles
    assert mk.n_splits(1, 8, 128, 16, 64, 132) == 4
    assert mk.n_splits(1, 256, 128, 16, 32, 132) == 1
    assert mk.n_splits(2, 16, 128, 16, 80, 132) == 1     # 128 tiles
    assert mk.n_splits(1, 1, 128, 16, 2, 132) == 1       # capped: 1 key tile
    assert mk.n_splits(1, 1, 16, 16, 64, 132) == 32


def _fold(parts):
    """The in-block merge of B6's warps that share a row group, in warp
    order: rescale both (m, l, acc) to the larger m and add."""
    m, l, acc = parts[0]
    for mb, lb, accb in parts[1:]:
        mx = torch.maximum(m, mb)
        ca, cb = torch.exp(m - mx), torch.exp(mb - mx)
        m, l, acc = mx, l * ca + lb * cb, acc * ca[:, None] + accb * cb[:, None]
    return m, l, acc


def _split_flash(q, k, v, causal, q_offset, kv_len, ns, kw):
    """csrc/flash_attention.cu's decomposition: query tiles of 16 * 8 / kw
    rows; a tile's key range [0, k_hi) cut into 64-key tiles shared out
    over ns splits; in a split, warp w of a row group takes keys
    [w * 64 / kw, (w + 1) * 64 / kw) of every tile, and the kw partials are
    folded in warp order; the splits then merged as split_merge.cuh does."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    BM, BN = 16 * 8 // kw, fa.KEY_TILE
    n_k = min(kv_len, Sk)
    out = torch.empty(BH, Sq, hd, dtype=torch.float64)
    for bh in range(BH):
        for r0 in range(0, Sq, BM):
            rows = torch.arange(r0, min(r0 + BM, Sq))
            lim = (torch.clamp(q_offset + rows + 1, max=n_k) if causal
                   else torch.full_like(rows, n_k))
            k_hi = int(lim.max())
            n_tiles = -(-k_hi // BN) if k_hi > 0 else 0
            qr = q[bh, rows].double() * (hd ** -0.5)
            parts = []
            for s in range(ns):
                t_lo, t_hi = s * n_tiles // ns, (s + 1) * n_tiles // ns
                warps = []
                for w in range(kw):
                    kpos = torch.cat([torch.arange(t * BN + w * BN // kw,
                                                   t * BN + (w + 1) * BN // kw)
                                      for t in range(t_lo, t_hi)]
                                     + [torch.arange(0)])
                    kpos = kpos[kpos < k_hi]      # the rest are zero-filled
                    warps.append(_partial(qr, k[bh, kpos].double(),
                                          v[bh, kpos].double(),
                                          kpos[None] < lim[:, None]))
                parts.append(_fold(warps))
            out[bh, rows] = _merge(parts)
    return out


@pytest.mark.parametrize("BH,Sq,Sk,hd,causal,q_offset,kv_len", [
    (2, 1, 150, 32, False, 0, 120),         # cross-decode, kv_len < Sk
    (1, 77, 200, 64, True, 100, 150),       # causal at an offset, kv_len
    (1, 150, 150, 32, True, 0, None),       # two query tiles, ragged
    (2, 40, 120, 112, True, 80, None),      # zamba2's head dim
])
def test_flash_split_decomposition(BH, Sq, Sk, hd, causal, q_offset, kv_len):
    """Each warps-per-group count, with key splits from 1 to more than the
    key tiles (so that some shares are empty), and the wrapper's own choice
    give the JAX Pallas kernel's output (interpret mode) within 1e-5."""
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = (rng.standard_normal((BH, n, hd)).astype(np.float32)
               for n in (Sq, Sk, Sk))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    want = np.asarray(jax_flash_bh(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), block_q=Sq, block_k=Sk,
                                   interpret=True, **kw))
    q, k, v = _t(q, k, v)
    kv_len = Sk if kv_len is None else kv_len
    own = (fa.n_splits(BH, Sq, fa.longest_row_keys(Sq, Sk, causal, q_offset,
                                                   kv_len), 132),
           fa.warps_per_rows(Sq))
    for ns, warps in ((1, 1), (3, 4), (7, 8), own):
        got = _split_flash(q, k, v, causal, q_offset, kv_len, ns, warps)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _split_mla(ql, qr, cn, rn, cp, rp, table, pos0, clen, scale, ns):
    """csrc/mla_paged_prefill.cu's decomposition: the S*H rows (position-
    major) cut into tiles of ROWS_PER_BLOCK; a tile's key range [0, last
    live row's position] cut into KEY_TILE-key tiles shared out over ns
    splits, the logits summed from two 288-column depth halves; history
    keys from the pages as they were before the launch, the chunk's from
    ckv_new / krope_new; split 0 of the tile holding a position's first row
    writes it.  Returns (out, ckv_pages, krope_pages), the pools updated in
    place."""
    B, S, H, r = ql.shape
    page = cp.shape[1]
    R, BM, BN = S * H, mk.ROWS_PER_BLOCK, mk.KEY_TILE
    cp0, rp0 = cp.clone(), rp.clone()
    out = torch.zeros(B, S, H, r, dtype=torch.float64)
    writes = {}
    for b in range(B):
        p0, n_tok = int(pos0[b]), int(clen[b])
        for r0 in range(0, R, BM):
            live_end = min(r0 + BM, R, n_tok * H)
            for i in range(-(-r0 // H), min(-(-(r0 + BM) // H), n_tok)):
                writes[(b, i)] = writes.get((b, i), 0) + 1
                slot = int(table[b, (p0 + i) // page])
                cp[slot, (p0 + i) % page] = cn[b, i]
                rp[slot, (p0 + i) % page] = rn[b, i]
            if live_end <= r0:
                continue
            rows = torch.arange(r0, live_end)
            qpos = p0 + rows // H
            k_hi = int(qpos[-1]) + 1
            n_tiles = -(-k_hi // BN)
            q = torch.cat([ql[b, rows // H, rows % H],
                           qr[b, rows // H, rows % H]], -1).double()
            parts = []
            for s in range(ns):
                kpos = torch.arange(s * n_tiles // ns * BN,
                                    min((s + 1) * n_tiles // ns * BN, k_hi))
                hist = kpos < p0
                slots = table[b].long()[kpos.clamp(max=max(p0 - 1, 0)) // page]
                off = kpos % page
                new = (kpos - p0).clamp(min=0)
                kf = torch.cat([
                    torch.where(hist[:, None], cp0[slots, off], cn[b, new]),
                    torch.where(hist[:, None], rp0[slots, off], rn[b, new])],
                    -1).double()
                valid = kpos[None] <= qpos[:, None]
                sc = (q[:, :288] @ kf[:, :288].T + q[:, 288:] @ kf[:, 288:].T)
                sc = torch.where(valid, sc * scale, pa.NEG_INF)
                m = sc.max(-1).values if len(kpos) else torch.full(
                    (len(rows),), pa.NEG_INF, dtype=torch.float64)
                p = torch.where(valid, torch.exp(sc - m[:, None]), 0.0)
                parts.append((m, p.sum(-1), p @ kf[:, :r]))
            out[b, rows // H, rows % H] = _merge(parts)
    assert all(c == 1 for c in writes.values())      # one writer per row
    return out, cp, rp


def test_mla_split_decomposition():
    """The kernel's row tiles and key splits (1 to more than the key tiles,
    so that some shares are empty) give the JAX oracle's output within
    1e-5 on valid rows and its pools bit for bit, each chunk row written
    once.  The mla replay's lane (15 live rows of a 16-row bucket from
    mid-page position 120) at 24 heads, so that row tiles straddle
    positions, beside a masked lane."""
    B, S, H, page, pos0, clen = 2, 16, 24, 16, [120, 0], [15, 0]
    r, rope, max_pages = 512, 64, 10
    rng = np.random.default_rng(S * H)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    n_pages = B * max_pages + 2
    table = rng.permutation(n_pages)[:B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    args = (f(B, S, H, r), f(B, S, H, rope), f(B, S, r), f(B, S, rope),
            f(n_pages, page, r), f(n_pages, page, rope), table)
    p0 = np.array(pos0, np.int32)
    cl = np.array(clen, np.int32)
    scale = 192 ** -0.5
    want, wcp, wrp = jax_ref_mla(*map(jnp.asarray, args), p0, cl,
                                 scale=scale)
    valid = np.arange(S)[None] < cl[:, None]
    for ns in (1, 2, 3, 7, mk.n_splits(B, S, H, page, max_pages, 132)):
        got, gcp, grp = _split_mla(*_t(*args, p0, cl), scale, ns)
        np.testing.assert_array_equal(gcp.numpy(), np.asarray(wcp))
        np.testing.assert_array_equal(grp.numpy(), np.asarray(wrp))
        np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                                   atol=ATOL, rtol=0)
        assert not got.numpy()[~valid].any()


def test_lib_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edited header that a source includes (directly or through
    another header) changes the source's library path; a header it does
    not include does not."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "c.cuh").write_text("int c;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._lib_path("k")
    (tmp_path / "c.cuh").write_text("int c2;\n")
    assert build._lib_path("k") == first
    (tmp_path / "b.cuh").write_text("int b2;\n")
    second = build._lib_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k2;\n')
    assert build._lib_path("k") not in (first, second)


def test_load_configures_each_launcher_once(monkeypatch):
    """``build.load`` loads a library and sets its C signature once; later
    calls return the same configured function with no file or CUDA
    work."""
    from repro_torch.kernels import build
    loads = []

    class Lib:
        def __init__(self, path):
            loads.append(path)
            self.repro_paged_decode_f32 = type("Fn", (), {})()
    monkeypatch.setattr(build, "_FNS", {})
    monkeypatch.setattr(build, "_start", lambda name: None)
    monkeypatch.setattr(build.ctypes, "CDLL", Lib)
    fn = build.load("paged_decode")
    assert build.load("paged_decode") is fn and len(loads) == 1
    assert fn.argtypes == build.SIGNATURES["paged_decode"][1]
    assert fn.restype is build.ctypes.c_int


def _launch_args(kernel, pools):
    """A kernel's ``_launch`` and its CPU arguments at a small shape, with
    the page pools of ``pools`` (dtypes of its two pools)."""
    B, S, H, KV, hd, page, n_pages = 1, 8, 4, 2, 32, 8, 4
    table = torch.zeros(B, 2, dtype=torch.int32)
    p0 = torch.zeros(B, dtype=torch.int32)
    cl = torch.full((B,), 4, dtype=torch.int32)
    if kernel == "mla":
        r, rope = mk.KERNEL_RANK, mk.KERNEL_ROPE
        kp = torch.zeros(n_pages, page, r, dtype=pools[0])
        vp = torch.zeros(n_pages, page, rope, dtype=pools[1])
        return mk, mk._launch, (
            torch.zeros(B, S, H, r), torch.zeros(B, S, H, rope),
            torch.zeros(B, S, r), torch.zeros(B, S, rope), kp, vp, table,
            p0, cl, 1.0)
    kp = torch.zeros(n_pages, page, KV, hd, dtype=pools[0])
    vp = torch.zeros(n_pages, page, KV, hd, dtype=pools[1])
    if kernel == "decode":
        return pa, pa._launch, (torch.zeros(B, H, hd), kp, vp, table,
                                torch.ones(B, dtype=torch.int32), 1.0, None)
    mod = pp if kernel == "prefill" else pv
    kn = torch.zeros(B, S, KV, hd)
    return mod, mod._launch, (torch.zeros(B, S, H, hd), kn, kn.clone(), kp,
                              vp, table, p0, cl, 1.0, None)


@pytest.mark.parametrize("pools", [
    (torch.bfloat16, torch.float32),    # mixed: never one launcher
    (torch.float16, torch.float16),     # the f16 launcher, never f32
    (torch.bfloat16, torch.bfloat16),   # the bf16 launcher, never f32
    (torch.float64, torch.float64),     # no float64 instantiation
], ids=["mixed", "float16", "bf16", "float64"])
@pytest.mark.parametrize("kernel", ["decode", "prefill", "verify", "mla"])
def test_wrapper_page_dtype_checks(kernel, pools, monkeypatch):
    """The CUDA wrappers of B1-B4 take float32, bfloat16 or float16 pools,
    both of one dtype: a bf16 pool with a float32 one, or float64 pools,
    raise before anything is built or launched; bf16 and float16 pools
    ask ``build.load`` for the source's launcher of their dtype."""
    from repro_torch.kernels import build
    asked = []

    def load(name, pages="f32"):
        asked.append((name, pages))
        raise RuntimeError("stop before the launch")
    monkeypatch.setattr(build, "load", load)
    mod, launch, args = _launch_args(kernel, pools)
    monkeypatch.setattr(mod, "sm_count", lambda dev: 132)   # no card here
    n0 = dict(mod.COUNTS)
    variant = {torch.bfloat16: "bf16", torch.float16: "f16"}
    if pools[0] == pools[1] and pools[0] in variant:
        with pytest.raises(RuntimeError, match="stop before"):
            launch(*args)
        assert len(asked) == 1 and asked[0][1] == variant[pools[0]]
        assert asked[0][0] in build.LAUNCHERS[variant[pools[0]]]
    else:
        with pytest.raises(ValueError, match="float32 or all bfloat16"):
            launch(*args)
        assert asked == []
    assert mod.COUNTS == n0


# ------------- B5 and B3 as their redesigned kernels cut them ------------- #
def _ssd_np(B, S, H, P, N, seed, pad=()):
    """numpy inputs at mamba2's scales (chip_smoke's ``ssd_inputs``): x, B
    and C silu outputs of normals, dt = softplus(normal), A =
    -linspace(1, 16), a state of std 0.3; each (lane, first padded
    position) of ``pad`` zeroes dt from there, as the engine's bucket
    padding does."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    silu = lambda a: (a / (1 + np.exp(-a))).astype(np.float32)
    xh, Bm, Cm = silu(f(B, S, H, P)), silu(f(B, S, N)), silu(f(B, S, N))
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)
    for lane, first in pad:
        dt[lane, first:] = 0.0
    A = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    return xh, dt, A, Bm, Cm, 0.3 * f(B, H, P, N)


def _ssd_cut(xh, dt, A, Bm, Cm, chunk, h0, ps, ws):
    """csrc/ssd_scan.cu's cut of the work, in float64: a block per (lane,
    head, slice of ``ps`` state rows) walks the chunks in order with its
    state slice carried; a chunk's rows in 16-row tiles (padded past L,
    masked), a row group of 4 tiles walking the key tiles up to its last
    row tile; C.B^T per tile from a per-(lane, chunk) workspace of the
    lower triangle (``ws``) or recomputed; the incoming state's term from
    the state at the chunk's start; the state update riding on the last
    row group's key walk.  Returns (y, final state)."""
    x, dt, Bm, Cm = (torch.from_numpy(np.asarray(a)).double()
                     for a in (xh, dt, Bm, Cm))
    A = torch.from_numpy(np.asarray(A)).double()
    Bz, S, H, P = x.shape
    N = Bm.shape[-1]
    T, W, L = 16, 4, chunk
    lp = -(-L // T) * T
    n_t = lp // T
    pad = lambda a: torch.cat([a, a.new_zeros((lp - L,) + a.shape[1:])])
    tile = lambda a, i: a[T * i:T * (i + 1)]
    y = torch.zeros(Bz, S, H, P, dtype=torch.float64)
    hT = torch.zeros(Bz, H, P, N, dtype=torch.float64)
    for b in range(Bz):
        cbw = {}                          # the workspace launch
        for c in range(S // L):
            sl = slice(c * L, (c + 1) * L)
            Cc, Bc = pad(Cm[b, sl]), pad(Bm[b, sl])
            for r in range(n_t):
                for kt in range(r + 1):
                    cbw[c, r, kt] = tile(Cc, r) @ tile(Bc, kt).T
        for h in range(H):
            for p0 in range(0, P, ps):
                hs = (torch.zeros(ps, N, dtype=torch.float64) if h0 is None
                      else torch.from_numpy(np.asarray(h0)[b, h, p0:p0 + ps])
                      .double())
                for c in range(S // L):
                    sl = slice(c * L, (c + 1) * L)
                    Cc, Bc = pad(Cm[b, sl]), pad(Bm[b, sl])
                    xc = pad(x[b, sl, h, p0:p0 + ps])
                    seg = pad(torch.cumsum(dt[b, sl, h] * A[h], 0))
                    dtp = pad(dt[b, sl, h])
                    seg_end = seg[L - 1]
                    live = torch.arange(lp) < L
                    ey = torch.where(live, torch.exp(seg), 0.0)
                    cw = torch.where(live, dtp * torch.exp(seg_end - seg), 0.0)
                    h_old, hs = hs, hs * torch.exp(seg_end)
                    for rg in range(-(-n_t // W)):
                        rows = [r for r in range(W * rg, W * rg + W)
                                if r < n_t]
                        ya = {r: torch.zeros(T, ps, dtype=torch.float64)
                              for r in rows}
                        for kt in range(rows[-1] + 1):
                            for r in rows:
                                if kt > r:
                                    continue
                                s = (cbw[c, r, kt] if ws
                                     else tile(Cc, r) @ tile(Bc, kt).T)
                                li = torch.arange(T * r, T * r + T)[:, None]
                                mi = torch.arange(T * kt, T * kt + T)[None]
                                keep = (mi <= li) & (li < L)
                                e = torch.where(keep, seg[li] - seg[mi], 0.0)
                                p = torch.where(
                                    keep, s * torch.exp(e) * dtp[mi], 0.0)
                                ya[r] += p @ tile(xc, kt)
                            if rg == -(-n_t // W) - 1:
                                hs = hs + (tile(xc, kt) * tile(cw, kt)[:, None]
                                           ).T @ tile(Bc, kt)
                        for r in rows:
                            out = ya[r] + tile(ey, r)[:, None] * (
                                tile(Cc, r) @ h_old.T)
                            n = min(T, L - T * r)
                            y[b, c * L + T * r:c * L + T * r + n, h,
                              p0:p0 + ps] = out[:n]
                hT[b, h, p0:p0 + ps] = hs
    return y, hT


_jax_ssd_chunked = jax.jit(jssm.ssd_chunked, static_argnums=(5,))


# B, S, H, P, N, chunk, padding, state rows per block, C.B^T workspace
SSD_CUTS = [
    (2, 48, 3, 32, 16, 24, (), 16, False),        # ragged L, two chunks
    (1, 80, 2, 32, 16, 80, ((0, 50),), 16, True), # 5 row tiles: 2 groups
    (3, 32, 2, 32, 32, 8, ((1, 20), (2, 0)), 16, True),  # a lane all padding
    (1, 32, 2, 64, 64, 16, ((0, 20),), 16, True),  # zamba2's P 64, N 64
]


@pytest.mark.parametrize("B,S,H,P,N,chunk,pad,ps,ws", SSD_CUTS)
def test_ssd_cut_matches_ssd_chunked(B, S, H, P, N, chunk, pad, ps, ws):
    """B5's tiles, slices, workspace and carried state give the JAX
    ``ssd_chunked``'s y and final state from a carried state within 1e-5;
    a lane of padding keeps its state exactly."""
    xh, dt, A, Bm, Cm, h0 = _ssd_np(B, S, H, P, N, seed=S + N, pad=pad)
    wy, wh = _jax_ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)), chunk,
                              jnp.asarray(h0))
    got, hT = _ssd_cut(xh, dt, A, Bm, Cm, chunk, h0, ps, ws)
    np.testing.assert_allclose(got.numpy(), np.asarray(wy), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(wh), atol=ATOL,
                               rtol=ATOL)
    for lane, first in pad:
        if first == 0:
            assert torch.equal(hT[lane], torch.from_numpy(h0[lane]).double())


def test_ssd_cut_matches_pallas_interpret():
    """From a zero state (the TPU kernel's own function), B5's cut with
    ragged 24-token chunks gives the JAX Pallas kernel's y in interpret
    mode within 1e-5."""
    B, S, H, P, N, chunk, pad, ps, ws = SSD_CUTS[0]
    xh, dt, A, Bm, Cm, _ = _ssd_np(B, S, H, P, N, seed=S + N, pad=pad)
    want = np.asarray(ops.ssd(*map(jnp.asarray, (xh, dt, A, Bm, Cm)),
                              chunk=chunk, interpret=True))
    got, _ = _ssd_cut(xh, dt, A, Bm, Cm, chunk, None, ps, ws)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def test_zamba2_widths_plain_versions_match_jax():
    """zamba2-7b's widths through the wrappers' plain versions (what a CPU
    tensor runs): B6 at head dim 112 (32 heads, causal from an offset with
    kv_len < Sk) against the Pallas kernel in interpret mode; B5 at head
    dim 64 and state 64 against the Pallas kernel from a zero state and
    against ``ssd_chunked`` from a carried state (a lane padded with
    dt = 0 from position 20), within 1e-5."""
    rng = np.random.default_rng(112)
    q, k, v = (rng.standard_normal((4, n, 112)).astype(np.float32)
               for n in (24, 90, 90))
    kw = dict(causal=True, q_offset=60, kv_len=80)
    want = np.asarray(jax_flash_bh(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), block_q=24, block_k=90,
                                   interpret=True, **kw))
    n0 = fa.COUNTS["plain"]
    got = fa.flash_attention_bh(*_t(q, k, v), **kw)
    assert fa.COUNTS["plain"] == n0 + 1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)

    B, S, H, P, N, chunk = 2, 48, 3, 64, 64, 16
    xh, dt, A, Bm, Cm, h0 = _ssd_np(B, S, H, P, N, seed=64, pad=((1, 20),))
    ins = (xh, dt, A, Bm, Cm)
    want = np.asarray(ops.ssd(*map(jnp.asarray, ins), chunk=chunk,
                              interpret=True))
    y, _ = sk.ssd_scan(*_t(*ins), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), want, atol=ATOL, rtol=ATOL)
    wy, wh = _jax_ssd_chunked(*map(jnp.asarray, ins), chunk, jnp.asarray(h0))
    y, hT = sk.ssd_scan(*_t(*ins), chunk=chunk, init_state=_t(h0)[0])
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(wh), atol=ATOL,
                               rtol=ATOL)


def _product_3xtf32_acc(a, b):
    """a @ b as mma_tf32.cuh's mma3_acc computes it: the operands split
    as for ``_product_3xtf32`` (big = rna(x), small = x - big read by
    truncation), each 8-deep k-step's three products formed exactly and
    summed apart, then added to the float32 accumulator by a float32
    add."""
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    as_, bs = _tf32_trunc(a - ab), _tf32_trunc(b - bb)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        ks = slice(k, k + 8)
        big = (ab[:, ks].double() @ bb[ks].double()).float()
        small = ((as_[:, ks].double() @ bb[ks].double()).float()
                 + (ab[:, ks].double() @ bs[ks].double()).float())
        acc = acc + (big + small)
    return acc


@pytest.mark.parametrize("N,heads", [(128, 80), (64, 112)])
def test_ssd_3xtf32_holds_the_card_check(N, heads):
    """B5's four products in 3xTF32 (mma3_acc) at ``S512_c128``'s scale:
    512 tokens in chunks of 128 from a carried state, head dim 64 and
    mamba2's state 128 (80 heads) or zamba2's 64 (112 heads), the slowest
    and fastest of the card case's decay rates: y (up to about 125) and
    the final state within the card's 1e-4 of the plain version, which
    forms seg, the decay and dt in float32 as the kernel does."""
    H, P, L, S = 2, 64, 128, 512
    xh, dt, A, Bm, Cm, h0 = _ssd_np(1, S, heads, P, N, seed=5)
    heads = [0, heads - 1]
    xh, dt, A, h0 = xh[:, :, heads], dt[:, :, heads], A[heads], h0[:, heads]
    want_y, want_h = (t.double() for t in sk.ssd_chunked_plain(
        *_t(xh, dt, A, Bm, Cm), L, _t(h0)[0]))
    x, d, Bt, Ct = (torch.from_numpy(a[0]) for a in (xh, dt, Bm, Cm))
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool))
    err_y = err_h = 0.0
    for h in range(H):
        hs = torch.from_numpy(h0[0, h])
        for c in range(S // L):
            sl = slice(c * L, (c + 1) * L)
            seg = torch.cumsum(d[sl, h] * float(A[h]), 0)
            cb = _product_3xtf32_acc(Ct[sl], Bt[sl].T)
            decay = torch.exp(torch.where(mask, seg[:, None] - seg[None], 0.))
            p = torch.where(mask, cb * decay * d[sl, h][None], 0.0)
            y = (_product_3xtf32_acc(p, x[sl, h])
                 + torch.exp(seg)[:, None] * _product_3xtf32_acc(Ct[sl], hs.T))
            w = x[sl, h] * (d[sl, h] * torch.exp(seg[-1] - seg))[:, None]
            hs = hs * torch.exp(seg[-1]) + _product_3xtf32_acc(w.T, Bt[sl])
            err_y = max(err_y, (y.double() - want_y[0, sl, h]).abs().max())
        err_h = max(err_h, (hs.double() - want_h[0, h]).abs().max())
    assert want_y.abs().max() > 50
    assert err_y < 1e-4 and err_h < 1e-4


def test_ssd_regime():
    """B5's C.B^T workspace: above 32 tokens (B * chunks * Lp^2 floats,
    Lp floats a token)."""
    assert [sk.cb_workspace(n) for n in (8, 32, 33, 128, 763, 8192)] == [
        False, False, True, True, True, True]
    assert sk.workspace_floats(1, 512, 128) == 4 * 128 * 128   # 256 KB
    assert sk.workspace_floats(2, 200, 200) == 2 * 208 * 208


def _combine(parts):
    """B3's merge of partials (a block's warps, then the splits):
    split_merge.cuh's weights, the sums left unnormalised: (M, den,
    acc)."""
    m = torch.stack([p[0] for p in parts])
    l = torch.stack([p[1] for p in parts])
    acc = torch.stack([p[2] for p in parts])
    mx = torch.where(l > 0, m, pa.NEG_INF).max(0).values
    c = torch.where(l > 0, torch.exp(m - mx), 0.0)
    return mx, (l * c).sum(0), (acc * c[..., None]).sum(0)


def _verify_cut(q, kn, vn, kp, vp, table, pos0, clen, scale, window, ns,
                order):
    """csrc/paged_verify.cu's cut of the work, in float64: per (lane, KV
    head) ``ns`` splits take balanced shares of the history's pages, cut
    into 16-key tiles aligned to 16 positions (the designated last split
    also takes the window's own keys from k_new / v_new, in tiles of 16);
    warp w of a block folds its tiles w, w + 4, ... in order; the block
    combines its warps; the splits finish in ``order``, each takes a
    ticket, and the one that draws the last merges every split's partial
    in split order.  Returns (out, k_pages, v_pages, merger per pair)."""
    B, S, H, hd = q.shape
    _, page, KVH, _ = kp.shape
    G = H // KVH
    kp0, vp0 = kp.clone(), vp.clone()
    out = torch.zeros(B, S, H, hd, dtype=torch.float64)
    mergers = {}
    for b in range(B):
        p0, n_tok = int(pos0[b]), int(clen[b])
        if n_tok == 0:
            continue
        for i in range(n_tok):                     # the designated split
            slot = int(table[b, (p0 + i) // page])
            kp[slot, (p0 + i) % page] = kn[b, i]
            vp[slot, (p0 + i) % page] = vn[b, i]
        h_lo = max(0, p0 - window + 1) if window else 0
        pg_lo = h_lo // page
        n_pg = max(-(-p0 // page) - pg_lo, 0)
        qpos = p0 + torch.arange(n_tok * G) // G
        for h in range(KVH):
            rows = torch.arange(n_tok * G)
            qr = q[b, rows // G, h * G + rows % G].double() * scale
            blocks = []
            for s in range(ns):
                lo = pg_lo + s * n_pg // ns
                hi = pg_lo + (s + 1) * n_pg // ns
                k_begin = max(h_lo, lo * page)
                k_end = max(min(p0, hi * page), k_begin)
                t_lo = k_begin & ~15
                tiles = []
                if k_end > k_begin:
                    for t0 in range(t_lo, k_end, 16):
                        kpos = torch.arange(t0, t0 + 16)
                        inr = (kpos >= k_begin) & (kpos < k_end)
                        kc = kpos.clamp(k_begin, k_end - 1)
                        slots = table[b].long()[kc // page]
                        tiles.append((kpos, inr, kp0[slots, kc % page, h],
                                      vp0[slots, kc % page, h]))
                if s == ns - 1:
                    for j0 in range(0, n_tok, 16):
                        jj = torch.arange(j0, j0 + 16)
                        jc = jj.clamp(max=n_tok - 1)
                        tiles.append((p0 + jj, jj < n_tok, kn[b, jc, h],
                                      vn[b, jc, h]))
                warps = []
                for w in range(pv.WARPS):
                    part = (torch.full((len(rows),), pa.NEG_INF,
                                       dtype=torch.float64),
                            torch.zeros(len(rows), dtype=torch.float64),
                            torch.zeros(len(rows), hd, dtype=torch.float64))
                    for kpos, inr, k, v in tiles[w::pv.WARPS]:
                        valid = inr[None] & (kpos[None] <= qpos[:, None])
                        if window:
                            valid &= kpos[None] > qpos[:, None] - window
                        part = _fold([part, _partial(qr, k.double(),
                                                     v.double(), valid)])
                    warps.append(part)
                blocks.append(_combine(warps))
            ticket = {s: n for n, s in enumerate(order(ns))}
            mergers[b, h] = max(ticket, key=ticket.get)
            mx, den, acc = _combine(blocks)            # in split order
            out[b, rows // G, h * G + rows % G] = acc / den.clamp(
                min=1e-30)[:, None]
    return out, kp, vp, mergers


@pytest.mark.parametrize("B,S,H,KV,hd,page,max_pages,pos0,clen,window", [
    (1, 8, 4, 2, 32, 16, 8, [100], [2], None),        # the replay's window
    (2, 16, 6, 2, 64, 8, 12, [51, 0], [9, 0], 20),    # masked lane, 2 pages
])                                                    # a tile, a window
def test_verify_cut_matches_jax(B, S, H, KV, hd, page, max_pages, pos0, clen,
                                window):
    """B3's warp tiles, splits (1 to more than the pages, so some shares
    are empty) and last-block merge give the JAX entry point's output in
    interpret mode within 1e-5 and its pools bit for bit; the output does
    not depend on which split finishes last."""
    q, kn, vn, kp, vp, table = _inputs(hd + S, B, S, H, KV, hd, page,
                                       max_pages)
    p0 = np.array(pos0, np.int32)
    cl = np.array(clen, np.int32)
    jout, jkp, jvp = jax_paged_verify(
        *map(jnp.asarray, (q, kn, vn, kp, vp, table, p0, cl)),
        window=window, interpret=True)
    q, kn, vn, kp, vp, table = _t(q, kn, vn, kp, vp, table)
    for ns in (1, 3, max_pages + 2):
        outs, mergers = [], []
        for order in (lambda n: range(n), lambda n: range(n - 1, -1, -1)):
            got, gkp, gvp, merger = _verify_cut(
                q, kn, vn, kp.clone(), vp.clone(), table, p0, cl,
                hd ** -0.5, window, ns, order)
            outs.append(got)
            mergers.append(merger)
            np.testing.assert_array_equal(gkp.numpy(), np.asarray(jkp))
            np.testing.assert_array_equal(gvp.numpy(), np.asarray(jvp))
        assert torch.equal(outs[0], outs[1])
        if ns > 1:
            assert mergers[0] != mergers[1]    # another block merged
        for b in range(B):
            n = int(cl[b])
            np.testing.assert_allclose(outs[0][b, :n].numpy(),
                                       np.asarray(jout[b, :n]), atol=ATOL,
                                       rtol=0)
            assert not outs[0][b, n:].any()
