"""Oracles for every kernel, ported from ``repro/kernels/ref.py``
(``ref_attention_bh``, ``ref_paged_decode``, ``ref_paged_prefill``,
``ref_mla_paged_prefill`` and ``ref_ssd``).

They are the slowest, most obviously right versions: one lane at a time,
one written row at a time, a full softmax over the gathered stream; the
SSD recurrence one token at a time.  The
tests hold the kernels' plain versions against them and against the JAX
oracles on the same inputs.  Unlike the kernels they never write in place:
the prefill oracles return updated copies of the pools.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ref_attention_bh(q, k, v, *, causal=True, q_offset=0, kv_len=None,
                     scale=None):
    """Dense attention, one (bh) row block at a time.  q: (BH, Sq, hd);
    k/v: (BH, Sk, hd); key j is visible to row i iff j < kv_len and, when
    causal, j <= q_offset + i."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    kv_len = Sk if kv_len is None else kv_len
    scale = hd ** -0.5 if scale is None else scale
    q_pos = q_offset + torch.arange(Sq)[:, None]
    k_pos = torch.arange(Sk)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    out = []
    for b in range(BH):
        s = (q[b].float() @ k[b].float().T) * scale
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        out.append(p @ v[b].float())
    return torch.stack(out).to(q.dtype)


def ref_paged_decode(q, k_pages, v_pages, block_table, seq_lens, *,
                     scale=None, window=None):
    """q: (B, H, hd); k/v_pages: (n_pages, page, KVH, hd); block_table:
    (B, max_pages); seq_lens: (B,); window: the query at ``seq_len - 1``
    sees keys at positions ``>= seq_len - window``."""
    B, H, hd = q.shape
    _, page, KVH, _ = k_pages.shape
    max_pages = block_table.shape[1]
    G = H // KVH
    scale = hd ** -0.5 if scale is None else scale
    pos = torch.arange(max_pages * page)
    out = []
    for b in range(B):
        rows = block_table[b].long()
        ks = k_pages[rows].reshape(max_pages * page, KVH, hd)
        vs = v_pages[rows].reshape(max_pages * page, KVH, hd)
        ks = ks.repeat_interleave(G, dim=1).float()       # (T, H, hd)
        vs = vs.repeat_interleave(G, dim=1).float()
        s = torch.einsum("hd,shd->hs", q[b].float(), ks) * scale
        valid = pos < int(seq_lens[b])
        if window is not None:
            valid &= pos >= int(seq_lens[b]) - window
        s = torch.where(valid[None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("hs,shd->hd", p, vs))
    return torch.stack(out).to(q.dtype)


def ref_paged_prefill(q, k_new, v_new, k_pages, v_pages, block_table, pos0,
                      chunk_len, *, scale=None, window=None):
    """Unfused oracle: scatter the chunk's K/V rows into copies of the
    pages, gather each lane's stream, run masked attention.  Returns
    (out (B, S, H, hd), k_pages', v_pages')."""
    B, S, H, hd = q.shape
    _, page, KVH, _ = k_pages.shape
    max_pages = block_table.shape[1]
    G = H // KVH
    scale = hd ** -0.5 if scale is None else scale
    kp, vp = k_pages.clone(), v_pages.clone()
    for b in range(B):
        for i in range(int(chunk_len[b])):
            p = int(pos0[b]) + i
            pid = int(block_table[b, p // page])
            kp[pid, p % page] = k_new[b, i].to(kp.dtype)
            vp[pid, p % page] = v_new[b, i].to(vp.dtype)
    k_pos = torch.arange(max_pages * page)[None, :]
    out = []
    for b in range(B):
        rows = block_table[b].long()
        ks = kp[rows].reshape(max_pages * page, KVH, hd)
        vs = vp[rows].reshape(max_pages * page, KVH, hd)
        ks = ks.repeat_interleave(G, dim=1).float()
        vs = vs.repeat_interleave(G, dim=1).float()
        s = torch.einsum("qhd,shd->hqs", q[b].float(), ks) * scale
        q_pos = int(pos0[b]) + torch.arange(S)[:, None]
        mask = (k_pos < int(pos0[b]) + int(chunk_len[b])) & (k_pos <= q_pos)
        if window is not None:
            mask &= k_pos > q_pos - window
        s = torch.where(mask[None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("hqs,shd->qhd", p, vs))
    return torch.stack(out).to(q.dtype), kp, vp


def ref_mla_paged_prefill(q_lat, q_rope, ckv_new, krope_new, ckv_pages,
                          krope_pages, block_table, pos0, chunk_len, *,
                          scale):
    """Unfused oracle of the MLA latent-page prefill: scatter the chunk's
    headless ckv / krope rows into copies of the pages, gather each lane's
    latent stream, run the two-term (nope + rope) masked attention in
    latent space.  q_lat: (B, S, H, r); q_rope: (B, S, H, rope); ckv_new:
    (B, S, r); krope_new: (B, S, rope); ckv/krope_pages: (n_pages, page,
    r | rope).  Returns (ctx_lat (B, S, H, r), ckv_pages', krope_pages')."""
    B, S, H, r = q_lat.shape
    _, page, _ = ckv_pages.shape
    max_pages = block_table.shape[1]
    cp, rp = ckv_pages.clone(), krope_pages.clone()
    for b in range(B):
        for i in range(int(chunk_len[b])):
            p = int(pos0[b]) + i
            pid = int(block_table[b, p // page])
            cp[pid, p % page] = ckv_new[b, i].to(cp.dtype)
            rp[pid, p % page] = krope_new[b, i].to(rp.dtype)
    k_pos = torch.arange(max_pages * page)[None, :]
    out = []
    for b in range(B):
        rows = block_table[b].long()
        cs = cp[rows].reshape(max_pages * page, r).float()
        rs = rp[rows].reshape(max_pages * page, -1).float()
        s = (torch.einsum("qhr,sr->hqs", q_lat[b].float(), cs)
             + torch.einsum("qhc,sc->hqs", q_rope[b].float(), rs)) * scale
        q_pos = int(pos0[b]) + torch.arange(S)[:, None]
        mask = (k_pos < int(pos0[b]) + int(chunk_len[b])) & (k_pos <= q_pos)
        s = torch.where(mask[None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("hqs,sr->qhr", p, cs))
    return torch.stack(out).to(q_lat.dtype), cp, rp


def ref_ssd(xh, dt, A, Bm, Cm, init_state=None):
    """Sequential (token-by-token) SSD recurrence.  xh: (B, S, H, P); dt:
    (B, S, H); A: (H,); Bm / Cm: (B, S, N).  Returns (y (B, S, H, P),
    final_state (B, H, P, N)) in float32."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    h = (torch.zeros(Bsz, H, P, N, device=xh.device) if init_state is None
         else init_state.float())
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A[None, :])                     # (B, H)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, t].float(),
                           Bm[:, t].float(), xh[:, t].float())
        h = h * dA[..., None, None] + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), h))
    return torch.stack(ys, dim=1), h
