"""Fused MLA latent-page chunked prefill (kernel B4): the CUDA kernel, its
plain PyTorch version, and the launch counts.

Port of ``repro/kernels/paged_prefill.py::mla_paged_prefill_attention``.
One call per MLA layer per prefill group writes the chunk's headless
latent rows (``ckv``, r floats, and ``krope``, rope floats, per token,
shared by every head) into the lanes' pool pages (row i of lane b lands at
position ``pos0[b] + i``, only for ``i < chunk_len[b]``; a lane with
``chunk_len`` 0 writes nothing) and runs causal attention of every query
row against the lane's latent stream: logits
``(q_lat . ckv + q_rope . krope) * scale``, the context accumulated in
latent space; the caller up-projects it through ``w_uv`` and ``wo``.  The
pools are updated IN PLACE and returned.  MLA has no sliding window.

Output rows at ``i >= chunk_len[b]`` (bucket padding, masked lanes) are
zeros in both versions, as for B2; the TPU kernel leaves them as attention
over the lane's history, which no caller reads.

The latent pools are float32, bfloat16 or float16, both of one dtype
(``paged_attention.py``): a 16-bit write rounds each row to nearest even,
and the chunk attends over its own rows as written.  The queries, the new
rows and the output are float32.

Dispatch is by the inputs' device, as in ``paged_attention.py``:
CPU → plain version, CUDA → ``csrc/mla_paged_prefill.cu`` or raise.  The
kernel is built for deepseek-v2's latent widths (r 512, rope 64); other
widths raise on the card.  ``COUNTS["kernel"]`` counts calls that
launched the kernel, one per call whether or not a key split adds a merge
launch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import bump, plain_here
from repro_torch.kernels.paged_attention import (
    NEG_INF, check_aligned, check_no_grad, check_pages, check_tensor,
    sm_count, split_workspace)

COUNTS = {"kernel": 0, "plain": 0}

# the latent widths csrc/mla_paged_prefill.cu is compiled for
KERNEL_RANK, KERNEL_ROPE = 512, 64
# the CUDA kernel's tiles: query rows ((position, head) pairs,
# position-major) per block, and keys per staged tile
ROWS_PER_BLOCK = 32
KEY_TILE = 32


def n_splits(B: int, S: int, H: int, page: int, max_pages: int,
             n_sms: int) -> int:
    """Key splits per row tile.  A block takes 226 KB of shared memory, so
    one runs per SM: one split when the row tiles alone give every SM a
    block (a 256-token chunk: 1024 tiles), otherwise as many as keep the
    grid within one block per SM (the replay's one-lane 16-row bucket: 64
    tiles, 2 splits), capped by the key tiles of the table width.  The
    host does not know the lanes' positions without a sync; each split
    takes a balanced share of its tile's key range on the device, and a
    split whose share is empty writes l = 0."""
    tiles = B * math.ceil(S * H / ROWS_PER_BLOCK)
    if tiles >= n_sms:
        return 1
    return max(1, min(n_sms // tiles, math.ceil(max_pages * page / KEY_TILE)))


def mla_paged_prefill_attention(q_lat, q_rope, ckv_new, krope_new, ckv_pages,
                                krope_pages, block_table, pos0, chunk_len, *,
                                scale: float,
                                split_heads: Optional[int] = None):
    """q_lat: (B, S, H, r) absorbed queries (``q_nope . w_uk``); q_rope:
    (B, S, H, rope); ckv_new: (B, S, r); krope_new: (B, S, rope);
    ckv/krope_pages: (n_pages, page, r | rope), written in place;
    block_table: (B, max_pages) int32; pos0/chunk_len: (B,) int32.
    Returns (ctx_lat (B, S, H, r), ckv_pages, krope_pages).
    ``split_heads``: the head count the split rule reads (default H; a
    mesh shard holds H / n heads and passes the unsharded count, so that
    every head runs the key split of the unsharded call)."""
    check_no_grad("mla_paged_prefill_attention", q_lat, q_rope, ckv_new,
                  krope_new, ckv_pages, krope_pages)
    if plain_here(q_lat):
        return mla_paged_prefill_plain(q_lat, q_rope, ckv_new, krope_new,
                                       ckv_pages, krope_pages, block_table,
                                       pos0, chunk_len, scale=scale)
    if q_lat.device.type != "cuda":
        raise RuntimeError(
            f"mla_paged_prefill_attention: no kernel for {q_lat.device}")
    return _launch(q_lat, q_rope, ckv_new, krope_new, ckv_pages, krope_pages,
                   block_table, pos0, chunk_len, float(scale), split_heads)


def _launch(q_lat, q_rope, ckv_new, krope_new, ckv_pages, krope_pages,
            block_table, pos0, chunk_len, scale, split_heads=None):
    from repro_torch.kernels import build
    dev = q_lat.device
    check_tensor("q_lat", q_lat, torch.float32, dev, 4)
    check_tensor("q_rope", q_rope, torch.float32, dev, 4)
    check_tensor("ckv_new", ckv_new, torch.float32, dev, 3)
    check_tensor("krope_new", krope_new, torch.float32, dev, 3)
    pages = check_pages("mla_paged_prefill_attention", dev, 3,
                        ckv_pages=ckv_pages, krope_pages=krope_pages)
    check_tensor("block_table", block_table, torch.int32, dev, 2)
    check_tensor("pos0", pos0, torch.int32, dev, 1)
    check_tensor("chunk_len", chunk_len, torch.int32, dev, 1)
    B, S, H, r = q_lat.shape
    n_pages, page, rope = krope_pages.shape
    if q_rope.shape != (B, S, H, rope) or ckv_new.shape != (B, S, r) \
            or krope_new.shape != (B, S, rope) \
            or ckv_pages.shape != (n_pages, page, r) \
            or block_table.shape[0] != B or pos0.shape[0] != B \
            or chunk_len.shape[0] != B:
        raise ValueError("mla_paged_prefill_attention: inconsistent shapes")
    if (r, rope) != (KERNEL_RANK, KERNEL_ROPE):
        raise ValueError(
            f"mla_paged_prefill_attention: the kernel takes r {KERNEL_RANK} "
            f"and rope {KERNEL_ROPE}, got r {r} and rope {rope}")
    check_aligned("mla_paged_prefill_attention", q_lat, q_rope, ckv_new,
                  krope_new, ckv_pages, krope_pages)
    max_pages = block_table.shape[1]
    ns = n_splits(B, S, split_heads or H, page, max_pages, sm_count(dev))
    out = torch.empty_like(q_lat)
    _ws, ws = split_workspace(B, 1, ns, S * H, r, dev)
    fn = build.load("mla_paged_prefill", pages)
    rc = fn(q_lat.data_ptr(), q_rope.data_ptr(), ckv_new.data_ptr(),
            krope_new.data_ptr(), ckv_pages.data_ptr(), krope_pages.data_ptr(),
            block_table.data_ptr(), pos0.data_ptr(), chunk_len.data_ptr(),
            out.data_ptr(), *ws, B, S, H, r, rope, page, max_pages, scale, ns,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"mla_paged_prefill kernel launch failed: CUDA error {rc}")
    bump(COUNTS, "kernel")
    return out, ckv_pages, krope_pages


def mla_paged_prefill_plain(q_lat, q_rope, ckv_new, krope_new, ckv_pages,
                            krope_pages, block_table, pos0, chunk_len, *,
                            scale: float):
    """The kernel's function in plain PyTorch: scatter the chunk's latent
    rows into the pages (in place), gather each lane's latent stream,
    masked two-term softmax.  The scatter selects the written rows with a
    boolean mask, which waits on the device; this arithmetic is never on
    the CUDA main path."""
    bump(COUNTS, "plain")
    B, S, H, r = q_lat.shape
    _, page, rope = krope_pages.shape
    dev = q_lat.device
    i = torch.arange(S, device=dev)
    pos = pos0.long()[:, None] + i[None, :]                     # (B, S)
    valid = i[None, :] < chunk_len.long()[:, None]
    slot = (pos // page).clamp(0, block_table.shape[1] - 1)
    pid = torch.gather(block_table.long(), 1, slot)
    flat = (pid * page + pos % page)[valid]
    ckv_pages.view(-1, r)[flat] = ckv_new[valid].to(ckv_pages.dtype)
    krope_pages.view(-1, rope)[flat] = krope_new[valid].to(krope_pages.dtype)

    idx = block_table.long()
    cs = ckv_pages[idx].reshape(B, -1, r).float()               # (B, T, r)
    rs = krope_pages[idx].reshape(B, -1, rope).float()
    s = (torch.einsum("bqhr,btr->bhqt", q_lat.float(), cs)
         + torch.einsum("bqhc,btc->bhqt", q_rope.float(), rs)) * scale
    q_pos = pos[:, :, None]                                     # (B, S, 1)
    k_pos = torch.arange(cs.shape[1], device=dev)[None, None, :]
    kv_len = (pos0.long() + chunk_len.long())[:, None, None]
    m = (k_pos < kv_len) & (k_pos <= q_pos)                     # (B, S, T)
    s = torch.where(m[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqt,btr->bqhr", p, cs)
    out = torch.where(valid[:, :, None, None], out, 0.0)
    return out.to(q_lat.dtype), ckv_pages, krope_pages
