"""Fused chunked-prefill paged attention (kernel B2): the CUDA kernel, its
plain PyTorch version, and the launch counts.

Port of ``repro/kernels/paged_prefill.py::paged_prefill_attention``.  One
call per layer per prefill group writes the chunk's K/V rows into the
lanes' pool pages (row i of lane b lands at position ``pos0[b] + i``, only
for ``i < chunk_len[b]``; a lane with ``chunk_len`` 0 writes nothing) and
attends, causally and with an optional sliding window, over the paged
history plus the chunk.  The pools are updated IN PLACE and returned, the
counterpart of the TPU kernel's input/output aliasing.

Output rows at ``i >= chunk_len[b]`` (bucket padding, masked lanes) are
zeros in both versions; the TPU kernel leaves them as attention over the
lane's history, which no caller reads.

Pools are float32, bfloat16 or float16, both of one dtype
(``paged_attention.py``): a 16-bit write rounds each row to nearest even,
and the chunk attends over its own rows as written (rounded), as the
reference reads them back from its pages.  ``q``, ``k_new``, ``v_new`` and the output are float32.

Dispatch is by the inputs' device, as in ``paged_attention.py``:
CPU → plain version, CUDA → ``csrc/paged_prefill.cu`` or raise.
``COUNTS["kernel"]`` counts calls that launched the kernel, one per call
whatever number of launches (a key split adds a merge launch).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import bump, plain_here
from repro_torch.kernels.paged_attention import (
    BLOCKS_PER_SM, NEG_INF, check_aligned, check_head_dim, check_no_grad,
    check_pages, check_tensor, sm_count, split_workspace)

COUNTS = {"kernel": 0, "plain": 0}

# the CUDA kernel's tiles: query rows ((position, group member) pairs of
# one KV head, position-major) per block, and keys per staged tile
ROWS_PER_BLOCK = 128
KEY_TILE = 64


def n_splits(B: int, S: int, G: int, KVH: int, page: int, max_pages: int,
             window: Optional[int], n_sms: int) -> int:
    """Key splits per (lane, KV head, query tile).  One when the query
    tiles alone give every SM a block (long chunks: there the merge launch
    costs more than the split gains); otherwise enough for about
    ``BLOCKS_PER_SM`` blocks per SM, capped by the key tiles one query
    tile can see (the table width, or a window plus the chunk).  The host
    does not know the lanes' positions without a sync; each split takes a
    balanced share of its tile's key range on the device, and a split whose
    share is empty writes l = 0."""
    target = BLOCKS_PER_SM * n_sms
    tiles = B * KVH * math.ceil(S * G / ROWS_PER_BLOCK)
    if tiles >= n_sms:
        return 1
    keys = max_pages * page
    if window is not None:
        keys = min(keys, window + S - 1)
    cap = math.ceil(keys / KEY_TILE)
    return max(1, min(math.ceil(target / tiles), cap))


def paged_prefill_attention(q, k_new, v_new, k_pages, v_pages, block_table,
                            pos0, chunk_len, *, scale: Optional[float] = None,
                            window: Optional[int] = None,
                            split_heads: Optional[int] = None):
    """q: (B, S, H, hd); k_new/v_new: (B, S, KVH, hd); k/v_pages:
    (n_pages, page, KVH, hd), written in place; block_table: (B, max_pages)
    int32; pos0/chunk_len: (B,) int32.  Returns (out (B, S, H, hd),
    k_pages, v_pages).  ``split_heads``: the KV head count the split rule
    reads (default KVH; a mesh shard passes the unsharded count, as for
    ``paged_decode_attention``)."""
    B, S, H, hd = q.shape
    KVH = k_pages.shape[2]
    if H % KVH:
        raise ValueError(f"{H} query heads do not group over {KVH} KV heads")
    check_no_grad("paged_prefill_attention", q, k_new, v_new, k_pages, v_pages)
    scale = hd ** -0.5 if scale is None else float(scale)
    if plain_here(q):
        return paged_prefill_plain(q, k_new, v_new, k_pages, v_pages,
                                   block_table, pos0, chunk_len, scale=scale,
                                   window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_prefill_attention: no kernel for {q.device}")
    return _launch(q, k_new, v_new, k_pages, v_pages, block_table, pos0,
                   chunk_len, scale, window, split_heads)


def _launch(q, k_new, v_new, k_pages, v_pages, block_table, pos0, chunk_len,
            scale, window, split_heads=None):
    from repro_torch.kernels import build
    dev = q.device
    check_tensor("q", q, torch.float32, dev, 4)
    check_tensor("k_new", k_new, torch.float32, dev, 4)
    check_tensor("v_new", v_new, torch.float32, dev, 4)
    pages = check_pages("paged_prefill_attention", dev, 4, k_pages=k_pages,
                        v_pages=v_pages)
    check_tensor("block_table", block_table, torch.int32, dev, 2)
    check_tensor("pos0", pos0, torch.int32, dev, 1)
    check_tensor("chunk_len", chunk_len, torch.int32, dev, 1)
    B, S, H, hd = q.shape
    n_pages, page, KVH, hd_k = k_pages.shape
    if hd_k != hd or k_new.shape != (B, S, KVH, hd) \
            or v_new.shape != k_new.shape or v_pages.shape != k_pages.shape \
            or block_table.shape[0] != B or pos0.shape[0] != B \
            or chunk_len.shape[0] != B:
        raise ValueError("paged_prefill_attention: inconsistent shapes")
    G = H // KVH
    check_head_dim("paged_prefill_attention", hd)
    check_aligned("paged_prefill_attention", q, k_new, v_new, k_pages,
                  v_pages)
    max_pages = block_table.shape[1]
    ns = n_splits(B, S, G, split_heads or KVH, page, max_pages, window,
                  sm_count(dev))
    out = torch.empty_like(q)
    _ws, ws = split_workspace(B, KVH, ns, S * G, hd, dev)
    fn = build.load("paged_prefill", pages)
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
            pos0.data_ptr(), chunk_len.data_ptr(), out.data_ptr(), *ws,
            B, S, H, KVH, hd, page, max_pages, scale,
            -1 if window is None else int(window), ns,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_prefill kernel launch failed: CUDA error {rc}")
    bump(COUNTS, "kernel")
    return out, k_pages, v_pages


def paged_prefill_plain(q, k_new, v_new, k_pages, v_pages, block_table, pos0,
                        chunk_len, *, scale: float,
                        window: Optional[int] = None):
    """The kernel's function in plain PyTorch (``prefill_math``)."""
    bump(COUNTS, "plain")
    return prefill_math(q, k_new, v_new, k_pages, v_pages, block_table, pos0,
                        chunk_len, scale=scale, window=window)


def prefill_math(q, k_new, v_new, k_pages, v_pages, block_table, pos0,
                 chunk_len, *, scale: float, window: Optional[int] = None):
    """Scatter the chunk's rows into the pages (in place, rounded to the
    pools' dtype), gather each lane's stream (widened to float32: the
    chunk's own rows as written), masked softmax; the plain version of B2
    and of B3.
    The scatter selects the written rows with a boolean mask, which waits
    on the device; this arithmetic is never on the CUDA main path."""
    B, S, H, hd = q.shape
    _, page, KVH, _ = k_pages.shape
    G = H // KVH
    dev = q.device
    i = torch.arange(S, device=dev)
    pos = pos0.long()[:, None] + i[None, :]                     # (B, S)
    valid = i[None, :] < chunk_len.long()[:, None]
    slot = (pos // page).clamp(0, block_table.shape[1] - 1)
    pid = torch.gather(block_table.long(), 1, slot)
    flat = (pid * page + pos % page)[valid]
    k_pages.view(-1, KVH, hd)[flat] = k_new[valid].to(k_pages.dtype)
    v_pages.view(-1, KVH, hd)[flat] = v_new[valid].to(v_pages.dtype)

    idx = block_table.long()
    k = k_pages[idx].reshape(B, -1, KVH, hd).float()            # (B, T, ...)
    v = v_pages[idx].reshape(B, -1, KVH, hd).float()
    qf = q.float().reshape(B, S, KVH, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k) * scale
    q_pos = pos[:, :, None]                                     # (B, S, 1)
    k_pos = torch.arange(k.shape[1], device=dev)[None, None, :]
    kv_len = (pos0.long() + chunk_len.long())[:, None, None]
    m = (k_pos < kv_len) & (k_pos <= q_pos)
    if window is not None:
        m &= k_pos > q_pos - window
    s = torch.where(m[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v).reshape(B, S, H, hd)
    out = torch.where(valid[:, :, None, None], out, 0.0)
    return out.to(q.dtype), k_pages, v_pages
