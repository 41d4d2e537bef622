"""Fused speculative-verify paged attention (kernel B3): the CUDA kernel,
its plain PyTorch version, and the launch counts.

Port of ``repro/kernels/paged_prefill.py::paged_verify_attention``.  The
target model scores a verify window of ``sl + 1`` tokens (the last emitted
token and the draft's ``sl`` proposals) over its paged history.  That is
the fused chunked prefill's function (``paged_prefill.py``): same
arguments, same result, pools written in place and returned, output rows
at ``i >= chunk_len[b]`` zeros.  The shape is what differs, a few rows
over a long history, so the CUDA kernel (``csrc/paged_verify.cu``) spreads
the history's 16-key tiles over the warps of ``n_splits`` blocks per
(lane, KV head), and the last block of each pair to finish merges the
pair's splits: one launch per call.

Pools are float32, bfloat16 or float16, both of one dtype, as for B2.
Dispatch is by the inputs' device: CPU → plain version, CUDA → the kernel
or raise.  The kernel takes head dims that are multiples of 4 up to 128.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import bump, plain_here
from repro_torch.kernels.paged_attention import (
    check_aligned, check_no_grad, check_pages, check_tensor, sm_count,
    split_workspace)
from repro_torch.kernels.paged_prefill import prefill_math

COUNTS = {"kernel": 0, "plain": 0}

# the CUDA kernel's tiles: warps per block, keys per warp tile; its widest
# head dim
WARPS, KEY_TILE, MAX_HEAD_DIM = 4, 16, 128
# blocks in flight the split count aims at, per SM: one (the kernel's
# registers allow two, but more splits only add partials for the merge to
# read: an H100 sweep put one block per SM first at the spec replay's
# window and over 2000 keys; PERF.md)
BLOCKS_PER_SM = 1

# per device: the int32 tickets of the in-kernel merge, one per (lane, KV
# head), zero between launches (each launch's last block resets its own)
_COUNTERS: dict = {}
_COUNTERS_LOCK = threading.Lock()   # mesh shards launch from threads


def n_splits(B: int, KVH: int, page: int, max_pages: int,
             window: Optional[int], n_sms: int) -> int:
    """Key splits per (lane, KV head): at most ``BLOCKS_PER_SM`` blocks per
    SM in flight (one wave), capped so that a split of the keys a lane can
    hold (the table width, or the pages a window of ``window`` keys can
    touch) gives each of a block's warps a 16-key tile.  The host does not
    know the lanes' lengths without a sync; each split takes a balanced
    share of its lane's own pages on the device, and a split whose share
    is empty carries l = 0."""
    cap = max_pages
    if window is not None:
        cap = min(cap, (window - 1 + page - 1) // page + 1)
    cap = math.ceil(cap * page / (WARPS * KEY_TILE))
    return max(1, min(BLOCKS_PER_SM * n_sms // (B * KVH), cap))


def merge_counters(n: int, dev) -> torch.Tensor:
    """At least ``n`` zeroed int32 tickets on ``dev``, allocated once (and
    again only to grow), not per call."""
    with _COUNTERS_LOCK:
        c = _COUNTERS.get(dev)
        if c is None or c.numel() < n:
            c = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
            _COUNTERS[dev] = c
    return c


def paged_verify_attention(q, k_new, v_new, k_pages, v_pages, block_table,
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
    check_no_grad("paged_verify_attention", q, k_new, v_new, k_pages, v_pages)
    scale = hd ** -0.5 if scale is None else float(scale)
    if plain_here(q):
        return paged_verify_plain(q, k_new, v_new, k_pages, v_pages,
                                  block_table, pos0, chunk_len, scale=scale,
                                  window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_verify_attention: no kernel for {q.device}")
    return _launch(q, k_new, v_new, k_pages, v_pages, block_table, pos0,
                   chunk_len, scale, window, split_heads)


def _launch(q, k_new, v_new, k_pages, v_pages, block_table, pos0, chunk_len,
            scale, window, split_heads=None):
    from repro_torch.kernels import build
    dev = q.device
    check_tensor("q", q, torch.float32, dev, 4)
    check_tensor("k_new", k_new, torch.float32, dev, 4)
    check_tensor("v_new", v_new, torch.float32, dev, 4)
    pages = check_pages("paged_verify_attention", dev, 4, k_pages=k_pages,
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
        raise ValueError("paged_verify_attention: inconsistent shapes")
    if hd % 4 or hd > MAX_HEAD_DIM:
        raise ValueError(f"paged_verify_attention: the CUDA kernel takes "
                         f"head dims that are multiples of 4 up to "
                         f"{MAX_HEAD_DIM}, not {hd}")
    check_aligned("paged_verify_attention", q, k_new, v_new, k_pages, v_pages)
    ns = n_splits(B, split_heads or KVH, page, block_table.shape[1], window,
                  sm_count(dev))
    # every block writes its partial, even with one split
    _ws, ws = split_workspace(B, KVH, ns, S * (H // KVH), hd, dev,
                              direct=False)
    counters = merge_counters(B * KVH, dev)
    out = torch.empty_like(q)
    fn = build.load("paged_verify", pages)
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
            pos0.data_ptr(), chunk_len.data_ptr(), *ws, counters.data_ptr(),
            out.data_ptr(),
            B, S, H, KVH, hd, page, block_table.shape[1], scale,
            -1 if window is None else int(window), ns,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_verify kernel launch failed: CUDA error {rc}")
    bump(COUNTS, "kernel")
    return out, k_pages, v_pages


def paged_verify_plain(q, k_new, v_new, k_pages, v_pages, block_table, pos0,
                       chunk_len, *, scale: float,
                       window: Optional[int] = None):
    """The kernel's function in plain PyTorch: the fused prefill's plain
    arithmetic (scatter the window's rows, gather, masked softmax)."""
    bump(COUNTS, "plain")
    return prefill_math(q, k_new, v_new, k_pages, v_pages, block_table, pos0,
                        chunk_len, scale=scale, window=window)
