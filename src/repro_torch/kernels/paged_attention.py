"""Paged decode attention (kernel B1): the CUDA kernel, its plain PyTorch
version, and the launch counts.

Port of ``repro/kernels/paged_attention.py::paged_decode_attention``.  One
query token per lane attends over a KV history scattered across pages
addressed by a block table; with ``window`` the query at position
``seq_len - 1`` sees only keys at positions ``>= seq_len - window``.

``paged_decode_attention`` dispatches on the device of its inputs, never
on what happens to be installed: CPU tensors run the plain version, CUDA
tensors launch the hand-written kernel in ``csrc/paged_decode.cu`` (or
raise), anything else raises, but for meta tensors (shapes only) inside
``kernels.shapes_only()``, which run the plain version (the dry run).  ``COUNTS["kernel"]`` counts calls that
launched the kernel (one per call, whether the call splits the keys and
adds a merge launch or not) and ``COUNTS["plain"]`` calls of the plain
version, so a run can show which of the two its main path went through.

The kernel splits each lane's pages over ``n_splits`` blocks per (lane,
KV head) and merges the splits in a second launch.

Pools may be float32, bfloat16 or float16 (``PAGE_DTYPES``; the
engine's ``EngineConfig.dtype``), both of one dtype: the CUDA kernel has
an instantiation for each and widens 16-bit rows to fp32 as it reads
them; the plain version does the same with ``.float()``.  ``q`` and the
output are float32, or both bfloat16 over bfloat16 pools (the
reference's all-bf16 kernel case; the output is rounded once from the
float32 result).  Any other pool dtype, two pools of different dtypes,
or another query dtype raise on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import bump, plain_here

NEG_INF = -1e30

COUNTS = {"kernel": 0, "plain": 0}

# blocks in flight the split count aims at, per SM of the card
BLOCKS_PER_SM = 2
# head dims the CUDA kernels B1 and B2 are built for (112: zamba2's
# shared attention), and B1's largest GQA group
HEAD_DIMS = (32, 64, 112, 128)
MAX_GROUP = 8

# page dtypes the CUDA kernels B1-B4 are built for, and the launcher of
# each (kernels/build.py: "f32", or a variant of LAUNCHERS)
PAGE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16"}

_SMS: dict[int, int] = {}


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of ``dev``, asked of CUDA once."""
    n = _SMS.get(dev.index)
    if n is None:
        n = torch.cuda.get_device_properties(dev).multi_processor_count
        _SMS[dev.index] = n
    return n


def n_splits(B: int, KVH: int, page: int, max_pages: int,
             window: Optional[int], n_sms: int) -> int:
    """Key splits per (lane, KV head): about ``BLOCKS_PER_SM`` blocks per
    SM in flight, capped by the pages a lane can hold (the table width, or
    the pages a window of ``window`` keys can touch).  The host does not
    know the lanes' lengths without a sync; each split takes a balanced
    share of its lane's own pages on the device, and a split whose share is
    empty writes l = 0."""
    cap = max_pages
    if window is not None:
        cap = min(cap, (window - 1 + page - 1) // page + 1)
    return max(1, min(math.ceil(BLOCKS_PER_SM * n_sms / (B * KVH)), cap))


def paged_decode_attention(q, k_pages, v_pages, block_table, seq_lens, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None,
                           split_heads: Optional[int] = None):
    """q: (B, H, hd); k/v_pages: (n_pages, page, KVH, hd); block_table:
    (B, max_pages) int32; seq_lens: (B,) int32, each >= 1; window: sliding
    window in tokens (None = full causal).  Returns (B, H, hd) in q's dtype,
    accumulated in float32.  The pools are float32, bfloat16 or float16;
    on the card q is float32, or bfloat16 over bfloat16 pools.
    ``split_heads``: the KV head count the split rule reads (default KVH).
    A mesh shard holds KVH / n heads and passes the unsharded count, so
    that every head runs the key split, and so the summation order, of
    the unsharded call."""
    B, H, hd = q.shape
    KVH = k_pages.shape[2]
    if H % KVH:
        raise ValueError(f"{H} query heads do not group over {KVH} KV heads")
    check_no_grad("paged_decode_attention", q, k_pages, v_pages)
    scale = hd ** -0.5 if scale is None else float(scale)
    if plain_here(q):
        return paged_decode_plain(q, k_pages, v_pages, block_table, seq_lens,
                                  scale=scale, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_decode_attention: no kernel for {q.device}")
    return _launch(q, k_pages, v_pages, block_table, seq_lens, scale, window,
                   split_heads)


def check_no_grad(kernel: str, *ts) -> None:
    """Refuse inputs that autograd would differentiate through, on every
    device.  The CUDA kernels are called through ``ctypes`` and have no
    backward: their outputs carry no autograd history, so a weight ahead
    of one would silently get its gradient through the residual stream
    only.  Training takes the plain branches of ``models/`` (``train=True``)
    instead, as the reference trains through XLA, never a Pallas kernel."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ts):
        raise RuntimeError(f"{kernel}: an input requires grad; the kernel has "
                           "no backward (train with train=True)")


def check_tensor(name, t, dtype, device, ndim):
    if t.device != device or t.dtype != dtype or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {ndim}-d {dtype} tensor on {device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def check_pages(kernel: str, dev, ndim: int, **pools) -> str:
    """Check the page pools a CUDA kernel reads and writes: contiguous,
    ``ndim``-d, on ``dev``, all of one dtype of ``PAGE_DTYPES``.  Returns
    that dtype's launcher ("f32", "bf16" or "f16").  A 16-bit pool never
    reaches a float32 launcher: there is no conversion and no fallback."""
    dtypes = {t.dtype for t in pools.values()}
    if len(dtypes) != 1 or not dtypes <= PAGE_DTYPES.keys():
        got = ", ".join(f"{n} {t.dtype}" for n, t in pools.items())
        raise ValueError(f"{kernel}: the pools must be all float16, all "
                         f"float32 or all bfloat16, got {got}")
    dtype = dtypes.pop()
    for name, t in pools.items():
        check_tensor(name, t, dtype, dev, ndim)
    return PAGE_DTYPES[dtype]


def check_head_dim(kernel: str, hd: int) -> None:
    """Refuse a head dim the CUDA kernel is not built for, before launching."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"{kernel}: the CUDA kernel takes head dims "
                         f"{HEAD_DIMS}, not {hd}")


def check_aligned(kernel: str, *ts) -> None:
    """16-byte loads need 16-byte aligned rows (hd is a multiple of 4)."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{kernel}: tensors must start 16-byte aligned")


def split_workspace(B: int, KVH: int, ns: int, R: int, hd: int, dev, *,
                    direct: bool = True):
    """Scratch for the partial (m, l, acc) of R query rows per (lane, KV
    head) and key split (``csrc/split_merge.cuh``'s layout): the tensors,
    which the caller keeps alive until the launch is queued, and their
    pointers.  With one split and ``direct`` (the kernel then writes the
    output itself) there is no scratch: null pointers."""
    if ns == 1 and direct:
        return [], [None] * 3
    m = torch.empty((B, KVH, ns, R), dtype=torch.float32, device=dev)
    ws = [m, torch.empty_like(m),
          torch.empty((B, KVH, ns, R, hd), dtype=torch.float32, device=dev)]
    return ws, [t.data_ptr() for t in ws]


def _launch(q, k_pages, v_pages, block_table, seq_lens, scale, window,
            split_heads=None):
    from repro_torch.kernels import build
    dev = q.device
    pages = check_pages("paged_decode_attention", dev, 4, k_pages=k_pages,
                        v_pages=v_pages)
    # bf16 queries (and output) only over bf16 pools
    bf16q = pages == "bf16" and q.dtype == torch.bfloat16
    check_tensor("q", q, torch.bfloat16 if bf16q else torch.float32, dev, 3)
    check_tensor("block_table", block_table, torch.int32, dev, 2)
    check_tensor("seq_lens", seq_lens, torch.int32, dev, 1)
    B, H, hd = q.shape
    n_pages, page, KVH, hd_k = k_pages.shape
    if hd_k != hd or v_pages.shape != k_pages.shape \
            or block_table.shape[0] != B or seq_lens.shape[0] != B:
        raise ValueError("paged_decode_attention: inconsistent shapes")
    G = H // KVH
    check_head_dim("paged_decode_attention", hd)
    if G > MAX_GROUP:
        raise ValueError(f"paged_decode_attention: the CUDA kernel takes GQA "
                         f"groups of at most {MAX_GROUP}, not {G}")
    check_aligned("paged_decode_attention", q, k_pages, v_pages)
    max_pages = block_table.shape[1]
    ns = n_splits(B, split_heads or KVH, page, max_pages, window,
                  sm_count(dev))
    out = torch.empty_like(q)
    _ws, ws = split_workspace(B, KVH, ns, G, hd, dev)
    fn = build.load("paged_decode", "bf16q" if bf16q else pages)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), *ws,
            B, H, KVH, hd, page, max_pages, scale,
            -1 if window is None else int(window), ns,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {rc}")
    bump(COUNTS, "kernel")
    return out


def paged_decode_plain(q, k_pages, v_pages, block_table, seq_lens, *,
                       scale: float, window: Optional[int] = None):
    """The kernel's function in plain PyTorch: gather each lane's pages,
    then a masked softmax over the whole gathered stream."""
    bump(COUNTS, "plain")
    B, H, hd = q.shape
    _, page, KVH, _ = k_pages.shape
    G = H // KVH
    idx = block_table.long()
    k = k_pages[idx].reshape(B, -1, KVH, hd).float()        # (B, T, KVH, hd)
    v = v_pages[idx].reshape(B, -1, KVH, hd).float()
    qf = q.float().reshape(B, KVH, G, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qf, k) * scale
    pos = torch.arange(k.shape[1], device=q.device)[None, :]
    lens = seq_lens.long()[:, None]
    valid = pos < lens
    if window is not None:
        valid &= pos >= lens - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v)
    return out.reshape(B, H, hd).to(q.dtype)
