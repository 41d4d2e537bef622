"""Dense flash attention (kernel B6): the CUDA kernel, its plain PyTorch
version, the GQA wrapper, and the launch counts.

Port of ``repro/kernels/flash_attention.py::flash_attention_bh`` and of its
wrapper ``repro/kernels/ops.py::attention``.  Heads are flattened into the
leading axis: q (BH, Sq, hd), k/v (BH, Sk, hd).  Key j is visible to query
row i iff ``j < kv_len`` and, when ``causal``, ``j <= q_offset + i``.
Masked scores are ``NEG_INF = -1e30`` and the softmax denominator is
floored at 1e-30, as in the TPU kernel; accumulation is float32.  The
port computes the function, not the TPU's block structure: it does not
pad Sq or Sk to 128-row blocks.  A row with no visible key (``kv_len`` 0)
lies on no path of the system; the kernel writes zeros there and the
plain version the mean of V.

Dispatch is by the inputs' device, as in ``paged_attention.py``: CPU →
``flash_attention_plain``, CUDA → ``csrc/flash_attention.cu`` or raise.
The kernel takes head dims 32, 64, 112 and 128, and q, k and v all
float32 or all bfloat16 (``KERNEL_DTYPES``; the launch layer's bf16
steps): bf16 inputs are widened to float32 as the kernel stages them, and
the output, in q's dtype, is rounded once from the float32 result, as the
Pallas kernel's ``astype``.  The plain version widens the same inputs
with ``.float()``.  ``COUNTS["kernel"]`` counts
calls that launched the kernel, one per call whether or not a key split
adds a merge launch.

The wrapper picks the kernel's regime from the shape: ``warps_per_rows``
(how many of a block's 8 warps share a 16-row group, each over its own
keys of every tile) from Sq, and ``n_splits`` (key splits per query tile,
merged by ``csrc/split_merge.cuh``) from the query tiles, the longest
row's keys and the SM count.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import bump, plain_here
from repro_torch.kernels.paged_attention import (
    NEG_INF, check_aligned, check_no_grad, check_tensor, sm_count,
    split_workspace)

COUNTS = {"kernel": 0, "plain": 0}

# the head dims csrc/flash_attention.cu is compiled for (112: zamba2's
# shared attention in plain generation), and its input dtypes with their
# launchers (kernels/build.py)
KERNEL_HEAD_DIMS = (32, 64, 112, 128)
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the CUDA kernel's tiles: warps per block, query rows per warp's row
# group, keys per staged tile
WARPS, ROW_GROUP, KEY_TILE = 8, 16, 64


def warps_per_rows(Sq: int) -> int:
    """Warps of a block that share one 16-row group (1, 2, 4 or 8): as
    many as the rows leave idle, so that every warp has work even at Sq 1
    (each takes its own 64 / kw keys of every tile); 1 from 65 rows up,
    where a block holds 128 rows."""
    groups = math.ceil(Sq / ROW_GROUP)
    kw = WARPS
    while kw > 1 and groups > WARPS // kw:
        kw //= 2
    return kw


def rows_per_block(Sq: int) -> int:
    return ROW_GROUP * WARPS // warps_per_rows(Sq)


def longest_row_keys(Sq: int, Sk: int, causal: bool, q_offset: int,
                     kv_len: int) -> int:
    """The most keys any query row sees."""
    n = min(kv_len, Sk)
    return min(n, q_offset + Sq) if causal else n


@functools.lru_cache(maxsize=None)
def n_splits(BH: int, Sq: int, n_keys: int, n_sms: int) -> int:
    """Key splits per query tile: the count that makes the least of waves
    of blocks (one block per SM at a time) times the key tiles a block
    walks plus one (a block's own cost: staging its queries, merging its
    warps, writing its partials), over the longest row's ``n_keys``, the
    fewest splits on a tie.  On an H100 this picks the best, or within 5%
    of the best, of 1 to 14 splits over 1500 keys at 20, 40, 60 and 160
    heads of 1 to 128 rows (6 for one lane's cross-decode step, 4 for
    eight lanes', 2 at 60 heads of 16 rows), and none for the encoder's
    240 tiles, which 2 or 3 splits slow by 20% (PERF.md, PR 17).  A split
    whose share of a tile's keys is empty writes l = 0.  Cached: it runs on
    every launch (12896 in the whisper replay of ``chip_smoke.py``)."""
    tiles = BH * math.ceil(Sq / rows_per_block(Sq))
    key_tiles = max(math.ceil(n_keys / KEY_TILE), 1)
    return min(range(1, key_tiles + 1),
               key=lambda ns: (math.ceil(tiles * ns / n_sms)
                               * (math.ceil(key_tiles / ns) + 1), ns))


def flash_attention_bh(q, k, v, *, causal: bool = True, q_offset: int = 0,
                       kv_len: Optional[int] = None,
                       scale: Optional[float] = None):
    """q: (BH, Sq, hd); k/v: (BH, Sk, hd).  Returns (BH, Sq, hd) in q's
    dtype."""
    check_no_grad("flash_attention_bh", q, k, v)
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    kv_len = Sk if kv_len is None else int(kv_len)
    scale = hd ** -0.5 if scale is None else float(scale)
    if plain_here(q):
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=int(q_offset), kv_len=kv_len,
                                     scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bh: no kernel for {q.device}")
    return _launch(q, k, v, bool(causal), int(q_offset), kv_len, scale)


def _launch(q, k, v, causal, q_offset, kv_len, scale):
    from repro_torch.kernels import build
    dev = q.device
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash_attention_bh: the kernel takes float32 or "
                         f"bfloat16 inputs, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, q.dtype, dev, 3)
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    if k.shape != (BH, Sk, hd) or v.shape != k.shape:
        raise ValueError("flash_attention_bh: inconsistent shapes")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention_bh: the kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    check_aligned("flash_attention_bh", q, k, v)
    kw = warps_per_rows(Sq)
    ns = n_splits(BH, Sq, longest_row_keys(Sq, Sk, causal, q_offset, kv_len),
                  sm_count(dev))
    out = torch.empty_like(q)
    _ws, ws = split_workspace(BH, 1, ns, Sq, hd, dev)
    fn = build.load("flash_attention", KERNEL_DTYPES[q.dtype])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *ws,
            BH, Sq, Sk, hd, int(causal), q_offset, kv_len, scale, kw, ns,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {rc}")
    bump(COUNTS, "kernel")
    return out


def flash_attention_plain(q, k, v, *, causal: bool, q_offset: int,
                          kv_len: int, scale: float):
    """The kernel's function in plain PyTorch: the whole (Sq, Sk) score
    matrix, masked, one softmax."""
    bump(COUNTS, "plain")
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = k_pos < kv_len
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        mask = mask & (k_pos <= q_pos)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              kv_len: Optional[int] = None, scale: Optional[float] = None):
    """Flash attention with GQA (``ops.attention`` of the reference): q
    (B, Sq, H, hd), k/v (B, Sk, KV, hd) with H a multiple of KV.  The KV
    heads are repeated over their query groups and the heads flattened
    into ``flash_attention_bh``'s leading axis.  Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if H != KV:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    Sk = k.shape[1]

    def flat(t, S):
        return t.transpose(1, 2).reshape(B * H, S, hd).contiguous()
    o = flash_attention_bh(flat(q, Sq), flat(k, Sk), flat(v, Sk),
                           causal=causal, q_offset=q_offset, kv_len=kv_len,
                           scale=scale)
    return o.reshape(B, H, Sq, hd).transpose(1, 2).to(q.dtype)
