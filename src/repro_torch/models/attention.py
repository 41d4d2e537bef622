"""Attention mixers (port of ``repro/models/attention.py``): GQA
self-attention over paged KV (RoPE, qk-norm, sliding window),
cross-attention (``cross_attn_forward``) and MLA (DeepSeek-V2 multi-head
latent attention, ``mla_forward``).

Three execution modes share ``attn_forward``:
  * no cache (``cache=None``): causal, or bidirectional with
    ``causal=False``, attention over the chunk;
  * dense (``cache = {"k", "v"}``): fixed-capacity buffers (B, S_max, KVH,
    hd) from ``transformer.init_cache``, written at ``pos0`` in place and
    attended through the masked ``sdpa`` (or ``sdpa_chunked``), as in the
    reference, which keeps this layout for naive references and
    training-time evaluation;
  * paged (``cache = {"k_pages", "v_pages"}``): page pools addressed by
    per-lane block tables.  A multi-token chunk goes to the fused prefill
    kernel (B2, ``kernels/paged_prefill.py``), which writes the chunk's KV
    into the pages and attends in one launch; a speculative-decoding verify
    window (``verify=True``) goes to the fused verify kernel (B3,
    ``kernels/paged_verify.py``), the same function split over the history
    for a few rows.  A decode token is written
    by the plain ``paged_write`` scatter and attends through the paged
    decode kernel (B1, ``kernels/paged_attention.py``).

Pools are updated in place: ``attn_forward`` returns the same tensors it
was given.  They are float32, bfloat16 or float16 (``EngineConfig.dtype``)
and are passed to the kernels as they are: a 16-bit pool takes each
written row rounded to nearest even (the kernels' in-kernel writes and
``paged_write``'s ``.to(pages.dtype)`` alike) and is widened to float32
where it is read, so queries, new rows and outputs stay float32.  Every
pool the engine owns ends in one WRITE-OFF page
(``pages[-1]``) that no block table maps: ``paged_write`` routes masked
rows there.  JAX drops them with ``mode="drop"``; torch has no such mode,
and routing them to "the old value" would race with lane 0's real write,
since padded decode lanes repeat lane 0's slot.  The write-off page keeps
the scatter free of host syncs.

No-cache attention (plain generation, whisper's encoder) and every
cross-attention (``cross_attn_forward``: whisper's decoder, the VLM's image
layers) run through the dense flash attention kernel (B6,
``kernels/flash_attention.py``), causal or bidirectional; a windowed
no-cache call takes the reference's plain branch (the masked ``sdpa``, or
``sdpa_chunked``), since B6 has no window.

``train=True`` is the training forward.  The kernels are called through
``ctypes`` and have no backward, so it takes the reference's own no-cache
branches line for line: ``sdpa_chunked`` when ``cfg.attn_impl`` is
"chunked" and the chunk is longer than ``cfg.attn_chunk``, else the masked
``sdpa`` (causal, windowed or bidirectional); cross-attention takes
``sdpa`` too.  The caller chooses it (``model_forward(train=True)``);
nothing switches on grad mode, and every kernel wrapper refuses an input
that requires grad.

``OP_STATS`` keeps the reference's keys, but the port runs eagerly and
counts per call, where JAX counts once per traced program (and under a
mesh once per shard: each shard's thread adds its own, under a lock).

``shard`` (a mesh shard's ``ShardCtx``, ``distributed/sharding.py``):
the weights hold this shard's heads, so the head counts are read from
them, and the per-head context is all-gathered before the replicated
``wo`` (``attn_output``; MLA inside ``mla_forward``).  Each paged kernel
is told the unsharded head count for its key-split rule
(``split_heads``): a shard with fewer heads would pick more splits and
merge its partial sums in another order.  For training, every replicated
tensor that feeds a shard's heads passes ``shard.enter`` (the identity;
its gradient is summed over the shards): the input rows, Qwen3's q/k
norm scales, and MLA's latents and query down-projection.  Under
``shard.seq`` (sequence-sharded decode over a dense cache, the dry run's
``long_500k``) each data shard holds a slice of the cache's positions,
writes the rows that fall in it, attends over it, and the shards' partial
(sum, max, denominator) triples are merged by log-sum-exp in shard order
(``seq_sharded_attention``), the rule of ``csrc/split_merge.cuh``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import bump
from repro_torch.kernels.flash_attention import attention
from repro_torch.kernels.mla_paged_prefill import mla_paged_prefill_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill import paged_prefill_attention
from repro_torch.kernels.paged_verify import paged_verify_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, matmul_promoted, promote,
                                       rms_head_norm)

NEG_INF = -1e30

OP_STATS = {"paged_write": 0, "prefill_attn": 0, "fused_prefill": 0,
            "verify_write": 0, "verify_attn": 0, "fused_verify": 0}


# ----------------------------- dense KV --------------------------------- #
def dense_write(buf, vals, pos0):
    """Write a chunk's per-token rows into fixed buffers, in place: buf
    (B, S_max, ...), vals (B, S, ...), lane b at offsets pos0[b] (B,).  A
    start past S_max - S is clamped to it, as the reference's
    ``lax.dynamic_update_slice`` clamps it."""
    B, S = vals.shape[:2]
    start = pos0.long().clamp(0, buf.shape[1] - S)
    idx = start[:, None] + torch.arange(S, device=buf.device)[None, :]
    buf[torch.arange(B, device=buf.device)[:, None], idx] = vals.to(buf.dtype)
    return buf


# ----------------------------- paged KV --------------------------------- #
def paged_write(pages, vals, block_table, pos0, chunk_len):
    """Scatter a chunk's per-token vectors into KV pages, in place.

    pages: (P + 1, page, ...) whose last page is the write-off page;
    vals: (B, S, ...); block_table: (B, max_pages); pos0 / chunk_len:
    (B,) int32.  Token i of lane b lands at global position pos0[b] + i
    of the lane's block table; rows at or past chunk_len[b] go to the
    write-off page.  No host sync."""
    bump(OP_STATS, "paged_write")
    P1, page = pages.shape[:2]
    B, S = vals.shape[:2]
    tail = pages.shape[2:]
    i = torch.arange(S, device=vals.device)
    pos = pos0.long()[:, None] + i[None, :]                      # (B, S)
    slot = (pos // page).clamp(0, block_table.shape[1] - 1)
    pid = torch.gather(block_table.long(), 1, slot)
    flat = pid * page + pos % page
    valid = i[None, :] < chunk_len.long()[:, None]
    flat = torch.where(valid, flat, (P1 - 1) * page)             # write-off
    pages.view((P1 * page,) + tail).index_copy_(
        0, flat.reshape(-1), vals.to(pages.dtype).reshape((B * S,) + tail))
    return pages


def paged_gather(pages, block_table):
    """Each lane's logical KV stream: (P, page, ...) x (B, max_pages) ->
    (B, max_pages * page, ...)."""
    g = pages[block_table.long()]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


# ------------------------------ init ----------------------------------- #
def init_attn(gen, cfg: ModelConfig, dtype=torch.float32, device=None,
              cross: bool = False):
    """GQA weights with the reference's shapes and scales, from ``gen``; a
    cross-attention block (``cross``) has no q/k norm and a ``gate``
    scalar (the VLM's tanh gate, 0 at init)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def normal(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype, device=device)
    s = d ** -0.5
    p = {"wq": normal(d, h, hd) * s,
         "wk": normal(d, kv, hd) * s,
         "wv": normal(d, kv, hd) * s,
         "wo": normal(h, hd, d) * (h * hd) ** -0.5}
    if cfg.use_bias:
        p["bq"] = torch.zeros(h, hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(kv, hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(kv, hd, dtype=dtype, device=device)
        p["bo"] = torch.zeros(d, dtype=dtype, device=device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
    if cross:
        p["gate"] = torch.zeros((), dtype=torch.float32, device=device)
    return p


# ----------------------------- core math -------------------------------- #
def sdpa(q, k, v, mask, scale: Optional[float] = None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); mask: (B, 1, Sq, Sk) bool."""
    H, hd = q.shape[2], q.shape[3]
    KV = k.shape[2]
    if H != KV:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    scale = scale if scale is not None else hd ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_mask(B, Sq, Sk, pos0, kv_len, window: Optional[int] = None):
    """Query i (global position pos0 + i) sees key j iff j <= pos0 + i,
    j < kv_len and, with a window, j > pos0 + i - window.  pos0, kv_len:
    (B,) int.  Returns (B, 1, Sq, Sk) bool."""
    dev = pos0.device
    q_pos = pos0[:, None] + torch.arange(Sq, device=dev)[None, :]
    k_idx = torch.arange(Sk, device=dev)[None, None, :]
    m = k_idx <= q_pos[:, :, None]
    m &= k_idx < kv_len[:, None, None]
    if window is not None:
        m &= k_idx > q_pos[:, :, None] - window
    return m[:, None, :, :]


def sdpa_chunked(q, k, v, *, pos0, kv_len, window=None, causal=True,
                 chunk: int = 1024, scale=None):
    """Flash-style attention in plain PyTorch: a loop over key chunks with
    a running (max, denominator, accumulator), so no (Sq, Sk) score matrix
    is built at once; the reference's ``sdpa_chunked``, whose
    ``lax.scan`` becomes a Python loop.  q: (B, Sq, H, hd); k/v: (B, Sk,
    KV, hd); pos0 / kv_len: (B,) int.  Key j is visible to query i iff j <
    kv_len, and with ``causal`` j <= pos0 + i, and with a window j > pos0
    + i - window.  Keys are zero-padded to a whole number of chunks."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if H != KV:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    scale = hd ** -0.5 if scale is None else scale
    chunk = min(chunk, Sk)
    if Sk % chunk:
        pad = chunk - Sk % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        Sk += pad
    dev = q.device
    qf = q.float() * scale
    q_pos = pos0[:, None] + torch.arange(Sq, device=dev)[None, :]  # (B, Sq)
    m = torch.full((B, H, Sq, 1), NEG_INF, device=dev)
    l = torch.zeros(B, H, Sq, 1, device=dev)
    acc = torch.zeros(B, H, Sq, hd, device=dev)
    for c0 in range(0, Sk, chunk):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k[:, c0:c0 + chunk].float())
        k_pos = c0 + torch.arange(chunk, device=dev)[None, None, :]
        mask = k_pos < kv_len[:, None, None]
        if causal:
            mask = mask & (k_pos <= q_pos[:, :, None])
        if window is not None:
            mask = mask & (k_pos > q_pos[:, :, None] - window)
        s = torch.where(mask[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p,
                                         v[:, c0:c0 + chunk].float())
        m = m_new
    out = acc / l.clamp(min=1e-30)
    return out.transpose(1, 2).to(q.dtype)                 # (B, Sq, H, hd)


# --------------------------- self-attention ----------------------------- #
def attn_forward(p, x, cfg: ModelConfig, *, positions, cache=None,
                 pos0=None, block_tables=None, chunk_len=None, verify=False,
                 causal: bool = True, train: bool = False, shard=None):
    """Returns (ctx (B, Sq, H, hd), cache).

    cache: None (no cache kept: causal, or bidirectional with
    ``causal=False`` as in an encoder), dict(k, v) fixed buffers, or
    dict(k_pages, v_pages) page pools addressed through ``block_tables``;
    either is updated in place.  pos0: (B,) write offsets; chunk_len: (B,)
    true (unpadded) chunk lengths; verify: the chunk is a
    speculative-decoding verify window (same function, own kernel and
    ``OP_STATS`` key); train: the no-cache call takes the reference's
    plain branches (``sdpa_chunked`` or the masked ``sdpa``), never a
    kernel; shard: a mesh shard's context (the module docstring)."""
    B, Sq, d = x.shape
    h, kv, hd = p["wq"].shape[1], p["wk"].shape[1], cfg.head_dim
    split = None if shard is None else cfg.n_kv_heads
    qn, kn = p.get("q_norm"), p.get("k_norm")
    if shard is not None and shard.heads:
        if qn is None:
            x = shard.enter(x)
        else:
            x, qn, kn = shard.enter(x, qn, kn)
    q = matmul_promoted(x, p["wq"].reshape(d, h * hd)).view(B, Sq, h, hd)
    k = matmul_promoted(x, p["wk"].reshape(d, kv * hd)).view(B, Sq, kv, hd)
    v = matmul_promoted(x, p["wv"].reshape(d, kv * hd)).view(B, Sq, kv, hd)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if qn is not None:
        q = rms_head_norm(qn, q)
        k = rms_head_norm(kn, k)
    if cfg.learned_pos == 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window
    # the reference's one decision between sdpa_chunked and sdpa
    chunked = (cfg.attn_impl == "chunked"
               and (cache["k"].shape[1]
                    if cache is not None and "k" in cache else Sq)
               > cfg.attn_chunk)

    if cache is None:
        if not train and not (causal and window is not None):
            return attention(q, k, v, causal=causal), None
        # training, and a sliding window (B6 has none), take the
        # reference's plain branches
        zeros = torch.zeros(B, dtype=torch.int32, device=x.device)
        full = torch.full((B,), Sq, dtype=torch.int32, device=x.device)
        if chunked and causal:
            return sdpa_chunked(q, k, v, pos0=zeros, kv_len=full,
                                window=window, chunk=cfg.attn_chunk), None
        if causal:
            mask = causal_mask(B, Sq, Sq, zeros, full, window)
        else:
            mask = torch.ones(B, 1, Sq, Sq, dtype=torch.bool,
                              device=x.device)
        return sdpa(q, k, v, mask), None
    if "k" in cache:
        if shard is not None and shard.seq:
            return seq_sharded_attention(q, k, v, cache, pos0, window,
                                         shard), cache
        ck = dense_write(cache["k"], k, pos0).to(q.dtype)
        cv = dense_write(cache["v"], v, pos0).to(q.dtype)
        kv_len = pos0 + Sq
        if chunked:
            return sdpa_chunked(q, ck, cv, pos0=pos0, kv_len=kv_len,
                                window=window, chunk=cfg.attn_chunk), cache
        mask = causal_mask(B, Sq, ck.shape[1], pos0, kv_len, window)
        return sdpa(q, ck, cv, mask), cache

    kp, vp = cache["k_pages"], cache["v_pages"]
    if chunk_len is None:
        chunk_len = torch.full((B,), Sq, dtype=torch.int32, device=x.device)
    if Sq > 1 and verify:
        # fused spec verify: B3 writes the window's KV into the pages and
        # attends over the paged history (the engine's CoW barrier ran
        # over the window first)
        bump(OP_STATS, "fused_verify")
        out, _, _ = paged_verify_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), kp[:-1],
            vp[:-1], block_tables, pos0, chunk_len, window=window,
            split_heads=split)
        return out, cache
    if Sq > 1:
        # fused chunked prefill: the kernel writes the chunk's KV into the
        # pages and attends over the paged history in the same launch (the
        # engine's CoW barrier made every written page exclusive).  The
        # write-off page is left out: the kernel never writes masked rows.
        bump(OP_STATS, "fused_prefill")
        out, _, _ = paged_prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), kp[:-1],
            vp[:-1], block_tables, pos0, chunk_len, window=window,
            split_heads=split)
        return out, cache
    paged_write(kp, k, block_tables, pos0, chunk_len)
    paged_write(vp, v, block_tables, pos0, chunk_len)
    out = paged_decode_attention(q[:, 0].contiguous(), kp[:-1], vp[:-1],
                                 block_tables, pos0 + 1, window=window,
                                 split_heads=split)
    return out[:, None], cache


def seq_sharded_attention(q, k, v, cache, pos0, window, shard):
    """One decode token (Sq 1) over a dense cache whose sequence dim is
    split over the data group: data shard i holds positions [i * S, (i +
    1) * S) of ``cache["k"]`` / ``["v"]`` (B, S, KV, hd).  The shard
    holding a lane's position writes its new row there (the others write
    their row back unchanged); each shard attends over its positions
    (keys at or before the query, within the window), and the partial
    sums, maxima and denominators are all-gathered and merged in shard
    order by log-sum-exp.  Returns (B, 1, H, hd)."""
    B, Sq, H, hd = q.shape
    if Sq != 1:
        raise NotImplementedError("sequence-sharded attention: decode only")
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[1]
    local = pos0.long() - shard.data_index * S           # lane's row here
    _write_row(ck, k[:, 0], local)
    _write_row(cv, v[:, 0], local)
    kk, vv = ck.to(q.dtype), cv.to(q.dtype)
    if H != kk.shape[2]:
        kk = kk.repeat_interleave(H // kk.shape[2], dim=2)
        vv = vv.repeat_interleave(H // vv.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * hd ** -0.5
    mask = causal_mask(B, Sq, S, local, local + Sq, window)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)                  # (B, H, 1, 1)
    pr = torch.where(mask, torch.exp(logits - m), 0.0)
    l = pr.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", pr, vv.float())
    parts = shard.data_all_gather(torch.cat([acc, m, l], dim=-1)[None], 0)
    acc, m, l = parts[..., :hd], parts[..., hd:hd + 1], parts[..., hd + 1:]
    m_all = m.amax(dim=0)
    scale = torch.exp(m - m_all)
    out = ((acc * scale).sum(dim=0)
           / (l * scale).sum(dim=0).clamp(min=1e-30))       # (B, H, 1, hd)
    return out.transpose(1, 2).to(q.dtype)


def _write_row(buf, row, local):
    """Write ``row`` (B, ...) at row ``local[b]`` of each lane's buffer
    (B, S, ...), in place, where 0 <= local[b] < S; elsewhere the clamped
    row is written back unchanged."""
    B, S = buf.shape[:2]
    valid = (local >= 0) & (local < S)
    idx = local.clamp(0, S - 1)
    lanes = torch.arange(B, device=buf.device)
    cur = buf[lanes, idx]
    keep = valid.view((B,) + (1,) * (row.dim() - 1))
    buf[lanes, idx] = torch.where(keep, row.to(buf.dtype), cur)


def attn_output(p, ctx, shard=None):
    """The per-head context through ``wo``; under ``shard.heads`` ``ctx``
    holds this shard's heads and is all-gathered (in head order, the
    unsharded context) before the replicated ``wo``."""
    if shard is not None and shard.heads:
        ctx = shard.all_gather(ctx, 2)
    B, S, h, hd = ctx.shape
    out = matmul_promoted(ctx.reshape(B, S, h * hd),
                          p["wo"].reshape(h * hd, -1))
    if "bo" in p:
        out = out + p["bo"]
    return out


# --------------------------- cross-attention ---------------------------- #
def cross_attn_forward(p, x, enc_kv, gated: bool = False,
                       train: bool = False):
    """Attention of the decoder's rows over encoder (or image) states, all
    of them visible: B6 with ``causal=False`` and ``kv_len`` the encoder
    length, or with ``train`` the reference's ``sdpa`` under an all-true
    mask.  enc_kv: dict(k, v) from ``project_cross_kv``, (B, Sk, KV, hd).
    ``gated``: the VLM's ``tanh(gate)`` scales the output.  (The
    reference's optional per-lane ``enc_len`` mask has no caller there
    and is not ported.)"""
    B, Sq, d = x.shape
    h, hd = p["wq"].shape[1], p["wq"].shape[2]
    q = matmul_promoted(x, p["wq"].reshape(d, h * hd)).view(B, Sq, h, hd)
    if "bq" in p:
        q = q + p["bq"]
    k, v = enc_kv["k"].to(q.dtype), enc_kv["v"].to(q.dtype)
    if train:
        ctx = sdpa(q, k, v, torch.ones(B, 1, Sq, k.shape[1], dtype=torch.bool,
                                       device=x.device))
    else:
        ctx = attention(q, k, v, causal=False, kv_len=k.shape[1])
    out = attn_output(p, ctx)
    if gated and "gate" in p:
        # jnp's rule: the 0-d float32 gate promotes a bf16 output
        g, out = promote(torch.tanh(p["gate"]), out)
        out = g * out
    return out


def project_cross_kv(p, states):
    """Cross-attention K/V of encoder or image states (B, T, D) ->
    dict(k, v) of (B, T, KV, hd)."""
    B, T, d = states.shape
    kv, hd = p["wk"].shape[1], p["wk"].shape[2]
    k = (states @ p["wk"].reshape(d, kv * hd)).reshape(B, T, kv, hd)
    v = (states @ p["wv"].reshape(d, kv * hd)).reshape(B, T, kv, hd)
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return {"k": k, "v": v}


# ------------------------------- MLA ------------------------------------ #
def init_mla(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    """MLA weights with the reference's shapes and scales, from ``gen``."""
    c = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_dim = c.qk_nope_head_dim + c.qk_rope_head_dim

    def normal(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype, device=device)
    s = d ** -0.5
    r = c.kv_lora_rank
    p = {"w_dkv": normal(d, r) * s,
         "w_krope": normal(d, c.qk_rope_head_dim) * s,
         "w_uk": normal(r, h, c.qk_nope_head_dim) * r ** -0.5,
         "w_uv": normal(r, h, c.v_head_dim) * r ** -0.5,
         "wo": normal(h, c.v_head_dim, d) * (h * c.v_head_dim) ** -0.5,
         "kv_norm": torch.ones(r, dtype=torch.float32, device=device)}
    if c.q_lora_rank:
        p["w_dq"] = normal(d, c.q_lora_rank) * s
        p["w_uq"] = normal(c.q_lora_rank, h, qk_dim) * c.q_lora_rank ** -0.5
        p["q_norm"] = torch.ones(c.q_lora_rank, dtype=torch.float32,
                                 device=device)
    else:
        p["wq"] = normal(d, h, qk_dim) * s
    return p


def mla_forward(p, x, cfg: ModelConfig, *, positions, cache=None, pos0=None,
                block_tables=None, chunk_len=None, train: bool = False,
                shard=None):
    """MLA over a compressed cache: per token one ``kv_lora_rank`` latent
    (``ckv``) plus one shared rope key (``krope``), no head axis.  Returns
    (out (B, Sq, D), cache): unlike ``attn_forward`` the output is already
    projected through ``wo``.

    cache: None (full causal over the chunk), the fixed buffers ``{"ckv":
    (B, S_max, r), "krope": (B, S_max, rope)}`` of
    ``transformer.init_cache``, or the paged pools ``{"ckv_pages": (P + 1,
    page, r), "krope_pages": (P + 1, page, rope)}`` (the last page is the
    write-off page); either is updated in place.  A paged multi-token
    chunk goes to the fused latent-page prefill kernel (B4) with absorbed
    queries ``q_lat = q_nope . w_uk``; a paged decode token is written by
    ``paged_write`` and attends over the gathered latents.  Every call
    but B4's attends in plain PyTorch, by the naive expansion (per-head
    keys and values built from every latent, the reference's default) or,
    with ``cfg.mla_absorb`` and at most 4 rows, in latent space.  No-cache
    calls launch no kernel, so ``train`` (the training forward, threaded
    down from ``model_forward`` as for the other mixers) changes
    nothing here.  ``shard`` (``shard.mla_heads``): the query and latent
    up-projections hold this shard's heads while the latent pools
    replicate (every shard writes the same rows); the per-head context
    is all-gathered before ``wo``."""
    c = cfg.mla
    B, Sq, _ = x.shape
    nope, rope_hd = c.qk_nope_head_dim, c.qk_rope_head_dim
    scale = (nope + rope_hd) ** -0.5
    if shard is not None and shard.seq:
        raise NotImplementedError("MLA: no sequence-sharded cache")
    # the query's input and the latents are replicated and feed every
    # shard's heads
    qin = (rms_head_norm(p["q_norm"], x @ p["w_dq"]) if "w_dq" in p
           else x)
    ckv = rms_head_norm(p["kv_norm"], x @ p["w_dkv"])          # (B, Sq, r)
    krope = apply_rope((x @ p["w_krope"])[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0, :]             # (B, Sq, rope)
    if shard is not None and shard.mla_heads:
        qin, ckv, krope = shard.enter(qin, ckv, krope)
    q = torch.einsum("bsr,rhk->bshk", qin,
                     p["w_uq"] if "w_dq" in p else p["wq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    if cache is None:
        ckv_all, krope_all = ckv, krope
        q_pos0 = torch.zeros(B, dtype=torch.int32, device=x.device)
        kv_len = torch.full((B,), Sq, dtype=torch.int32, device=x.device)
    elif "ckv" in cache:
        ckv_all = dense_write(cache["ckv"], ckv, pos0).to(x.dtype)
        krope_all = dense_write(cache["krope"], krope, pos0).to(x.dtype)
        q_pos0, kv_len = pos0, pos0 + Sq
    else:
        cp, rp = cache["ckv_pages"], cache["krope_pages"]
        if chunk_len is None:
            chunk_len = torch.full((B,), Sq, dtype=torch.int32,
                                   device=x.device)
        if Sq > 1:
            # fused latent-page prefill: B4 writes the chunk's ckv / krope
            # rows into the pages and attends over the paged latent history
            # in one launch (the engine's CoW barrier made every written
            # page exclusive).  The write-off page is left out.
            bump(OP_STATS, "fused_prefill")
            q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, p["w_uk"])
            ctx_lat, _, _ = mla_paged_prefill_attention(
                q_lat.contiguous(), q_rope.contiguous(), ckv.contiguous(),
                krope.contiguous(), cp[:-1], rp[:-1], block_tables, pos0,
                chunk_len, scale=scale,
                split_heads=None if shard is None else cfg.n_heads)
            ctx = torch.einsum("bqhr,rhv->bqhv", ctx_lat.to(x.dtype),
                               p["w_uv"])
            return _mla_out(p, ctx, shard), cache
        paged_write(cp, ckv, block_tables, pos0, chunk_len)
        paged_write(rp, krope, block_tables, pos0, chunk_len)
        ckv_all = paged_gather(cp, block_tables).to(x.dtype)
        krope_all = paged_gather(rp, block_tables).to(x.dtype)
        q_pos0, kv_len = pos0, pos0 + Sq

    Sk = ckv_all.shape[1]
    mask = causal_mask(B, Sq, Sk, q_pos0, kv_len)
    if cfg.mla_absorb and Sq <= 4:
        # absorbed decode: w_uk folded into the query, w_uv into the
        # output, so attention runs against the latents themselves
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, p["w_uk"])
        logits = (torch.einsum("bqhr,bkr->bhqk", q_lat, ckv_all)
                  + torch.einsum("bqhr,bkr->bhqk", q_rope, krope_all)
                  ).float() * scale
        probs = torch.softmax(torch.where(mask, logits, NEG_INF),
                              dim=-1).to(x.dtype)
        ctx_lat = torch.einsum("bhqk,bkr->bqhr", probs, ckv_all)
        ctx = torch.einsum("bqhr,rhv->bqhv", ctx_lat, p["w_uv"])
        return _mla_out(p, ctx, shard), cache
    # naive: per-head keys and values expanded from every latent
    k_nope = torch.einsum("bsr,rhk->bshk", ckv_all, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", ckv_all, p["w_uv"])
    logits = (torch.einsum("bqhn,bkhn->bhqk", q_nope, k_nope)
              + torch.einsum("bqhr,bkr->bhqk", q_rope, krope_all)
              ).float() * scale
    probs = torch.softmax(torch.where(mask, logits, NEG_INF),
                          dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return _mla_out(p, ctx, shard), cache


def _mla_out(p, ctx, shard):
    """MLA's per-head context through ``wo``, gathered over the shards
    first under ``shard.mla_heads``."""
    if shard is not None and shard.mla_heads:
        ctx = shard.all_gather(ctx, 2)
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"])
