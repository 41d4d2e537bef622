"""Speculative decoding executor: draft autoregression + target verify
(port of ``repro/serving/spec_decode.py``).

Greedy-acceptance speculative decoding (Leviathan et al.; temperature-0
case): the draft model proposes ``sl`` tokens, the target verifies all of
them in ONE batched forward, the accepted prefix plus one corrected/bonus
token is emitted, and both caches are rolled back to the validated context.

Both models run on paged KV (their own ``PagedKVManager`` each).  The
draft's ``sl`` greedy steps run back to back on the device, bucketed to
``(1, 2, 4, 8, 16, 32, 64)`` steps like the reference's scan (steps past
``sl`` carry ``chunk_len`` 0, so their writes go to the write-off page and
their outputs are discarded), with one host sync for the drafts.  The
verify is one more model call through the verify kernel (B3) with one
host sync for the target's greedy token at every row.  Rollback on
rejection is a block-table length decrement (``truncate``): rejected rows
stay in the pages above the length, where nothing reads them (B3 reads
history below ``pos0``, B1 below ``seq_len``), until the next window
overwrites them.

Cache invariant shared with the engine: a cache holds embeddings of
``(prompt + generated)[:-1]`` and the next model input is the last token.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models import attention as _attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import dropless_capacity_factor
from repro_torch.models.transformer import logits_fn, model_forward
from repro_torch.serving.engine import _bucket
from repro_torch.serving.kvcache import PagedKVManager, kv_page_bytes

DRAFT_STEP_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class SpecDecoder:
    def __init__(self, engine, draft_cfg: ModelConfig, draft_params):
        self.engine = engine
        self.cfg = draft_cfg
        self.params = draft_params
        self._moe_cf = dropless_capacity_factor(draft_cfg)
        e = engine.ecfg
        # Right-size the draft pool: it mirrors the target's token capacity
        # (same page_size, so the same page count serves), but never more
        # than every slot maxed out, and its device memory is charged to
        # the cluster's SharedPageBudget in TARGET-page equivalents (a
        # draft page is cheaper by the ratio of per-page KV bytes).
        want = min(e.total_pages,
                   e.max_slots * max(1, math.ceil(e.max_len / e.page_size)))
        tgt_bytes = kv_page_bytes(engine.cfg, e.page_size, e.dtype)
        dft_bytes = kv_page_bytes(draft_cfg, e.page_size, e.dtype)
        ratio = dft_bytes / tgt_bytes if tgt_bytes > 0 else 0.0
        self.budget_pages = 0       # target-page equivalents reserved
        budget = engine.kv.budget
        if budget is not None and ratio > 0.0:
            charge = math.ceil(want * ratio)
            if not budget.reserve(charge):
                # shrink the draft pool to what the budget still affords;
                # per-request fallbacks degrade to plain decode when the
                # pool runs short
                want = max(1, min(want, int(budget.available / ratio)))
                charge = math.ceil(want * ratio)
                if not budget.reserve(charge):
                    charge = 0      # budget exhausted: minimal uncharged pool
                    want = 1
            self.budget_pages = charge
        self.kv = PagedKVManager(draft_cfg, total_pages=want,
                                 page_size=e.page_size, max_seqs=e.max_slots,
                                 max_len=e.max_len, dtype=e.dtype,
                                 device=engine.device)

    # ------------------------- device programs -------------------------- #
    def _draft_loop(self, cache, tok0, pos0, bt, sl: int, n_steps: int):
        """Greedy-draft ``sl`` tokens for one lane with no host sync.
        ``n_steps`` is the bucketed step count; steps past ``sl`` neither
        write KV (chunk_len 0) nor advance, and the caller discards them."""
        tok, pos = tok0, pos0
        drafts = torch.empty((n_steps,), dtype=torch.int32, device=tok.device)
        one = torch.ones_like(pos)
        for i in range(n_steps):
            active = i < sl
            h, _, _ = model_forward(self.params, self.cfg, tok[:, None],
                                 cache=cache, pos0=pos, block_tables=bt,
                                 chunk_len=one if active else one * 0,
                                 moe_cf=self._moe_cf)
            nxt = torch.argmax(logits_fn(self.params, self.cfg, h[:, -1]),
                               dim=-1).to(torch.int32)
            drafts[i] = nxt[0]
            if active:
                tok, pos = nxt, pos + 1
        return drafts

    # ------------------------------------------------------------------ #
    def _seq(self, rid: int) -> list:
        ctx = self.engine.reqs[rid]
        return list(ctx.prompt) + list(ctx.generated)

    def _draft_catch_up(self, rid: int, tokens: list) -> None:
        """Bring the draft cache up to tokens the target already holds: one
        chunked prefill (B2) on the draft's lane."""
        eng = self.engine
        slot = self.kv.seq_of[rid]
        pos = self.kv.length(rid)
        L = len(tokens)
        Lp = _bucket(L)
        if not self.kv.extend(rid, pos + L):
            raise RuntimeError(f"draft {rid}: out of KV pages")
        buf = np.zeros((1, Lp), np.int64)
        buf[0, :L] = tokens

        def dev(vals):
            return torch.tensor(vals, dtype=torch.int32, device=eng.device)
        model_forward(self.params, self.cfg,
                      torch.from_numpy(buf).to(eng.device),
                      cache=self.kv.lane_cache([slot]), pos0=dev([pos]),
                      block_tables=self.kv.table_rows([slot]),
                      chunk_len=dev([L]), moe_cf=self._moe_cf)
        self.kv.seq_len[slot] += L
        eng.counters["spec_draft_calls"] += 1
        eng.counters["spec_catch_up_calls"] += 1

    # ------------------------------------------------------------------ #
    def decode(self, rid: int, n_tokens: int, on_pressure=None) -> list:
        """One verify cycle processing ``n_tokens`` target tokens
        (= sl drafts + 1); returns the emitted tokens.  ``on_pressure``
        is the engine's page-exhaustion callback, threaded into the
        verify reservation / copy-on-write barrier and the plain-decode
        fallbacks."""
        eng = self.engine
        sl = max(n_tokens - 1, 0)
        if sl == 0:
            return list(eng._decode_batched([rid], on_pressure)[rid])
        if self.kv.acquire(rid) is None:
            return list(eng._decode_batched({rid: n_tokens},
                                            on_pressure)[rid])
        seq = self._seq(rid)
        # near the context/page limit the verify window no longer fits:
        # fall back to plain decode, which caps its budget gracefully
        if (eng.kv.token_capacity(rid) < len(seq) + sl
                or self.kv.token_capacity(rid) < len(seq) - 1 + sl):
            return list(eng._decode_batched({rid: n_tokens},
                                            on_pressure)[rid])
        dpos = self.kv.length(rid)
        if dpos < len(seq) - 1:                # sync draft up to seq[:-1]
            self._draft_catch_up(rid, seq[dpos:len(seq) - 1])

        # draft sl tokens: one device loop, one host sync
        slot = self.kv.seq_of[rid]
        if not self.kv.extend(rid, len(seq) - 1 + sl):
            raise RuntimeError(f"draft {rid}: out of KV pages")
        n_steps = _bucket(sl, DRAFT_STEP_BUCKETS)

        def dev(vals):
            return torch.tensor(vals, dtype=torch.int32, device=eng.device)
        drafts_dev = self._draft_loop(self.kv.lane_cache([slot]),
                                      dev([seq[-1]]), dev([len(seq) - 1]),
                                      self.kv.table_rows([slot]), sl,
                                      n_steps)
        self.kv.seq_len[slot] += sl
        eng.counters["spec_draft_calls"] += 1
        eng.counters["spec_draft_steps"] += n_steps
        drafts = [int(t) for t in drafts_dev.cpu().numpy()[:sl]]

        # target verifies [last, drafts[:-1]] + drafts[-1] in one pass
        verify_in = [seq[-1]] + drafts
        L = len(verify_in)
        Lp = _bucket(L)
        tslot = eng.kv.seq_of[rid]
        tpos = eng.kv.length(rid)
        eng._reserve(rid, tpos + L, on_pressure)
        try:
            eng._cow_barrier(rid, tpos, L, on_pressure)
        except RuntimeError:
            # no page for a copy-on-write target: undo the draft extension
            # and fall back to plain decode, which caps gracefully
            self.kv.truncate(rid, sl)
            return list(eng._decode_batched({rid: n_tokens},
                                            on_pressure)[rid])
        # the fused verify kernel writes the window's KV in-kernel:
        # re-assert the CoW contract over [tpos, tpos+L) like prefill does
        eng.kv.check_writable(rid, tpos, L)
        buf = np.zeros((1, Lp), np.int64)
        buf[0, :L] = verify_in
        fused0 = _attn.OP_STATS["fused_verify"]
        ttoks = eng._verify_forward(
            eng.kv.lane_cache([tslot]), torch.from_numpy(buf).to(eng.device),
            dev([tpos]), dev([L]), eng.kv.table_rows([tslot]),
            eng.reqs[rid].enc_states)
        eng.counters["verify_fused_ops"] += (
            _attn.OP_STATS["fused_verify"] - fused0)
        eng.kv.seq_len[tslot] += L
        eng.counters["spec_verify_calls"] += 1
        target_toks = ttoks.cpu().numpy()[:L]    # one host sync per cycle

        accepted = 0
        while accepted < sl and int(target_toks[accepted]) == drafts[accepted]:
            accepted += 1
        emitted = [int(t) for t in target_toks[:accepted + 1]]
        # the verify outcome: totals for observability plus the per-rid
        # tally the frontend folds into its per-SLO-class acceptance EWMA
        eng.counters["spec_accepted_tokens"] += accepted
        eng.counters["spec_drafted_tokens"] += sl
        a0, d0 = eng.last_spec_stats.get(rid, (0, 0))
        eng.last_spec_stats[rid] = (a0 + accepted, d0 + sl)

        # roll back target cache to the validated context
        eng.rollback(rid, sl - accepted)
        # roll back draft cache: valid prefix is seq + emitted[:-1]
        dlen = self.kv.length(rid)
        want = len(seq) + len(emitted) - 1
        if dlen > want:
            self.kv.truncate(rid, dlen - want)
        ctx = eng.reqs[rid]
        # target KV retained this cycle: [seq[-1]] + accepted drafts,
        # mirrored into history so preemption can recompute it exactly
        ctx.history.extend(([seq[-1]] + emitted)[:len(emitted)])
        ctx.generated.extend(emitted)
        return emitted

    def release(self, rid: int) -> None:
        self.kv.release(rid)
