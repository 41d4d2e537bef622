"""KV-cache memory management: the paged, device-resident serving cache
(port of ``repro/serving/kvcache.py``).

``PageAllocator`` is the logical page accountant (free list + per-request
page tables), kept standalone so the planner and property tests can reason
about memory without a device.  ``PagedKVManager`` extends it into the one
physical manager the engine uses: it owns the per-layer page pools
(``models/transformer.init_paged_cache``), the block tables that address
them and the per-sequence lengths.

The prefix-sharing contract is the reference's (refcounts, a chain-hash
prefix index verified token by token, token-level partial-page heads,
copy-on-write in ``ensure_writable``, an LRU cached pool of zero-refcount
published pages); see the reference module's docstring.  What differs:

* Block tables live on the host (``block_tables``, numpy int32) and the
  rows a call needs are copied to the device by ``table_rows``; the
  reference keeps a device array updated with ``.at[].set``.
* Pools are torch tensors updated in place (CoW copies with indexed
  assignment, kernel writes straight into the pools), so ``lane_cache``
  and ``absorb`` pass the page pools through unchanged: JAX needed them
  to thread its functional pool updates and buffer donation.  SSM lane
  rows are gathered to one row per batch lane and scattered back, as in
  the reference.
* A slot's SSM lane rows are zeroed whenever its length is reset to 0
  (``acquire``, ``preempt``, ``release``), so a reused slot and a
  preempt replay start from the zero state, as plain generation does.
  The reference leaves a freed slot's rows as they were.
* The host spill tier (``host_spill_pages > 0``; the reference's
  "Hierarchical KV") keeps each spilled page as **pinned** host tensors
  on a card.  A spill is one asynchronous device-to-host copy per pool
  leaf on the current stream, into a fresh pinned buffer.  A flush stacks
  the queued entries into one pinned staging tensor per leaf, copies it
  to the card with ``non_blocking=True`` and writes it into the pools
  with ``index_copy_`` on the page axis, all on the current stream, so
  every later kernel on that stream reads the prefetched bytes (the
  reference gets that order from a data dependency).  Host reads of
  spilled bytes (the flush's stacking, ``export_chain``) wait for the
  spills' copies first.
* Mesh placement (``place``, ``distributed/sharding.py``): one host-side
  allocator drives per-shard pools (``shard_pools[i]`` on the mesh's
  device i).  GQA pools split on the KV-head axis, MLA latent pools and
  block tables replicate, and SSM ``conv`` / ``state`` rows split on the
  slot axis at rest: ``lane_cache`` gathers a call's lanes' rows from
  their owners into a replicated copy per shard, and ``absorb`` gives
  each owner its rows back from its own shard's result.  A host-tier
  entry holds the whole page, concatenated over the shards, so
  ``export_chain`` and ``install_host_chain`` do not depend on the mesh.
  Without a mesh there is one shard and ``pools`` is its tree.
"""
from __future__ import annotations

import math
import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import serving_cache_specs, shard_tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import MLA_KINDS, init_paged_cache


def kv_page_bytes(cfg: ModelConfig, page_size: int = 16,
                  dtype=torch.float32) -> int:
    """Device bytes one KV page costs for ``cfg``, summed over all layers:
    K and V planes of every GQA layer, the latent and rope rows of every
    MLA layer.  SSM lane state is not paged and contributes nothing."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    total = 0
    for kind, n in cfg.segments():
        if kind == "ssm":
            continue
        if kind in MLA_KINDS:
            per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        else:
            per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
        total += n * page_size * per_tok * itemsize
    return total


@dataclasses.dataclass
class _HostEntry:
    """One spilled page in the host tier: the chain metadata needed to
    re-verify a match (``parent`` hash + exact ``chunk`` tokens) and the
    page contents per segment, ``{"self": {leaf: host tensor}}`` aligned
    with the manager's pool segments (``()`` for unpaged segments)."""
    parent: Optional[int]
    chunk: tuple
    data: list


class SharedPageBudget:
    """Cluster-wide KV page budget shared by several PagedKVManagers.
    Conservation invariant: ``used`` equals the sum of ``used_pages`` over
    the attached managers (a shared page counts once)."""

    def __init__(self, total_pages: int):
        self.total_pages = total_pages
        self.used = 0

    @property
    def available(self) -> int:
        return self.total_pages - self.used

    def reserve(self, n_pages: int) -> bool:
        if n_pages > self.available:
            return False
        self.used += n_pages
        return True

    def release(self, n_pages: int) -> None:
        self.used -= n_pages
        assert self.used >= 0, "shared budget released more than reserved"


class PageAllocator:
    def __init__(self, total_pages: int, page_size: int = 16,
                 budget: Optional[SharedPageBudget] = None):
        self.total_pages = total_pages
        self.page_size = page_size
        self.budget = budget
        self.free = list(range(total_pages - 1, -1, -1))
        self.tables: dict[int, list[int]] = {}

    def pages_needed(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page_size))

    def can_allocate(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= self.free_pages

    def allocate(self, rid: int, n_tokens: int) -> Optional[list[int]]:
        need = self.pages_needed(n_tokens)
        if need > len(self.free):
            return None
        if self.budget is not None and not self.budget.reserve(need):
            return None
        pages = [self.free.pop() for _ in range(need)]
        self.tables.setdefault(rid, []).extend(pages)
        return pages

    def extend(self, rid: int, new_total_tokens: int) -> bool:
        have = len(self.tables.get(rid, []))
        need = self.pages_needed(new_total_tokens)
        if need <= have:
            return True
        extra = need - have
        if extra > len(self.free):
            return False
        if self.budget is not None and not self.budget.reserve(extra):
            return False
        self.tables.setdefault(rid, []).extend(
            self.free.pop() for _ in range(extra))
        return True

    def release(self, rid: int) -> int:
        pages = self.tables.pop(rid, [])
        self.free.extend(reversed(pages))
        if self.budget is not None:
            self.budget.release(len(pages))
        return len(pages)

    @property
    def used_pages(self) -> int:
        return self.total_pages - len(self.free)

    @property
    def free_pages(self) -> int:
        if self.budget is None:
            return len(self.free)
        return min(len(self.free), self.budget.available)


class PagedKVManager(PageAllocator):
    """Unified logical + physical KV manager.

    Device state: ``pools``, the per-segment page pools (each with its
    trailing write-off page).  Host state: ``block_tables`` (max_seqs,
    max_pages_per_seq) int32, ``seq_len`` per slot, ``seq_of`` (rid →
    slot), per-page ``refcount``, the prefix index and LRU cached pool, and
    the inherited free list / page tables.

    ``token_level`` (default on) adds partial-page matching: a prompt
    diverging mid-page reuses the verified head of the boundary page;
    off, hits are page-granular, as in the reference.  Prefix
    sharing is forced off for SSM-bearing models, as in the reference:
    skipping a cached prefill chunk would skip the (unpaged, lane-resident)
    SSM state updates it performs.  ``device`` follows ``resolve_device``:
    CUDA unless named.
    """

    def __init__(self, cfg: ModelConfig, *, total_pages: int,
                 page_size: int = 16, max_seqs: int = 8,
                 max_len: int = 512, dtype=torch.float32,
                 budget: Optional[SharedPageBudget] = None,
                 share_prefix: bool = False, token_level: bool = True,
                 host_spill_pages: int = 0, h2d_gbps: float = 16.0,
                 device=None):
        super().__init__(total_pages, page_size, budget=budget)
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.max_seqs = max_seqs
        self.max_len = max_len
        self.max_pages_per_seq = max(1, math.ceil(max_len / page_size))
        # one pool tree per shard (one without a mesh: ``place``)
        self.shard_pools = [init_paged_cache(cfg, total_pages, page_size,
                                             max_seqs, dtype, self.device)]
        self.devices = (self.device,)
        self.mesh = None
        self.plan = None
        self._specs = None             # per pool leaf: shard axis or None
        self._lanes_per_shard = None   # SSM slots per shard when split
        self.block_tables = np.zeros((max_seqs, self.max_pages_per_seq),
                                     np.int32)
        self.seq_len = np.zeros((max_seqs,), np.int64)
        self.free_seqs = list(range(max_seqs - 1, -1, -1))
        self.seq_of: dict[int, int] = {}
        # ---- prefix sharing state (reference module docstring) ----
        self.share_prefix = share_prefix and not any(
            kind == "ssm" for kind, _ in cfg.segments())
        self.token_level = token_level        # partial-page head matching
        self.refcount = np.zeros((total_pages,), np.int32)
        self.prefix_index: dict[int, int] = {}       # chain hash -> page
        self.page_key: dict[int, int] = {}           # page -> chain hash
        self.page_tokens: dict[int, tuple] = {}      # page -> exact chunk
        self.page_parent: dict[int, Optional[int]] = {}
        self.children: dict[Optional[int], set[int]] = {}
        self.cached: OrderedDict[int, int] = OrderedDict()  # LRU, zero-ref
        self._reg_state: dict[int, tuple[int, Optional[int]]] = {}
        # ---- host spill tier (module docstring) ----
        # entries live in the device index OR here, never both; the tier
        # is sharing-scoped (no sharing -> nothing publishable to spill)
        self.host_spill_pages = host_spill_pages if self.share_prefix else 0
        self.h2d_gbps = h2d_gbps
        self.host_index: OrderedDict[int, _HostEntry] = OrderedDict()
        self.host_used = 0             # credit-once mirror of host_index
        # queued H2D copies: (device page, host entry), run by
        # flush_prefetch (the engine flushes at the top of execute())
        self._pending_prefetch: list[tuple[int, _HostEntry]] = []
        # the last spill's D2H copy, waited for before the host reads
        # spilled bytes; staging buffers of H2D copies still in flight
        self._d2h_done = None
        self._h2d_inflight: list[tuple] = []
        # per-root-chain probe popularity: the cluster's placement signal
        self.chain_hits: dict[int, int] = {}
        self.cow_copies = 0
        self.pages_grabbed = 0
        self.prefix_evictions = 0
        self.spilled_pages = 0         # device pages spilled to host
        self.prefetched_pages = 0      # host entries prefetched to device
        self.host_evictions = 0        # host-tier LRU evictions (final)
        self.spilled_hit_tokens = 0    # hit tokens delivered via prefetch
        self.prefetch_flushes = 0      # flush_prefetch calls that copied
        self.partial_head_copies = 0
        self.partial_hit_tokens = 0
        self._partial_pending = 0

    # ----------------------- mesh placement ----------------------------- #
    @property
    def pools(self):
        """The page pools and lane rows (one shard's tree; without a mesh
        the only one)."""
        if len(self.shard_pools) != 1:
            raise RuntimeError("the pools of a placed manager are per shard: "
                               "read shard_pools")
        return self.shard_pools[0]

    @pools.setter
    def pools(self, value) -> None:
        if self.mesh is not None:
            raise RuntimeError("the pools of a placed manager are per shard")
        self.shard_pools = [value]

    def place(self, mesh, plan) -> None:
        """Shard the at-rest device state over a serving mesh: attention
        page pools split on the KV-head axis, SSM lane rows on the slot
        axis, MLA latent pools replicated (``serving_cache_specs``), each
        shard's on its device; block tables stay on the host and go to
        every shard.  Logical accounting (free lists, refcounts, prefix
        index, host tier) is host-side and unchanged: one allocator
        drives every shard."""
        if self.mesh is not None:
            raise RuntimeError("place: the manager is placed already")
        self.flush_prefetch()
        self._sync_d2h()
        pools = self.shard_pools[0]
        specs = serving_cache_specs(pools, self.cfg, plan, lane_view=False)
        self.shard_pools = shard_tree(pools, specs, mesh, copy=True,
                                      consume=True)
        self._specs = specs
        self.mesh, self.plan = mesh, plan
        self.devices = tuple(mesh.devices)
        self.device = self.devices[0]
        self._lanes_per_shard = (self.max_seqs // mesh.size
                                 if plan.ssm_lanes else None)

    def _leaf_axis(self, seg: int, name: str) -> Optional[int]:
        """The shard axis of pool leaf ``name`` of segment ``seg`` at rest,
        None when it replicates (or without a mesh)."""
        if self._specs is None:
            return None
        sp = self._specs[seg]
        return sp["self"][name] if "self" in sp else sp[name]

    def _lane_owner(self, s: int) -> tuple:
        """(shard, row) holding slot ``s``'s lane rows when they split
        over the shards; (None, s) when every shard holds every row."""
        per = self._lanes_per_shard
        return (None, s) if per is None else (s // per, s % per)

    # ------------------------ physical page ops ------------------------- #
    @property
    def used_pages(self) -> int:
        """Pages some live request holds (refcount >= 1)."""
        return self.total_pages - len(self.free) - len(self.cached)

    @property
    def free_pages(self) -> int:
        avail = len(self.free) + len(self.cached)
        if self.budget is None:
            return avail
        return min(avail, self.budget.available)

    def _grab_pages(self, n: int) -> Optional[list[int]]:
        """Take n physical pages: free list first, then LRU eviction of
        zero-refcount cached pages.  An evicted page spills to the host
        tier (when enabled) before being unpublished, so the chain stays
        matchable.  Reserves the shared budget; None (nothing taken) if
        pages or budget are short."""
        if n <= 0:
            return []
        if n > len(self.free) + len(self.cached):
            return None
        if self.budget is not None and not self.budget.reserve(n):
            return None
        out = []
        for _ in range(n):
            if self.free:
                p = self.free.pop()
            else:
                p, key = self.cached.popitem(last=False)   # LRU victim
                self._spill(p, key)
                self._unpublish(p)
                self.prefix_evictions += 1
            self.refcount[p] = 1
            out.append(p)
        self.pages_grabbed += n
        if self._pending_prefetch:
            # a re-grabbed page must not receive a stale queued H2D copy
            # (its chain data was already re-spilled from the queue above)
            outset = set(out)
            self._pending_prefetch = [(q, e) for q, e in
                                      self._pending_prefetch
                                      if q not in outset]
        return out

    def _unref(self, p: int) -> int:
        """Drop one reference to page p; 1 when it became reclaimable.
        Published pages retire to the LRU cached pool."""
        self.refcount[p] -= 1
        assert self.refcount[p] >= 0, f"page {p} refcount underflow"
        if self.refcount[p] > 0:
            return 0
        if self.budget is not None:
            self.budget.release(1)
        key = self.page_key.get(p)
        if key is not None:
            self.cached[p] = key
        else:
            self.free.append(p)
        return 1

    def _drop_pages(self, rid: int) -> int:
        """Unmap all of rid's pages (keep the rid entry and slot)."""
        n = 0
        for p in reversed(self.tables.get(rid, [])):
            n += self._unref(p)
        self.tables[rid] = []
        self._reg_state.pop(rid, None)
        s = self.seq_of.get(rid)
        if s is not None:
            self.block_tables[s] = 0
            self.seq_len[s] = 0
            self._zero_lane_rows(s)
        return n

    # --------------------------- seq slots ----------------------------- #
    def acquire(self, rid: int) -> Optional[int]:
        if rid in self.seq_of:
            return self.seq_of[rid]
        if not self.free_seqs:
            return None
        s = self.free_seqs.pop()
        self.seq_of[rid] = s
        self.seq_len[s] = 0
        self.block_tables[s] = 0
        self._zero_lane_rows(s)
        return s

    def _zero_lane_rows(self, s: int) -> None:
        """Reset slot s's SSM lane rows to the zero state (a device
        fill; no host sync), on every shard that holds them."""
        owner, row = self._lane_owner(s)
        for i, pools in enumerate(self.shard_pools):
            if owner is not None and i != owner:
                continue
            for pool, ax in zip(pools, self.lane_select_axes()):
                if ax >= 0:
                    for leaf in pool.values():
                        leaf.select(ax, row).zero_()

    def admit(self, rid: int, expected_total: int, tokens=None) -> bool:
        """Admission = a sequence slot + pages for the expected context;
        with ``tokens`` and sharing on, the longest published chain is
        mapped in first and ``length(rid)`` reports the hit."""
        fresh_slot = rid not in self.seq_of
        if self.acquire(rid) is None:
            return False
        hit = 0
        if self.share_prefix and tokens is not None:
            hit = self._share_pages(rid, tokens)
        if not self.extend(rid, expected_total):
            self._partial_pending = 0
            self._drop_pages(rid)
            if fresh_slot:
                self.tables.pop(rid, None)
                self.free_seqs.append(self.seq_of.pop(rid))
            return False
        self.partial_hit_tokens += self._partial_pending
        self._partial_pending = 0
        self.seq_len[self.seq_of[rid]] = hit
        return True

    def resume(self, rid: int, expected_total: int,
               tokens=None) -> Optional[int]:
        """Re-reserve pages for a preempted request's recompute context,
        re-sharing any still-published prefix; the hit, or None while the
        pool is short (nothing stays mapped then)."""
        if rid not in self.seq_of:
            return None
        hit = 0
        if self.share_prefix and tokens is not None \
                and not self.tables.get(rid):
            hit = self._share_pages(rid, tokens)
        if not self.extend(rid, expected_total):
            self._partial_pending = 0
            if hit:
                self._drop_pages(rid)
            return None
        self.partial_hit_tokens += self._partial_pending
        self._partial_pending = 0
        self.seq_len[self.seq_of[rid]] = hit
        return hit

    # ------------------ page ops (block table in lockstep) -------------- #
    def _map_pages(self, rid: int, start: int, pages: list[int]) -> None:
        s = self.seq_of.get(rid)
        if s is None or start >= self.max_pages_per_seq or not pages:
            return
        end = min(start + len(pages), self.max_pages_per_seq)
        self.block_tables[s, start:end] = pages[:end - start]

    def allocate(self, rid: int, n_tokens: int) -> Optional[list[int]]:
        have = len(self.tables.get(rid, []))
        pages = self._grab_pages(self.pages_needed(n_tokens))
        if pages is None:
            return None
        self.tables.setdefault(rid, []).extend(pages)
        self._map_pages(rid, have, pages)
        return pages

    def extend(self, rid: int, new_total_tokens: int) -> bool:
        have = len(self.tables.get(rid, []))
        need = self.pages_needed(new_total_tokens)
        if need <= have:
            return True
        pages = self._grab_pages(need - have)
        if pages is None:
            return False
        self.tables.setdefault(rid, []).extend(pages)
        self._map_pages(rid, have, pages)
        return True

    def release(self, rid: int) -> int:
        n = self._drop_pages(rid)
        self.tables.pop(rid, None)
        s = self.seq_of.pop(rid, None)
        if s is not None:
            self.free_seqs.append(s)
        return n

    def preempt(self, rid: int) -> int:
        """Drop rid's page references but keep its slot for a recompute
        prefill after re-admission; returns pages physically freed."""
        return self._drop_pages(rid)

    def truncate(self, rid: int, n_tokens: int) -> None:
        """Roll back the last n cache positions: a length decrement."""
        self.seq_len[self.seq_of[rid]] -= n_tokens

    def length(self, rid: int) -> int:
        return int(self.seq_len[self.seq_of[rid]])

    def token_capacity(self, rid: int) -> int:
        """Max context this request could reach right now."""
        have = len(self.tables.get(rid, []))
        return min(self.max_len, (have + self.free_pages) * self.page_size)

    # ------------------------- host spill tier -------------------------- #
    def _paged_axes(self) -> tuple:
        """Per-segment page axis of the pool leaves (None for unpaged SSM
        lane rows; 1 when the segment spans n > 1 layers)."""
        return tuple(None if kind == "ssm" else (1 if n > 1 else 0)
                     for kind, n in self.cfg.segments())

    def _page_to_host(self, p: int) -> list:
        """Device→host copy of page ``p`` of every paged pool leaf, one
        ``{"self": {leaf: tensor}}`` per paged segment (``()`` for
        unpaged ones).  On a card each leaf goes into a fresh pinned
        buffer by one asynchronous copy on the current stream: the host
        may read the buffers only after ``_sync_d2h``.  Under a mesh the
        page is whole: a leaf split over the shards is concatenated on
        the first shard's device first."""
        cuda = self.device.type == "cuda"
        out = []
        for page in self.page_view(p):
            if page is None:
                out.append(())
                continue
            leaves = {}
            for name, src in page.items():
                if cuda:
                    dst = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=True)
                    dst.copy_(src, non_blocking=True)
                else:
                    dst = src.clone()
                leaves[name] = dst
            out.append({"self": leaves})
        if cuda:
            self._d2h_done = torch.cuda.Event()
            self._d2h_done.record(torch.cuda.current_stream(self.device))
        return out

    def page_view(self, p: int) -> list:
        """Page ``p`` of every paged pool leaf, ``{leaf: tensor}`` per
        segment (None for unpaged ones): views of the pools, or under a
        mesh the whole page, a leaf split over the shards concatenated on
        the first shard's device."""
        out = []
        for seg, (pool, ax) in enumerate(zip(self.shard_pools[0],
                                             self._paged_axes())):
            if ax is None:
                out.append(None)
                continue
            page = {}
            for name, leaf in pool["self"].items():
                page[name] = leaf.select(ax, p)
                kv_ax = self._leaf_axis(seg, name)
                if kv_ax is not None:          # the page axis precedes it
                    page[name] = torch.cat(
                        [sp[seg]["self"][name].select(ax, p).to(self.device)
                         for sp in self.shard_pools], dim=kv_ax - 1)
            out.append(page)
        return out

    def _sync_d2h(self) -> None:
        """Wait until every spill's D2H copy has landed (one event: the
        copies share the current stream); a no-op on the CPU, where the
        copies are synchronous."""
        if self._d2h_done is not None:
            self._d2h_done.synchronize()
            self._d2h_done = None

    def _spill(self, p: int, key: int) -> None:
        """Retag an LRU-evicted published page as SPILLED: its contents
        move to a host entry under the same chain hash, so the chain stays
        matchable after the device page is reallocated.  A page whose own
        H2D prefetch is still queued spills from the queued host copy (the
        device page may not hold the bytes yet)."""
        if self.host_spill_pages <= 0:
            return
        chunk = self.page_tokens.get(p)
        if chunk is None:
            return
        data = None
        for q, e in self._pending_prefetch:
            if q == p:
                data = e.data
                break
        if data is None:
            data = self._page_to_host(p)
        self._host_insert(key, _HostEntry(self.page_parent.get(p),
                                          chunk, data))
        self.spilled_pages += 1

    def _host_insert(self, key: int, entry: _HostEntry) -> bool:
        """Insert a host entry under its own LRU budget, evicting the
        oldest entries first (a host eviction is final).  An evicted
        entry still queued for a prefetch stays alive in the queue."""
        if self.host_spill_pages <= 0:
            return False
        if key in self.host_index:
            self.host_index.move_to_end(key)
            return False
        while self.host_used >= self.host_spill_pages:
            self.host_index.popitem(last=False)
            self.host_used -= 1
            self.host_evictions += 1
        self.host_index[key] = entry
        self.host_used += 1
        return True

    def _prefetch_page(self, h: int, parent: Optional[int],
                       chunk: tuple) -> Optional[int]:
        """Move a spilled chain entry host→device: grab one fresh device
        page, re-publish it under the chain hash (``_publish`` removes the
        host entry) and queue the H2D copy for ``flush_prefetch``.  None
        when pages or budget are short: the hit truncates there, as
        ``prefix_discounts`` promised."""
        entry = self.host_index.get(h)
        if entry is None:
            return None
        fresh = self._grab_pages(1)
        if fresh is None:
            return None
        q = fresh[0]
        self._pending_prefetch.append((q, entry))
        self._publish(q, h, parent, chunk)
        self.prefetched_pages += 1
        self.spilled_hit_tokens += len(chunk)
        return q

    def flush_prefetch(self) -> int:
        """Run every queued host→device page copy; returns pages copied.
        Per pool leaf the queued entries are stacked into one staging
        tensor (pinned on a card: ``torch.stack`` of pinned tensors would
        return pageable memory, from which a ``non_blocking`` copy is
        synchronous), copied to the device in one ``non_blocking`` copy
        and written on the page axis by one ``index_copy_``, all on the
        current stream, so every later kernel on it reads the prefetched
        content.  The engine flushes at the top of ``execute()``;
        ``lane_cache`` and ``_copy_pages`` flush before they read."""
        if not self._pending_prefetch:
            return 0
        pend, self._pending_prefetch = self._pending_prefetch, []
        self._sync_d2h()          # a queued entry may be a spill in flight
        cuda = self.device.type == "cuda"
        if cuda:                  # drop staging the stream has passed
            self._h2d_inflight = [x for x in self._h2d_inflight
                                  if not x[0].query()]
        di = {dev: torch.as_tensor([q for q, _ in pend], dtype=torch.long,
                                   device=dev) for dev in set(self.devices)}
        staged = []
        for i, (pool, ax) in enumerate(zip(self.shard_pools[0],
                                           self._paged_axes())):
            if ax is None:
                continue
            for name, leaf in pool["self"].items():
                xs = [e.data[i]["self"][name] for _, e in pend]
                if cuda:
                    shape = list(xs[0].shape)
                    shape.insert(ax, len(xs))
                    buf = torch.empty(shape, dtype=leaf.dtype,
                                      pin_memory=True)
                    torch.stack(xs, dim=ax, out=buf)
                    staged.append(buf)
                    vals = buf.to(self.device, non_blocking=True)
                else:
                    vals = torch.stack(xs, dim=ax)
                self._write_pages(i, name, ax, di, vals)
        if cuda:
            # the staging buffers live until the stream passes the copies
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._h2d_inflight.append((ev, staged))
        self.prefetch_flushes += 1
        return len(pend)

    def _write_pages(self, seg: int, name: str, ax: int, di: dict,
                     vals: torch.Tensor) -> None:
        """Write whole pages ``vals`` (page axis ``ax``) at the pages
        ``di[device]`` of leaf ``name`` of segment ``seg``, each shard its
        slice of a split leaf."""
        kv_ax = self._leaf_axis(seg, name)
        n = len(self.shard_pools)
        for i, (sp, dev) in enumerate(zip(self.shard_pools, self.devices)):
            v = vals
            if kv_ax is not None:
                w = vals.shape[kv_ax] // n
                v = vals.narrow(kv_ax, i * w, w)
            sp[seg]["self"][name].index_copy_(ax, di[dev], v.to(dev))

    def prefetch_seconds(self, n_pages: int) -> float:
        """Modeled H2D latency of prefetching ``n_pages`` spilled pages:
        the term the DP planner charges against a spilled hit's TTFT
        deadline."""
        if n_pages <= 0:
            return 0.0
        return (n_pages * kv_page_bytes(self.cfg, self.page_size, self.dtype)
                / (self.h2d_gbps * 1e9))

    # -------------------- cross-manager chain transfer ------------------ #
    def root_chains(self) -> list[int]:
        """Chain hashes of every resident first-page entry (device or
        host): the exportable chain roots."""
        roots = [self.page_key[p] for p in self.children.get(None, ())]
        roots += [h for h, e in self.host_index.items() if e.parent is None]
        return roots

    def export_chain(self, h: int) -> list[tuple]:
        """Export the published chain rooted at hash ``h`` as host-tier
        entries ``(hash, parent, chunk, data)``, walking device and host
        entries alike (D2H-copying device pages, then waiting for the
        copies, so another manager may read the data).  Linear chains
        only: a branching chain exports its smallest-page-id branch."""
        self.flush_prefetch()      # device reads below must see content
        out: list[tuple] = []
        while h is not None and len(out) < self.max_pages_per_seq:
            p = self.prefix_index.get(h)
            if p is not None:
                out.append((h, self.page_parent.get(p),
                            self.page_tokens.get(p), self._page_to_host(p)))
            elif h in self.host_index:
                e = self.host_index[h]
                out.append((h, e.parent, e.chunk, e.data))
            else:
                break
            nxt = None
            kids = self.children.get(h)
            if kids:
                nxt = self.page_key[min(kids)]
            else:
                for hh, e in self.host_index.items():
                    if e.parent == h:
                        nxt = hh
                        break
            h = nxt
        self._sync_d2h()
        return out

    def install_host_chain(self, entries: list[tuple]) -> int:
        """Install exported chain entries into this manager's HOST tier
        (proactive placement, drain-time spill to survivors).  Hashes
        already resident, device-published or spilled, are skipped, so
        installs are idempotent and a chain never sits in both indexes.
        Returns entries installed."""
        if self.host_spill_pages <= 0 or not self.share_prefix:
            return 0
        n = 0
        for h, parent, chunk, data in entries:
            if h in self.prefix_index or h in self.host_index \
                    or chunk is None:
                continue
            if self._host_insert(h, _HostEntry(parent, tuple(chunk), data)):
                n += 1
        return n

    # ------------------------- prefix sharing --------------------------- #
    @staticmethod
    def _chain(parent: Optional[int], chunk) -> int:
        return hash((parent, tuple(int(t) for t in chunk)))

    def probe_prefix(self, tokens) -> int:
        """Longest prefix (in tokens) ``_share_pages`` would map for this
        stream right now, capped at ``len(tokens) - 1``; read-only (the
        cluster's prefix-affinity probe).  It truncates where the budget
        would, as ``prefix_discounts`` does."""
        return self.prefix_discounts(tokens)[0]

    def live_prefix_pages(self, tokens, exclude_pages=None) -> int:
        """Matched prefix pages currently mapped by other requests."""
        return self.prefix_discounts(tokens, exclude_pages)[1]

    def prefix_discounts(self, tokens,
                         exclude_pages=None) -> tuple[int, int, int]:
        """``(probe hit tokens, live pages, spilled pages)`` from one chain
        walk.  ``spilled`` counts the host-tier entries inside the hit,
        each of which costs one fresh device page to deliver (physical
        and budget, mirrored below) and one page of H2D transfer."""
        matches, hit, partial = self._match_pages(tokens)
        live = int(sum(1 for m in matches if m[0] is not None
                       and self.refcount[m[0]] > 0
                       and (exclude_pages is None
                            or m[0] not in exclude_pages)))
        if not matches and partial is None:
            return 0, live, 0
        avail = self.budget.available if self.budget is not None else None
        phys = len(self.free) + len(self.cached)
        usable = 0
        spilled = 0
        for p, _, _, _ in matches:
            if p is not None and self.refcount[p] > 0:
                usable += 1
            elif p is not None:
                # cached revival: one budget page; the page leaves the pool
                if avail is None or avail > 0:
                    if avail is not None:
                        avail -= 1
                    phys -= 1
                    usable += 1
                else:
                    partial = None   # _share_pages truncates the same way
                    break
            else:
                # spilled entry: one freshly grabbed device page
                if phys > 0 and (avail is None or avail > 0):
                    if avail is not None:
                        avail -= 1
                    phys -= 1
                    usable += 1
                    spilled += 1
                else:
                    partial = None
                    break
        out = min(hit, usable * self.page_size)
        if partial is not None and out == hit and phys > 0 \
                and (avail is None or avail > 0):
            out += partial[1]
        return out, live, spilled

    def _match_pages(self, tokens) -> tuple[list[tuple], int,
                                            Optional[tuple[int, int]]]:
        """(matches, hit_tokens, partial) of the longest published chain
        for ``tokens``, walking the device index and the host tier as one
        chain: matches are ``(page, chain_hash, parent, chunk)``, page
        None for a spilled link; ``hit`` is capped at ``len(tokens) - 1``
        and ``partial = (donor_page, head_len)`` extends an uncapped chain
        with a token-verified head of a published boundary page.  Counts
        the root chain's hit in ``chain_hits``."""
        if not self.share_prefix or tokens is None or len(tokens) < 2:
            return [], 0, None
        ps = self.page_size
        h, matches = None, []
        for i in range(len(tokens) // ps):
            chunk = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            nh = self._chain(h, chunk)
            p = self.prefix_index.get(nh)
            # hash match alone is not proof: verify the exact tokens
            if p is not None and self.page_tokens.get(p) == chunk:
                matches.append((p, nh, h, chunk))
            else:
                he = self.host_index.get(nh)
                if he is None or he.chunk != chunk:
                    break
                matches.append((None, nh, h, chunk))
            h = nh
        if matches:
            root = matches[0][1]
            self.chain_hits[root] = self.chain_hits.get(root, 0) + 1
        hit = min(len(matches) * ps, len(tokens) - 1)
        if hit < len(matches) * ps:
            return (matches[:self.pages_needed(hit) if hit else 0],
                    hit, None)
        return matches, hit, self._match_head(h, tokens, hit)

    def _match_head(self, parent: Optional[int], tokens,
                    start: int) -> Optional[tuple[int, int]]:
        """Longest token-verified head of a published boundary page that
        extends chain ``parent`` past ``start``; smallest page id breaks
        length ties.  None when ``token_level`` is off."""
        if not self.token_level:
            return None
        room = min(len(tokens) - 1 - start, self.page_size)
        if room <= 0:
            return None
        nxt = [int(t) for t in tokens[start:start + room]]
        best = None
        for p in sorted(self.children.get(parent, ())):
            chunk = self.page_tokens.get(p)
            if not chunk:
                continue
            m = 0
            for a, b in zip(chunk, nxt):
                if a != b:
                    break
                m += 1
            if m > 0 and (best is None or m > best[1]):
                best = (p, m)
        return best

    def _share_pages(self, rid: int, tokens) -> int:
        """Map the longest published chain into rid's (empty) block table
        with refcount bumps; a spilled link is prefetched into a fresh
        page (its copy queued for ``flush_prefetch``); a partial-page
        boundary match appends a CoW copy of the donor's head and counts
        only the verified head."""
        self._partial_pending = 0
        matches, hit, partial = self._match_pages(tokens)
        taken: list[int] = []
        for p, nh, parent, chunk in matches:
            if p is None:
                q = self._prefetch_page(nh, parent, chunk)
                if q is None:   # device pages or budget short: truncate
                    break
                taken.append(q)   # _grab_pages already set refcount = 1
                continue
            if self.refcount[p] > 0:
                self.refcount[p] += 1
            elif self.budget is None or self.budget.reserve(1):
                self.cached.pop(p)
                self.refcount[p] = 1
            else:
                break
            taken.append(p)
        if len(taken) < len(matches):
            hit = min(hit, len(taken) * self.page_size)
            partial = None
        if partial is not None:
            head = self._cow_head(partial[0])
            if head is not None:
                taken.append(head)
                hit += partial[1]
                self._partial_pending = partial[1]
        if not taken:
            return 0
        self.tables.setdefault(rid, []).extend(taken)
        self._map_pages(rid, 0, taken)
        return hit

    def _cow_head(self, donor: int) -> Optional[int]:
        """Copy the published donor page into a fresh exclusively-owned
        page; None when pages or budget are short.  If the grab evicted
        the donor itself, its content is already in place."""
        fresh = self._grab_pages(1)
        if fresh is None:
            return None
        q = fresh[0]
        if q != donor:
            self._copy_pages([donor], [q])
        self.partial_head_copies += 1
        return q

    def register_prefix(self, rid: int, tokens) -> None:
        """Publish rid's full, final pages into the prefix index (call
        after prefill writes; ``tokens`` = the exact cache content)."""
        if not self.share_prefix:
            return
        pages = self.tables.get(rid, [])
        ps = self.page_size
        done, h = self._reg_state.get(rid, (0, None))
        n_full = min(len(tokens) // ps, len(pages))
        for i in range(done, n_full):
            chunk = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            parent = h
            h = self._chain(h, chunk)
            p = pages[i]
            if h in self.prefix_index or p in self.page_key:
                continue
            self._publish(p, h, parent, chunk)
        if n_full > done:
            self._reg_state[rid] = (n_full, h)

    def _publish(self, p: int, h: int, parent: Optional[int],
                 chunk: tuple) -> None:
        self.prefix_index[h] = p
        self.page_key[p] = h
        self.page_tokens[p] = chunk
        self.page_parent[p] = parent
        self.children.setdefault(parent, set()).add(p)
        # a chain is never device-published and spilled at once
        if self.host_index.pop(h, None) is not None:
            self.host_used -= 1

    def _unpublish(self, p: int) -> None:
        key = self.page_key.pop(p, None)
        if key is None:
            return
        del self.prefix_index[key]
        self.page_tokens.pop(p, None)
        parent = self.page_parent.pop(p, None)
        kids = self.children.get(parent)
        if kids is not None:
            kids.discard(p)
            if not kids:
                del self.children[parent]

    def ensure_writable(self, rid: int, start_tok: int,
                        n_tokens: int) -> None:
        """Copy-on-write barrier before rid writes positions
        ``[start_tok, start_tok + n_tokens)``: shared pages are copied into
        fresh ones and remapped, exclusively-owned published pages are
        unpublished.  Transactional: raises RuntimeError with no state
        mutated when the copy targets cannot be grabbed."""
        if not self.share_prefix or n_tokens <= 0:
            return
        pages = self.tables.get(rid, [])
        ps = self.page_size
        first = start_tok // ps
        last = min((start_tok + n_tokens - 1) // ps, len(pages) - 1)
        idx = [i for i in range(first, last + 1)
               if self.refcount[pages[i]] > 1]
        fresh = self._grab_pages(len(idx)) if idx else []
        if fresh is None:
            raise RuntimeError(
                f"request {rid}: out of KV pages for copy-on-write")
        for i in range(first, last + 1):
            p = pages[i]
            if self.refcount[p] <= 1 and p in self.page_key:
                self._unpublish(p)
        src, dst = [], []
        for i, q in zip(idx, fresh):
            p = pages[i]
            self.refcount[p] -= 1            # still shared by the others
            pages[i] = q
            src.append(p)
            dst.append(q)
        if not src:
            return
        self._copy_pages(src, dst)
        s = self.seq_of.get(rid)
        if s is not None:
            cols = [i for i in idx if i < self.max_pages_per_seq]
            self.block_tables[s, cols] = [pages[i] for i in cols]
        self.cow_copies += len(src)

    def check_writable(self, rid: int, start_tok: int,
                       n_tokens: int) -> list[int]:
        """The write set handed to the fused prefill kernel: the pages
        covering ``[start_tok, start_tok + n_tokens)``, asserted
        exclusively owned and unpublished (the kernel writes them with no
        further checks)."""
        pages = self.tables.get(rid, [])
        ps = self.page_size
        first = start_tok // ps
        last = min((start_tok + n_tokens - 1) // ps, len(pages) - 1)
        out = [pages[i] for i in range(first, last + 1)] if n_tokens > 0 \
            else []
        if self.share_prefix:
            for p in out:
                assert self.refcount[p] == 1, \
                    f"page {p} of rid {rid} still shared at write time"
                assert p not in self.page_key, \
                    f"page {p} of rid {rid} still published at write time"
        return out

    def _copy_pages(self, src: list[int], dst: list[int]) -> None:
        """Copy pages ``src`` onto pages ``dst`` in every pool, in place
        (the right-hand side is gathered before the write).  Pending
        prefetches flush first: a source may be a prefetched page whose
        copy is still queued."""
        self.flush_prefetch()
        for pools, dev in zip(self.shard_pools, self.devices):
            si = torch.as_tensor(src, dtype=torch.long, device=dev)
            di = torch.as_tensor(dst, dtype=torch.long, device=dev)
            for pool, ax in zip(pools, self._paged_axes()):
                if ax is None:
                    continue                   # lane rows: nothing paged
                for leaf in pool["self"].values():
                    leaf.index_copy_(ax, di, leaf.index_select(ax, si))

    # ------------------------ device-facing views ----------------------- #
    def table_rows(self, slots) -> torch.Tensor:
        """(len(slots), max_pages_per_seq) int32 block-table rows on the
        device."""
        rows = np.ascontiguousarray(self.block_tables[np.asarray(slots)])
        return torch.from_numpy(rows).to(self.device)

    def lane_select_axes(self) -> list[int]:
        """Per segment, the lane axis of its SSM lane rows (1 when stacked
        over layers, else 0), or -1 for a page-pool segment."""
        return [(1 if n > 1 else 0) if kind == "ssm" else -1
                for kind, n in self.cfg.segments()]

    def lane_cache(self, slots):
        """The cache a model call reads: page pools pass through whole
        (global, addressed by block tables, updated in place); SSM lane
        rows are gathered to one row per batch lane (``slots`` may repeat
        a slot for padded lanes).  Pending prefetches flush first, so the
        view never exposes a page whose copy is still queued.  Under a mesh
        a list with one such cache per shard: its own pools, and every
        lane's rows (gathered from their owners when they split over the
        shards) in memory of its own, since each shard computes them."""
        self.flush_prefetch()
        if self.mesh is None:
            idx = torch.as_tensor(slots, dtype=torch.long,
                                  device=self.device)
            return [pool if ax < 0 else
                    {k: v.index_select(ax, idx) for k, v in pool.items()}
                    for pool, ax in zip(self.pools, self.lane_select_axes())]
        axes = self.lane_select_axes()
        rows = [None if ax < 0 else {k: self._gather_lanes(seg, k, ax, slots)
                                     for k in pool}
                for seg, (pool, ax) in enumerate(zip(self.shard_pools[0],
                                                     axes))]
        return [[pool if ax < 0 else
                 {k: v.to(dev, copy=True) for k, v in rows[seg].items()}
                 for seg, (pool, ax) in enumerate(zip(pools, axes))]
                for pools, dev in zip(self.shard_pools, self.devices)]

    def _gather_lanes(self, seg: int, name: str, ax: int, slots):
        """The lane rows of ``slots`` (lane axis ``ax``) of leaf ``name``
        of segment ``seg`` on the first shard's device, each read from a
        shard that holds it."""
        if self._lanes_per_shard is None:
            idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
            return self.shard_pools[0][seg][name].index_select(ax, idx)
        owners: dict = {}
        for b, s in enumerate(slots):
            j, row = self._lane_owner(s)
            owners.setdefault(j, ([], []))
            owners[j][0].append(b)
            owners[j][1].append(row)
        leaf0 = self.shard_pools[0][seg][name]
        shape = list(leaf0.shape)
        shape[ax] = len(slots)
        out = torch.empty(shape, dtype=leaf0.dtype, device=self.device)
        for j, (lanes, local) in owners.items():
            src = self.shard_pools[j][seg][name]
            got = src.index_select(ax, torch.as_tensor(
                local, dtype=torch.long, device=src.device))
            out.index_copy_(ax, torch.as_tensor(lanes, dtype=torch.long,
                                                device=self.device),
                            got.to(self.device))
        return out

    def absorb(self, slots, new_cache) -> None:
        """Store a model call's updated cache: page pools were updated in
        place; the first ``len(slots)`` lane rows scatter back to their
        slots (padded lanes after them alias ``slots[0]`` and are
        dropped).  Under a mesh ``new_cache`` has one cache per shard, and
        each shard takes the rows it holds from its own."""
        axes = self.lane_select_axes()
        if all(ax < 0 for ax in axes):
            return
        if self.mesh is None:
            idx = torch.as_tensor(slots, dtype=torch.long,
                                  device=self.device)
            for pool, new, ax in zip(self.pools, new_cache, axes):
                if ax >= 0:
                    for k, leaf in pool.items():
                        leaf.index_copy_(ax, idx,
                                         new[k].narrow(ax, 0, len(slots)))
            return
        for i, (pools, new_i, dev) in enumerate(zip(
                self.shard_pools, new_cache, self.devices)):
            lanes, rows = [], []
            for b, s in enumerate(slots):
                j, row = self._lane_owner(s)
                if j is None or j == i:
                    lanes.append(b)
                    rows.append(row)
            if not lanes:
                continue
            src = torch.as_tensor(lanes, dtype=torch.long, device=dev)
            idx = torch.as_tensor(rows, dtype=torch.long, device=dev)
            for pool, new, ax in zip(pools, new_i, axes):
                if ax < 0:
                    continue
                for k, leaf in pool.items():
                    leaf.index_copy_(ax, idx, new[k].index_select(ax, src))
