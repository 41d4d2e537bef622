"""Continuous-batching execution engine on a paged, device-resident KV
runtime (port of ``repro/serving/engine.py``).

The engine executes planner ``Batch`` objects:
  * PREFILL entries process the next chunk of a request's pending context,
    grouped into lanes of same-bucket chunks; one model call per group
    writes the chunks' KV into the page pools through the fused prefill
    kernel and samples each lane's token at its last real position.
  * DECODE entries emit tokens autoregressively.  All requested steps of a
    batch group run back to back on the device — sampling, EOS masking,
    per-lane step budgets, position advance and page writes included — and
    only the final (B, n_steps) token matrix is copied to the host: one
    host sync per group, as in the reference's single jitted scan.  The
    loop is eager PyTorch; capturing it in a CUDA graph is later work.
  * SSM models (Mamba2) keep per-slot lane rows instead of pages: each
    call reads them gathered to its lanes (``kv.lane_cache``) and scatters
    the live lanes' rows back (``kv.absorb``).
  * Encoder or image conditioning (whisper, the VLM): a request admitted
    with ``enc_states`` (1, T, D) keeps them in its context; every call
    stacks its lanes' states (zeros for lanes without, and for padded
    lanes) and each ``cross_attn`` layer attends to them.  Conditioned
    and unconditioned chunks never share a prefill group, and a
    conditioned prompt never shares prefix pages (its KV depends on more
    than its tokens).
  * With a draft model (``draft=(cfg, params)``), a batch planned with
    ``spec_step > 0`` runs its decodes one request at a time through
    ``serving/spec_decode.SpecDecoder``: draft steps, then one verify
    forward of the target through the verify kernel (``"verify"`` span).

Weights and activations are float32; on the card TF32 is off
(``device.resolve_device``).  ``EngineConfig.dtype`` sets the dtype of
the KV page pools, as the reference's does: float32 (the default),
bfloat16 or float16.  In 16 bits each K/V row is rounded to nearest even
when it is written and widened to float32 when it is read, by the paged
kernels (B1-B4) and by the plain ``paged_write`` scatter alike, so a chunk
attends over its own rows as stored.  16-bit serving of an SSM-bearing
model raises ``NotImplementedError`` (the reference fails there: its
decode scan's carry changes dtype), and so does any other dtype.
MoE models run with the reference's dropless capacity factor E / k; their
MoE layers read the per-expert unit counts on the host (``models/moe.py``),
one more sync per MoE layer per step than a dense model's decode loop.

``counters`` counts device calls (prefill_calls, decode_calls,
decode_tokens, spec_draft_calls, spec_verify_calls) with the reference's
keys.  ``prefill_fused_ops`` and ``verify_fused_ops`` count
``attention.OP_STATS`` deltas per call: the port runs eagerly, where JAX
counts only in freshly traced programs, so they agree with the reference
only on a first trace.  Every prefill and every verify goes through its
fused kernel, so the reference's ``prefill_scatter_ops``,
``prefill_attn_ops``, ``verify_scatter_ops`` and ``verify_attn_ops`` (the
unfused gather path) have no counterpart: the last two stay 0.  Three
counters are the port's own: ``decode_steps`` sums the bucketed step
counts of the decode groups, ``spec_draft_steps`` those of the draft
loops, and ``spec_catch_up_calls`` counts the draft's catch-up prefills
(each step launches the decode kernel once per layer, each catch-up the
prefill kernel).

The host spill tier (``EngineConfig.host_spill_pages > 0``,
``serving/kvcache.py``) is ported.  Admissions queue the H2D copies of
spilled prefix pages and ``execute()`` flushes them first.

``EngineConfig`` reads the reference's environment defaults on every
instantiation: ``REPRO_SHARE_PREFIX`` (prefix sharing, default on),
``REPRO_TOKEN_LEVEL_PREFIX`` (partial-page head matching, default on;
off is page-granular matching), and ``REPRO_HOST_SPILL`` /
``REPRO_HOST_SPILL_PAGES`` (the host tier: 256 pages under
``REPRO_HOST_SPILL=1``, or the number given).  A field passed
explicitly wins.  ``prefix_aware_admission`` (default off) lets the
frontend shave a request's up-front page reservation by its probed
cached-prefix hit.

Mesh-sharded serving (``EngineConfig.mesh``, a
``distributed.sharding.ServingMesh``): the engine cuts its parameters
per the serving shard plan once (head-sharded GQA, column-sharded dense
FFN, expert-parallel MoE, head-sharded MLA over replicated latent pools;
``ShardedParams`` lets several engines share one cut) and places its KV
pools (``PagedKVManager.place``).  Its host work (admission, the
allocator, block tables, batch preparation) runs once; each device
program (``_prefill_forward``, ``_verify_forward``, ``_decode_loop``)
runs once per shard, on the shard's worker thread, with
``model_forward(shard=...)``, and every shard samples with a generator
of its own seeded with ``ecfg.seed``.  The engine reads shard 0's
tokens and raises if any shard's differ: a shard that fed another next
token would corrupt its own KV unseen.  Counters count device calls, as
without a mesh; ``prefill_fused_ops`` and ``verify_fused_ops`` count
every shard's launches.  A model with ``cross_attn`` layers cannot serve
over a mesh that splits heads (its pools would split while the blocks
replicate; the reference fails there too) and raises
``NotImplementedError``.

Not ported yet: speculative decoding over an SSM model (rollback by
truncation cannot roll back lane state); asking for it raises
``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core.batch import Batch
from repro_torch.core.slo import StageKind
from repro_torch.device import generator, resolve_device
from repro_torch.distributed.sharding import (ServingMesh, ShardedParams,
                                              ShardWorkers, serving_shard_plan,
                                              shard_params)
from repro_torch.kernels.paged_attention import PAGE_DTYPES
from repro_torch.models import attention as _attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import dropless_capacity_factor
from repro_torch.models.transformer import logits_fn, model_forward
from repro_torch.serving.kvcache import PagedKVManager
from repro_torch.serving.sampling import sample

_NULL_CTX = contextlib.nullcontext()


def _bucket(n: int, buckets=(8, 16, 32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 2047) // 2048) * 2048


def _env_flag(name: str, default: bool) -> bool:
    """An ``EngineConfig`` default flipped from the environment, read per
    instantiation (so monkeypatching works); an explicit field wins."""
    v = os.environ.get(name)
    return default if v is None else v.lower() not in ("0", "false", "off")


def _env_int(name: str, default: int) -> int:
    """Integer-valued environment default, read as ``_env_flag`` is."""
    v = os.environ.get(name)
    return default if v is None else int(v)


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 8                # max concurrent sequences
    max_len: int = 512                # per-sequence context cap (table width)
    page_size: int = 16
    total_pages: int = 1024
    temperature: float = 0.0
    seed: int = 0
    # prefix sharing with refcounts + copy-on-write (serving/kvcache.py)
    share_prefix: bool = dataclasses.field(
        default_factory=lambda: _env_flag("REPRO_SHARE_PREFIX", True))
    # token-level partial-page matching: a prompt diverging mid-page
    # reuses the verified head of the boundary page through a CoW'd copy;
    # False = page-granular hits only
    token_level_prefix: bool = dataclasses.field(
        default_factory=lambda: _env_flag("REPRO_TOKEN_LEVEL_PREFIX", True))
    # prefix-aware admission: the frontend shaves the up-front reservation
    # by the probed cached-prefix hit (decode growth extends on demand)
    prefix_aware_admission: bool = False
    # host-RAM spill tier for evicted prefix pages (kvcache.py): that many
    # pages of host budget; REPRO_HOST_SPILL=1 turns it on at 256 pages,
    # REPRO_HOST_SPILL_PAGES sets the number.  h2d_gbps is the H2D
    # bandwidth the planner's prefetch-latency term assumes
    host_spill_pages: int = dataclasses.field(
        default_factory=lambda: _env_int(
            "REPRO_HOST_SPILL_PAGES",
            256 if _env_flag("REPRO_HOST_SPILL", False) else 0))
    h2d_gbps: float = 16.0
    # dtype of the KV page pools (and SSM lane rows): float32, bfloat16 or
    # float16
    dtype: torch.dtype = torch.float32
    # mesh-sharded serving: a distributed.sharding.ServingMesh runs each
    # device program once per shard over ``shard_axes`` (what shards is
    # divisibility-gated per model: serving_shard_plan); None = one device
    mesh: object = None
    shard_axes: str = "model"


def check_kv_dtype(cfg: ModelConfig, dtype) -> None:
    """Refuse a pool dtype the port does not serve: anything but float32,
    bfloat16 and float16 (the paged kernels' ``PAGE_DTYPES``), and any
    dtype but float32 for a model with SSM layers, which the reference
    cannot serve either: its first decode group raises ``TypeError: scan
    body function carry input and carry output must have equal types``
    (``repro/serving/engine.py:341``; the 16-bit conv carry comes back as
    float32 from ``ssm_decode_step``)."""
    if dtype not in PAGE_DTYPES:              # the paged kernels' dtypes
        raise NotImplementedError(
            f"KV pools of {dtype} are not served (float32, bfloat16, "
            "float16)")
    if dtype != torch.float32 and any(
            kind == "ssm" for kind, _ in cfg.segments()):
        raise NotImplementedError(
            f"{cfg.name}: serving an SSM model with {dtype} lane rows is "
            "not ported, as the reference cannot serve it: its first "
            "decode group raises 'TypeError: scan body function carry "
            "input and carry output must have equal types' "
            "(repro/serving/engine.py:341)")


@dataclasses.dataclass
class RequestCtx:
    rid: int
    prompt: list
    pending: list            # tokens not yet prefilled (prompt or tool ctx)
    generated: list
    eos: Optional[int] = None
    done: bool = False
    # preemption bookkeeping: ``history`` mirrors the KV cache content, so
    # a preempted request re-prefills it verbatim; ``replay`` counts
    # pending tokens that are recompute work; ``recompute`` suppresses the
    # one prefill-completion emission that would re-sample a token
    history: list = dataclasses.field(default_factory=list)
    replay: int = 0
    recompute: bool = False
    enc_states: Optional[torch.Tensor] = None    # VLM / enc-dec conditioning


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig = None,
                 draft: Optional[tuple] = None, kv_budget=None, device=None):
        self.ecfg = ecfg or EngineConfig()
        check_kv_dtype(cfg, self.ecfg.dtype)
        self.mesh = self.ecfg.mesh
        self._plan = None
        if self.mesh is not None:
            if not isinstance(self.mesh, ServingMesh):
                raise TypeError("EngineConfig.mesh: need a ServingMesh "
                                "(distributed.sharding.make_serving_mesh), "
                                f"got {type(self.mesh).__name__}")
            if device is not None and \
                    resolve_device(device) != self.mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {self.mesh.devices[0]}")
            device = self.mesh.devices[0]
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.kv = PagedKVManager(cfg, total_pages=self.ecfg.total_pages,
                                 page_size=self.ecfg.page_size,
                                 max_seqs=self.ecfg.max_slots,
                                 max_len=self.ecfg.max_len,
                                 dtype=self.ecfg.dtype,
                                 budget=kv_budget,
                                 share_prefix=self.ecfg.share_prefix,
                                 token_level=self.ecfg.token_level_prefix,
                                 host_spill_pages=self.ecfg.host_spill_pages,
                                 h2d_gbps=self.ecfg.h2d_gbps,
                                 device=self.device)
        self.reqs: dict[int, RequestCtx] = {}
        self.gen = generator(self.device, self.ecfg.seed)
        self._moe_cf = dropless_capacity_factor(cfg)
        if self.mesh is not None:
            self._shard(params)
        # the reference's keys, and the port's own decode_steps,
        # spec_draft_steps and spec_catch_up_calls (module docstring)
        self.counters = {"prefill_calls": 0, "decode_calls": 0,
                         "decode_steps": 0, "decode_tokens": 0,
                         "spec_draft_calls": 0, "spec_verify_calls": 0,
                         "spec_draft_steps": 0, "spec_catch_up_calls": 0,
                         "preemptions": 0, "prefix_hit_tokens": 0,
                         "prefill_fused_ops": 0, "verify_scatter_ops": 0,
                         "verify_attn_ops": 0, "verify_fused_ops": 0,
                         "spec_accepted_tokens": 0,
                         "spec_drafted_tokens": 0}
        # fresh progress granted by the last admission's prefix hit
        self.last_hit_fresh = 0
        # fresh (non-replay) prefill tokens per rid in the last execute()
        self.last_prefill_progress: dict[int, int] = {}
        # (accepted, drafted) per rid of the last execute()'s verifies,
        # which the frontend folds into its per-class acceptance EWMA
        self.last_spec_stats: dict[int, tuple[int, int]] = {}
        self.tracer = None                # optional StepTracer (duck type)
        # speculative decoding: (draft_cfg, draft_params)
        self.spec = None
        if draft is not None:
            if any(kind == "ssm" for c in (cfg, draft[0])
                   for kind, _ in c.segments()):
                raise NotImplementedError(
                    "speculative decoding over an SSM model is not yet "
                    "ported")
            from repro_torch.serving.spec_decode import SpecDecoder
            self.spec = SpecDecoder(self, draft[0], draft[1])

    # ------------------------- mesh-sharded serving --------------------- #
    def _shard(self, params) -> None:
        """Cut the parameters and place the pools over ``self.mesh``, and
        start one worker thread per shard."""
        cfg, mesh = self.cfg, self.mesh
        self._plan = serving_shard_plan(cfg, mesh, self.ecfg.shard_axes,
                                        max_seqs=self.ecfg.max_slots)
        if self._plan.heads and "cross_attn" in cfg.block_pattern:
            raise NotImplementedError(
                f"{cfg.name}: cross_attn layers replicate while a "
                "head-sharded mesh splits their KV pools (the reference "
                "fails on this too)")
        if isinstance(params, ShardedParams):
            if params.mesh != mesh or params.plan != self._plan:
                raise ValueError("ShardedParams cut for another mesh or plan")
            sharded = params
            self.params = params.source
        else:
            sharded = shard_params(params, cfg, mesh, self._plan)
        self.shard_params = sharded.trees
        self.kv.place(mesh, self._plan)
        self._gens = [generator(d, self.ecfg.seed) for d in mesh.devices]
        self.gen = self._gens[0]
        self._workers = ShardWorkers(mesh, self._plan)

    def _program(self, body, cache, *args):
        """Run a device program: ``body(params, gen, shard, cache, *args)``
        once, or under a mesh once per shard on its worker thread with its
        parameters, generator, ``ShardCtx`` and cache (``kv.lane_cache``
        gives one per shard) and tensor arguments copied to its device.
        Returns shard 0's tokens after checking that every shard's are
        equal."""
        if self.mesh is None:
            return body(self.params, self.gen, None, cache, *args)
        devs = self.mesh.devices

        def one(i, ctx):
            return body(self.shard_params[i], self._gens[i], ctx, cache[i],
                        *[a.to(devs[i]) if isinstance(a, torch.Tensor) else a
                          for a in args])
        outs = self._workers.run(one)
        for i, o in enumerate(outs[1:], 1):
            if not torch.equal(outs[0], o.to(outs[0].device)):
                raise RuntimeError(f"mesh shard {i} emitted other tokens "
                                   "than shard 0")
        return outs[0]

    # ------------------------- device programs -------------------------- #
    def _prefill_forward(self, cache, tokens, pos0, true_len, bt,
                         sample_rows, enc_states=None):
        """One lane-batched chunk group: every lane writes its chunk's KV
        into its own pages and the token at its last REAL position is
        sampled.  Only that hidden row per lane goes through the unembed,
        so the logits never grow with the chunk.  ``sample_rows`` lists the
        lanes whose sample is kept; only they draw random numbers."""
        return self._program(self._prefill_body, cache, tokens, pos0,
                             true_len, bt, sample_rows, enc_states)

    def _prefill_body(self, params, gen, shard, cache, tokens, pos0,
                      true_len, bt, sample_rows, enc_states):
        h, _, _ = model_forward(params, self.cfg, tokens, cache=cache,
                                pos0=pos0, block_tables=bt,
                                chunk_len=true_len, moe_cf=self._moe_cf,
                                enc_states=enc_states, shard=shard)
        idx = (true_len.long() - 1).clamp(min=0)
        last = h[torch.arange(h.shape[0], device=h.device), idx]   # (B, D)
        if self.ecfg.temperature <= 0.0:
            return sample(logits_fn(params, self.cfg, last))
        toks = torch.zeros(h.shape[0], dtype=torch.int32, device=h.device)
        if sample_rows:
            rows = torch.as_tensor(sample_rows, device=h.device)
            lg = logits_fn(params, self.cfg, last[rows])
            toks[rows] = sample(lg, gen, self.ecfg.temperature)
        return toks

    def _verify_forward(self, cache, tokens, pos0, true_len, bt,
                        enc_states=None):
        """Spec-decode verify: one pass over [last, drafts...] through the
        verify kernel; the greedy target token at every row, on the
        device (the caller reads it once)."""
        return self._program(self._verify_body, cache, tokens, pos0,
                             true_len, bt, enc_states)

    def _verify_body(self, params, gen, shard, cache, tokens, pos0,
                     true_len, bt, enc_states):
        h, _, _ = model_forward(params, self.cfg, tokens, cache=cache,
                                pos0=pos0, block_tables=bt,
                                chunk_len=true_len, verify=True,
                                moe_cf=self._moe_cf, enc_states=enc_states,
                                shard=shard)
        return torch.argmax(logits_fn(params, self.cfg, h[0]),
                            dim=-1).to(torch.int32)

    def _decode_loop(self, cache, tokens0, pos0, steps, eos, bt,
                     n_steps: int, enc_states=None):
        """All n_steps decode steps of a batch group, with no host sync
        (beyond the MoE layers' expert counts, module docstring).
        Per-lane step budgets (``steps``) and EOS stop lanes early; frozen
        lanes emit -1 and neither write KV nor advance.  ``active`` goes
        to the model as ``chunk_len``: page writes of frozen lanes go to
        the write-off page, and SSM layers write back
        ``where(active, new, old)`` into the lane rows, as the reference's
        ``_decode_scan`` does for every lane-row leaf.  ``enc_states`` go to
        every step: the cross-attention layers project them again in each
        step, as the reference's scan does."""
        return self._program(self._decode_body, cache, tokens0, pos0, steps,
                             eos, bt, n_steps, enc_states)

    def _decode_body(self, params, gen, shard, cache, tokens0, pos0, steps,
                     eos, bt, n_steps, enc_states):
        B = tokens0.shape[0]
        dev = tokens0.device
        tok, pos = tokens0, pos0
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        emitted = torch.empty((B, n_steps), dtype=torch.int32, device=dev)
        for i in range(n_steps):
            active = (~done) & (steps > i)
            h, _, _ = model_forward(params, self.cfg, tok[:, None],
                                    cache=cache, pos0=pos, block_tables=bt,
                                    chunk_len=active.to(torch.int32),
                                    moe_cf=self._moe_cf,
                                    enc_states=enc_states, shard=shard)
            logits = logits_fn(params, self.cfg, h[:, -1])
            nxt = sample(logits, gen, self.ecfg.temperature)
            emitted[:, i] = torch.where(active, nxt, -1)
            tok = torch.where(active, nxt, tok)
            pos = pos + active.to(pos.dtype)
            done = done | (active & (nxt == eos))
        return emitted

    # ------------------------------------------------------------------ #
    def _share_tokens(self, tokens, enc_states):
        """Prefix-sharing key for an admission, or None when sharing is off
        or unsound for this request (with encoder conditioning the prompt's
        KV depends on more than its tokens)."""
        if not self.ecfg.share_prefix or enc_states is not None:
            return None
        return tokens

    def _consume_hit(self, ctx: RequestCtx, hit: int) -> int:
        """Apply an admission-time prefix hit: ``hit`` leading pending
        tokens move to ``history`` without a prefill.  Returns the fresh
        request-level progress (hit beyond preemption replay)."""
        self.last_hit_fresh = 0
        if hit <= 0:
            return 0
        ctx.history.extend(ctx.pending[:hit])
        ctx.pending = ctx.pending[hit:]
        replayed = min(hit, ctx.replay)
        ctx.replay -= replayed
        self.counters["prefix_hit_tokens"] += hit
        self.last_hit_fresh = hit - replayed
        return self.last_hit_fresh

    def add_request(self, rid: int, prompt: list, expected_total: int,
                    enc_states=None) -> bool:
        """Admit a request: a sequence slot + pages for the expected
        context; a prompt longer than max_len is rejected.  Cached leading
        pages are mapped in and their tokens never re-prefill.
        ``enc_states`` (1, T, D): the request's encoder output or image
        embeddings, moved to the engine's device as float32."""
        if len(prompt) > self.ecfg.max_len:
            return False
        if enc_states is not None:
            enc_states = torch.as_tensor(enc_states, dtype=torch.float32,
                                         device=self.device)
        if not self.kv.admit(rid, expected_total,
                             tokens=self._share_tokens(prompt, enc_states)):
            return False
        ctx = RequestCtx(rid=rid, prompt=list(prompt),
                         pending=list(prompt), generated=[],
                         enc_states=enc_states)
        self.reqs[rid] = ctx
        self._consume_hit(ctx, self.kv.length(rid))
        return True

    def finish(self, rid: int) -> None:
        self.kv.release(rid)
        if self.spec is not None:
            self.spec.release(rid)
        self.reqs.pop(rid, None)

    # --------------------- preemption / re-admission -------------------- #
    def preempt(self, rid: int) -> int:
        """Free a request's pages now, keeping its context and slot; the KV
        is rebuilt later by re-prefilling ``history``, so the greedy stream
        resumes identically.  Returns pages freed."""
        ctx = self.reqs.get(rid)
        if ctx is None:
            return 0
        freed = self.kv.preempt(rid)
        if self.spec is not None:
            self.spec.release(rid)      # draft cache re-syncs on resume
        ctx.recompute = ctx.recompute or (bool(ctx.generated)
                                          and not ctx.pending)
        ctx.replay += len(ctx.history)
        ctx.pending = ctx.history + ctx.pending
        ctx.history = []
        self.counters["preemptions"] += 1
        return freed

    def readmit(self, rid: int, expected_total: int) -> bool:
        """Re-reserve pages for a preempted request's recompute context;
        False while the pool is still short."""
        if rid not in self.reqs or rid not in self.kv.seq_of:
            return False
        ctx = self.reqs[rid]
        hit = self.kv.resume(rid, expected_total,
                             tokens=self._share_tokens(ctx.pending,
                                                       ctx.enc_states))
        if hit is None:
            return False
        self._consume_hit(ctx, hit)
        return True

    def drop(self, rid: int):
        """Evict a request fully (pages and slot), returning its context
        for a later ``restore``."""
        self.kv.release(rid)
        if self.spec is not None:
            self.spec.release(rid)
        return self.reqs.pop(rid, None)

    def restore(self, rid: int, ctx: RequestCtx,
                expected_total: int) -> bool:
        """Re-admit a context evicted by ``drop`` for a recompute prefill."""
        if len(ctx.pending) > self.ecfg.max_len:
            return False
        if not self.kv.admit(rid, expected_total,
                             tokens=self._share_tokens(ctx.pending,
                                                       ctx.enc_states)):
            return False
        self.reqs[rid] = ctx
        self._consume_hit(ctx, self.kv.length(rid))
        return True

    def context_len(self, rid: int) -> int:
        return self.kv.length(rid)

    def rollback(self, rid: int, n_tokens: int) -> None:
        """Discard the last n cache positions: a block-table length
        decrement."""
        if n_tokens:
            self.kv.truncate(rid, n_tokens)

    def _reserve(self, rid: int, new_total: int, on_pressure=None) -> None:
        if new_total > self.ecfg.max_len:
            raise RuntimeError(
                f"request {rid}: context {new_total} exceeds max_len "
                f"{self.ecfg.max_len}")
        if self.kv.extend(rid, new_total):
            return
        if on_pressure is not None:
            short = (self.kv.pages_needed(new_total)
                     - len(self.kv.tables.get(rid, []))
                     - self.kv.free_pages)
            on_pressure(max(short, 1))
            if self.kv.extend(rid, new_total):
                return
        raise RuntimeError(f"request {rid}: out of KV pages")

    def _cow_barrier(self, rid: int, start: int, n: int,
                     on_pressure=None) -> None:
        """Copy-on-write barrier with the same pressure escape hatch as
        ``_reserve``."""
        try:
            self.kv.ensure_writable(rid, start, n)
        except RuntimeError:
            if on_pressure is None:
                raise
            on_pressure(1)
            self.kv.ensure_writable(rid, start, n)

    # ------------------------------------------------------------------ #
    def execute(self, batch: Batch, on_pressure=None) -> dict[int, list]:
        """Run one planner batch; returns {rid: emitted tokens}.
        ``on_pressure(pages_short)`` lets the frontend preempt best-effort
        victims when a page reservation cannot be met.  Prefetches the
        admissions queued are flushed first: their copies run on the
        stream ahead of every kernel of this batch."""
        self.kv.flush_prefetch()
        emitted: dict[int, list] = {}
        self.last_prefill_progress = {}
        self.last_spec_stats = {}
        prefills = []
        decode_rids = []
        for e in batch.entries:
            if e.rid not in self.reqs:
                continue
            if e.kind == StageKind.PREFILL:
                prefills.append((e.rid, e.n_tokens))
            else:
                decode_rids.append((e.rid, e.n_tokens))
        with self._tspan("prefill", n=len(prefills)) if prefills \
                else _NULL_CTX:
            for group in self._group_prefills(prefills, on_pressure):
                for rid, toks in self._prefill_group(*group).items():
                    emitted.setdefault(rid, []).extend(toks)
        if decode_rids:
            if batch.spec_step > 0 and self.spec is not None:
                with self._tspan("verify", n=len(decode_rids)):
                    for rid, n in decode_rids:
                        emitted.setdefault(rid, []).extend(
                            self.spec.decode(rid, n, on_pressure))
            else:
                with self._tspan("decode", n=len(decode_rids)):
                    out = self._decode_batched(dict(decode_rids),
                                               on_pressure)
                    for rid, toks in out.items():
                        emitted.setdefault(rid, []).extend(toks)
        return emitted

    def _tspan(self, name: str, **attrs):
        if self.tracer is None:
            return _NULL_CTX
        return self.tracer.span(name, **attrs)

    # ------------------------------------------------------------------ #
    def _group_prefills(self, entries, on_pressure=None):
        """Reserve pages (and run the CoW barrier) for EVERY chunk first,
        so a failure leaves every prompt retryable; then consume the chunks
        and group same-bucket ones (conditioned and unconditioned chunks
        apart), at most 8 lanes per call."""
        recs = []
        for rid, n in entries:
            ctx = self.reqs[rid]
            L = min(n, len(ctx.pending))
            if L <= 0:
                continue
            pos = self.kv.length(rid)
            self._reserve(rid, pos + L, on_pressure)
            self._cow_barrier(rid, pos, L, on_pressure)
            self.kv.check_writable(rid, pos, L)
            recs.append((rid, ctx.pending[:L], pos))
        for rid, chunk, _ in recs:
            self.reqs[rid].pending = self.reqs[rid].pending[len(chunk):]
        groups: dict = {}
        for rec in recs:
            rid, chunk, _ = rec
            key = (_bucket(len(chunk)),
                   self.reqs[rid].enc_states is not None)
            groups.setdefault(key, []).append(rec)
        out = []
        for (Lp, _), g in groups.items():
            for i in range(0, len(g), 8):
                out.append((Lp, g[i:i + 8]))
        return out

    def _prefill_group(self, Lp: int, recs) -> dict[int, list]:
        """One lane-batched prefill forward for same-bucket chunks of
        different requests: one model call (one fused-kernel launch per
        layer) for the whole group, one host sync for its sampled tokens."""
        rids = [rid for rid, _, _ in recs]
        slots = [self.kv.seq_of[r] for r in rids]
        B = _bucket(len(recs), (1, 2, 4, 8))
        pad = B - len(recs)
        slots_p = slots + [slots[0]] * pad
        toks = np.zeros((B, Lp), np.int64)
        true_len = np.zeros((B,), np.int32)
        pos0 = np.zeros((B,), np.int32)
        sample_rows = []
        for i, (rid, chunk, pos) in enumerate(recs):
            toks[i, :len(chunk)] = chunk
            true_len[i] = len(chunk)
            pos0[i] = pos
            ctx = self.reqs[rid]
            # a sample that will be discarded draws no random numbers:
            # temperature > 0 output must not depend on the prefill split
            if not (ctx.pending or ctx.recompute):
                sample_rows.append(i)
        dev = self.device
        cache = self.kv.lane_cache(slots_p)
        fused0 = _attn.OP_STATS["fused_prefill"]
        tok = self._prefill_forward(
            cache, torch.from_numpy(toks).to(dev),
            torch.from_numpy(pos0).to(dev),
            torch.from_numpy(true_len).to(dev), self.kv.table_rows(slots_p),
            sample_rows, self._gather_enc(rids, B))
        self.counters["prefill_fused_ops"] += (
            _attn.OP_STATS["fused_prefill"] - fused0)
        self.kv.absorb(slots, cache)
        self.counters["prefill_calls"] += 1
        tok_h = tok.cpu().numpy()                  # one host sync per group
        out: dict[int, list] = {}
        for i, (rid, chunk, _) in enumerate(recs):
            ctx = self.reqs[rid]
            self.kv.seq_len[slots[i]] += len(chunk)
            replayed = min(len(chunk), ctx.replay)
            ctx.replay -= replayed
            self.last_prefill_progress[rid] = len(chunk) - replayed
            ctx.history.extend(chunk)
            # publish completed prompt pages; decode pages stay private
            self.kv.register_prefix(rid, ctx.history)
            if not ctx.pending:
                if ctx.recompute:
                    # recompute after preemption: the cache is restored
                    # exactly and this re-sampled emission is discarded
                    ctx.recompute = False
                else:
                    t = int(tok_h[i])
                    ctx.generated.append(t)
                    out[rid] = [t]
        return out

    # ------------------------------------------------------------------ #
    def _decode_batched(self, steps_of, on_pressure=None) -> dict[int, list]:
        """steps_of: {rid: n_steps} or list of rids (1 step each).  One
        device loop for the whole group, one host sync."""
        if not isinstance(steps_of, dict):
            steps_of = {r: 1 for r in steps_of}
        out = {r: [] for r in steps_of}
        live = [r for r in steps_of
                if r in self.reqs and not self.reqs[r].done
                and steps_of[r] > 0]
        if not live:
            return out
        if on_pressure is not None:
            # report the decode shortfall so the frontend can preempt
            # best-effort victims before the capping below trims budgets
            need = 0
            for r in live:
                want = min(self.kv.length(r) + steps_of[r],
                           self.ecfg.max_len)
                need += max(0, self.kv.pages_needed(want)
                            - len(self.kv.tables.get(r, [])))
            short = need - self.kv.free_pages
            if short > 0:
                on_pressure(short)
        # cap each lane's budget to the pages/context available
        # (sequential: earlier lanes claim free pages first)
        capped = {}
        for r in live:
            cur = self.kv.length(r)
            n = min(steps_of[r], self.kv.token_capacity(r) - cur)
            if n > 0:
                self.kv.extend(r, cur + n)
                self._cow_barrier(r, cur, n, on_pressure)
                capped[r] = n
        steps_of = capped
        live = [r for r in live if r in capped]
        if not live:
            return out
        n_steps = _bucket(max(steps_of[r] for r in live),
                          (1, 2, 4, 8, 16, 32, 64, 128, 256))
        B = _bucket(len(live), (1, 2, 4, 8, 16, 32, 64, 128))
        pad = B - len(live)
        slots = [self.kv.seq_of[r] for r in live]
        slots_p = slots + [slots[0]] * pad
        starts = [self._last_token(r) for r in live]
        eos = [self.reqs[r].eos if self.reqs[r].eos is not None else -1
               for r in live]

        def dev(vals):
            return torch.tensor(vals, dtype=torch.int32, device=self.device)
        cache = self.kv.lane_cache(slots_p)
        emitted = self._decode_loop(
            cache, dev(starts + [0] * pad), dev(self.kv.seq_len[slots_p].tolist()),
            dev([steps_of[r] for r in live] + [0] * pad),
            dev(eos + [-1] * pad), self.kv.table_rows(slots_p), n_steps,
            self._gather_enc(live, B))
        self.kv.absorb(slots, cache)
        self.counters["decode_calls"] += 1
        self.counters["decode_steps"] += n_steps
        em = emitted.cpu().numpy()                 # ONE host sync per group
        for i, r in enumerate(live):
            ctx = self.reqs[r]
            toks = [int(t) for t in em[i, :steps_of[r]] if t >= 0]
            ctx.generated.extend(toks)
            # tokens written to KV this call: the start input + all but
            # the last emission (whose KV lands on the next call)
            ctx.history.extend(([starts[i]] + toks)[:len(toks)])
            out[r].extend(toks)
            self.kv.seq_len[slots[i]] += len(toks)
            self.counters["decode_tokens"] += len(toks)
            if ctx.eos is not None and toks and toks[-1] == ctx.eos:
                ctx.done = True
        return out

    def _gather_enc(self, rids, B):
        """The lanes' encoder states stacked to (B, T, D), zeros for lanes
        without and for the B - len(rids) padded lanes; None when no lane
        has any."""
        encs = [self.reqs[r].enc_states for r in rids]
        if all(e is None for e in encs):
            return None
        ref = next(e for e in encs if e is not None)
        stack = [e if e is not None else torch.zeros_like(ref) for e in encs]
        stack += [torch.zeros_like(ref)] * (B - len(stack))
        return torch.cat(stack, dim=0)

    def _last_token(self, rid: int) -> int:
        ctx = self.reqs[rid]
        if ctx.generated:
            return ctx.generated[-1]
        return ctx.prompt[-1] if ctx.prompt else 0
