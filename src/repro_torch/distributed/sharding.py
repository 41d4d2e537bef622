"""Mesh-sharded serving (port of the serving section of
``repro/distributed/sharding.py``; its training section is not ported
yet).

The reference's rule is kept: shards combine only by CONCATENATION (an
all-gather of per-head context or of the dense FFN's hidden columns) or by
a sum in which exactly one shard contributes each value (MoE), never by
partial sums of activations through an output projection.  So no float
addition changes order for any token's logits, and a sharded engine
serves the greedy streams of the unsharded one.  Hence:

* ``wq`` / ``wk`` / ``wv`` (and their biases) split on the head axis;
  ``wo`` is replicated and applied after an all-gather of the context;
* MoE experts split on the expert axis, routing is replicated; each
  shard runs its own experts' units and the unit outputs are summed
  over shards (``models/moe.py``);
* MLA's latent pools are headless: every shard writes identical pages,
  so they replicate while the query and latent up-projections split on
  the head axis;
* SSM compute replicates, but the at-rest ``conv`` / ``state`` lane rows
  split on the slot axis;
* embeddings, unembedding and norms replicate, so every shard computes
  the same logits and samples the same tokens.

``ServingShardPlan`` and ``serving_shard_plan`` are the reference's.  A
spec here is the index of the sharded axis of a leaf, or None for a
replicated leaf: ``serving_param_specs`` and ``serving_cache_specs`` give
the reference's ``PartitionSpec`` trees in that form, over the port's
dict trees (whose key paths are the reference's, ``bridge.py``), and
``shard_tree`` cuts a tree into per-shard trees on the shards' devices
(the reference's ``jax.device_put`` onto ``NamedSharding``s).

Where JAX runs one SPMD program under ``shard_map``, the port keeps one
controller: the engine's host work (admission, the allocator, block
tables, batch preparation) runs once, and each device program runs once
per shard on a persistent worker thread of that shard
(``ShardWorkers``), with a ``ShardCtx`` passed down as ``shard=``: the
plan, the shard's index and the collectives (``ShardComm``, a
``threading.Barrier`` underneath).  ``torch.distributed`` processes would
need one planner each, and the planner breaks decode ties by ``id()``,
so separate planners would pick different batches; NCCL also refuses two
ranks on one card.  The devices of a mesh may repeat (two shards on one
card)."""
from __future__ import annotations

import dataclasses
import queue
import re
import threading
import weakref
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

MLA_KINDS = ("mla", "mla_moe")

# seconds a shard waits in a collective for the others before it raises
BARRIER_TIMEOUT = 600.0


@dataclasses.dataclass(frozen=True)
class ServingShardPlan:
    """What actually shards for one model config on one serving mesh axis.

    Each flag is a divisibility-gated capability; the SAME plan object
    drives the specs (at-rest placement) and the in-model gather / sum
    decisions, so the two can never disagree."""
    axis: str                  # mesh axis name ("model" by default)
    size: int                  # number of shards along that axis
    heads: bool                # GQA q/kv heads shard (H % n == KVH % n == 0)
    mla_heads: bool            # MLA q heads shard (latent pools replicate)
    experts: bool              # MoE experts shard (E % n == 0)
    mlp: bool                  # dense-FFN hidden dim shards (d_ff % n == 0)
    ssm_lanes: bool            # SSM state lane-shards at rest

    @property
    def any(self) -> bool:
        return self.heads or self.mla_heads or self.experts or self.mlp


def serving_shard_plan(cfg: ModelConfig, mesh, axis: str = "model",
                       max_seqs: int = 0) -> ServingShardPlan:
    n = int(mesh.shape[axis])
    kinds = {k for k, _ in cfg.segments()}
    has_attn = bool(kinds - {"ssm"} - set(MLA_KINDS) - {"cross_attn"})
    has_mla = bool(kinds & set(MLA_KINDS))
    heads = (n > 1 and has_attn
             and cfg.n_heads % n == 0 and cfg.n_kv_heads % n == 0)
    mla_heads = n > 1 and has_mla and cfg.n_heads % n == 0
    experts = (n > 1 and cfg.moe is not None
               and cfg.moe.n_experts % n == 0)
    mlp = n > 1 and cfg.d_ff > 0 and cfg.d_ff % n == 0
    ssm_lanes = (n > 1 and cfg.ssm is not None and "ssm" in kinds
                 and max_seqs > 0 and max_seqs % n == 0)
    return ServingShardPlan(axis=axis, size=n, heads=heads,
                            mla_heads=mla_heads, experts=experts,
                            mlp=mlp, ssm_lanes=ssm_lanes)


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """A 1-D serving mesh: shard i runs on ``devices[i]`` (devices may
    repeat).  ``shape`` is ``{axis: len(devices)}``, as a JAX mesh's."""
    devices: tuple
    axis: str = "model"

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_serving_mesh(devices=None, axis: str = "model") -> ServingMesh:
    """A 1-D serving mesh over ``devices`` (default: every visible CUDA
    device; raises without a card, as ``resolve_device`` does).  Each
    device goes through ``resolve_device``: ``["cpu"] * n`` is an n-shard
    mesh on the CPU, ``[cuda:0] * n`` n shards sharing one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_serving_mesh: no CUDA device (torch.cuda.is_available() "
                "is False); pass devices=['cpu'] * n to shard on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("make_serving_mesh: no devices")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"make_serving_mesh: one device type, got {devs}")
    return ServingMesh(devs, axis)


# ------------------------------- specs ---------------------------------- #
def _map_paths(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists, with the
    reference's "/"-joined key paths ("segments/0/p/attn/wq")."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, sub(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _axis(spec: tuple, ax: str) -> Optional[int]:
    """The port's spec of a reference ``PartitionSpec(*spec)``: the index
    of the mesh axis in it, None when it names none (replicated)."""
    return spec.index(ax) if ax in spec else None


def serving_param_specs(params, cfg: ModelConfig, plan: ServingShardPlan):
    """The sharded axis of every parameter (None: replicated), the
    reference's rules."""
    segs = cfg.segments()
    ax = plan.axis

    def spec_for(kind: str, path: str) -> tuple:
        if kind == "cross_attn":
            return ()                        # whisper/VLM blocks replicate
        mla = kind in MLA_KINDS
        gate = plan.mla_heads if mla else plan.heads
        tail = path.rsplit("/", 1)[-1]
        if gate and re.search(r"attn/(wq|wk|wv|w_uq|w_uk|w_uv)$", path):
            # (d|r|q_lora, heads, head_dim): column-shard the head axis
            return (None, ax, None)
        if gate and not mla and re.search(r"attn/(bq|bk|bv)$", path):
            return (ax, None)
        if plan.experts and re.search(r"moe/(w_gate|w_up|w_down)$", path):
            return (ax, None, None)          # (E, ...) expert-parallel
        if plan.mlp and re.search(r"mlp/(w_gate|w_up)$", path):
            return (None, ax)
        if plan.mlp and tail == "b_up" and "mlp/" in path:
            return (ax,)
        return ()                            # wo/router/shared/ssm/norms/...

    def one(path, leaf):
        kind, stacked = "attn", False
        m = re.match(r"segments/(\d+)/", path)
        if m:
            kind, count = segs[int(m.group(1))]
            stacked = count > 1
        elif path.startswith("shared_attn/"):
            kind = "shared_attn"
        elif path.startswith("encoder/"):
            return None
        elif "/" not in path or path.startswith(("embed", "unembed",
                                                 "pos_embed", "final")):
            return None
        sp = spec_for(kind, path)
        if stacked and sp:
            sp = (None,) + sp
        return _axis(sp, ax)

    return _map_paths(one, params)


def serving_cache_specs(pools, cfg: ModelConfig, plan: ServingShardPlan,
                        lane_view: bool = False):
    """The sharded axis of every page pool and lane-row leaf.

    ``lane_view=False`` describes the at-rest pools of ``PagedKVManager``
    (SSM conv/state lane-shard on the slot axis); ``lane_view=True`` the
    cache a model call reads, whose SSM leaves are the call's lanes'
    rows, computed replicated (None)."""
    segs = cfg.segments()
    ax = plan.axis

    def one(path, leaf):
        m = re.match(r"(\d+)/", path)
        stacked = bool(m) and segs[int(m.group(1))][1] > 1
        pre = (None,) if stacked else ()
        if path.endswith("k_pages") or path.endswith("v_pages"):
            if plan.heads:                   # (P, page, KVH, hd)
                return _axis(pre + (None, None, ax, None), ax)
            return None
        if path.endswith("ckv_pages") or path.endswith("krope_pages"):
            return None                      # latent pools replicate
        if path.endswith("conv") or path.endswith("state"):
            if plan.ssm_lanes and not lane_view:
                return _axis(pre + (ax,), ax)   # slot axis lane-shards
            return None
        return None

    return _map_paths(one, pools)


def shard_tree(tree, specs, mesh: ServingMesh, *, copy: bool = False,
               consume: bool = False) -> list:
    """Per-shard trees of ``tree``: a leaf whose spec is an axis is cut
    into ``mesh.size`` equal slices along it, shard i taking slice i onto
    ``mesh.devices[i]``; a leaf whose spec is None goes whole to every
    shard.  ``copy``: every shard gets memory of its own for every leaf
    (the page pools, which each shard writes); otherwise a leaf or a
    contiguous slice already on the shard's device is shared, not copied
    (read-only weights).  ``consume``: each leaf is removed from
    ``tree``'s dicts once cut, so that at most one whole leaf lives beside
    the shards."""
    n = mesh.size

    def split(t, ax):
        if ax is not None and t.shape[ax] % n:
            raise ValueError(f"shard_tree: axis {ax} of {tuple(t.shape)} "
                             f"does not split over {n} shards")
        out = []
        for i, dev in enumerate(mesh.devices):
            x = t
            if ax is not None:
                w = t.shape[ax] // n
                x = t.narrow(ax, i * w, w)
            if copy or not x.is_contiguous():
                x = x.to(dev, copy=True, memory_format=torch.contiguous_format)
            else:
                x = x.to(dev)
            out.append(x)
        return out

    def walk(t, sp):
        if isinstance(t, dict):
            parts = {}
            for k in list(t):
                parts[k] = walk(t[k], sp[k])
                if consume:
                    del t[k]
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        if isinstance(t, (list, tuple)):
            parts = [walk(v, s) for v, s in zip(t, sp)]
            return [type(t)(p[i] for p in parts) for i in range(n)]
        return split(t, sp)

    return walk(tree, specs)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedParams:
    """A parameter tree cut for one mesh and plan: ``trees[i]`` is shard
    i's, on ``mesh.devices[i]``; ``source`` the unsharded tree.  Several
    engines over one mesh (a cluster's replicas) share one."""
    source: object
    trees: tuple
    mesh: ServingMesh
    plan: ServingShardPlan


def shard_params(params, cfg: ModelConfig, mesh: ServingMesh,
                 plan: ServingShardPlan) -> ShardedParams:
    """``params`` (on any device: the CPU for a model one card cannot
    hold) cut per ``serving_param_specs`` onto the mesh's devices."""
    specs = serving_param_specs(params, cfg, plan)
    return ShardedParams(params, tuple(shard_tree(params, specs, mesh)),
                         mesh, plan)


# ---------------------------- shard workers ----------------------------- #
class ShardComm:
    """The collectives of one mesh's shards, each shard on a thread of its
    own.  A collective deposits the caller's tensor in its slot, waits at
    a ``threading.Barrier`` for every shard, and reads all slots.  Two
    sets of slots are used in turn: a shard writes collective k + 2's
    slot only after every shard passed collective k + 1, so after every
    shard has read collective k's.  A shard that fails aborts the
    barrier, and every shard waiting in a collective raises
    ``BrokenBarrierError`` at once."""

    def __init__(self, n: int, timeout: Optional[float] = BARRIER_TIMEOUT):
        self.n = n
        self._barrier = threading.Barrier(n, timeout=timeout)
        self._slots = ([None] * n, [None] * n)
        self._turn = [0] * n

    def exchange(self, i: int, t) -> list:
        """Every shard's ``t`` of this collective, in shard order."""
        slots = self._slots[self._turn[i] & 1]
        self._turn[i] += 1
        slots[i] = t
        self._barrier.wait()
        return list(slots)

    def all_gather(self, i: int, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every shard's ``t`` concatenated on ``dim`` in shard order, on
        the caller's device."""
        return torch.cat([x.to(t.device) for x in self.exchange(i, t)],
                         dim=dim)

    def psum(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's ``t``, added in shard order on the
        caller's device.  Exact when each value has one contributor and
        the other shards hold zeros there (x + 0 == x)."""
        parts = self.exchange(i, t)
        out = parts[0].to(t.device)
        for x in parts[1:]:
            out = out + x.to(t.device)
        return out

    def abort(self) -> None:
        self._barrier.abort()

    def reset(self) -> None:
        """Make the barrier usable again after an abort (no shard may be
        waiting in it)."""
        self._barrier.reset()
        self._turn = [0] * self.n
        self._slots = ([None] * self.n, [None] * self.n)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """What a model call of shard ``index`` is given as ``shard=``: the
    plan's flags (read as ``shard.heads`` etc., as the reference reads
    its plan) and the collectives."""
    plan: ServingShardPlan
    index: int
    comm: ShardComm

    def __getattr__(self, name):
        # heads, mla_heads, experts, mlp, ssm_lanes, size, axis
        return getattr(self.plan, name)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return self.comm.all_gather(self.index, t, dim)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.psum(self.index, t)


def _serve(tasks: queue.Queue, done: queue.Queue, dev: torch.device,
           ctx: ShardCtx) -> None:
    """A shard's worker loop: run each task with the shard's device
    current and the caller's grad mode; a failure aborts the barrier."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    while True:
        task = tasks.get()
        if task is None:
            return
        fn, grad = task
        try:
            with torch.set_grad_enabled(grad):
                out = fn(ctx.index, ctx)
        except BaseException as e:       # noqa: BLE001 - handed to run()
            ctx.comm.abort()
            done.put((ctx.index, False, e))
        else:
            done.put((ctx.index, True, out))
        # hold nothing of the task while waiting for the next: its closure
        # keeps the engine, and so this pool, alive
        task = fn = out = None


def _stop(tasks, threads) -> None:
    """Stop a pool's threads and wait for them (a thread still inside
    torch when the interpreter exits aborts the process)."""
    for q in tasks:
        q.put(None)
    for t in threads:
        if t is not threading.current_thread():
            t.join(timeout=10.0)


class ShardWorkers:
    """One persistent worker thread per shard of a mesh.  ``run(fn)``
    calls ``fn(i, ctx)`` on shard i's thread for every shard at once and
    returns the results in shard order.  A shard that raises aborts the
    barrier, so the others leave their collectives instead of hanging,
    and ``run`` raises the first shard's own error (never a
    ``BrokenBarrierError`` that error caused), noted with its shard.
    The threads stop when the pool is collected."""

    def __init__(self, mesh: ServingMesh, plan: ServingShardPlan,
                 timeout: Optional[float] = BARRIER_TIMEOUT):
        self.mesh = mesh
        self.timeout = timeout
        self.comm = ShardComm(mesh.size, timeout)
        self._done: queue.Queue = queue.Queue()
        self._tasks = [queue.Queue() for _ in mesh.devices]
        self._lock = threading.Lock()
        self._broken = None
        threads = [threading.Thread(
            target=_serve, name=f"mesh-shard-{i}", daemon=True,
            args=(self._tasks[i], self._done, dev,
                  ShardCtx(plan, i, self.comm)))
            for i, dev in enumerate(mesh.devices)]
        for t in threads:
            t.start()
        weakref.finalize(self, _stop, self._tasks, threads)

    def run(self, fn) -> list:
        with self._lock:
            if self._broken is not None:
                raise RuntimeError("mesh workers unusable: " + self._broken)
            grad = torch.is_grad_enabled()
            for q in self._tasks:
                q.put((fn, grad))
            n = len(self._tasks)
            results: list = [None] * n
            errors: dict = {}
            # a shard that hangs outside a collective never reports: give
            # up after twice the barrier's timeout
            wait = None if self.timeout is None else 2 * self.timeout
            for _ in range(n):
                try:
                    i, ok, value = self._done.get(timeout=wait)
                except queue.Empty:
                    self._broken = "a shard did not finish"
                    raise TimeoutError(
                        f"mesh shard did not finish within {wait} s") from None
                if ok:
                    results[i] = value
                else:
                    errors[i] = value
            if errors:
                self.comm.reset()
                own = [(i, e) for i, e in sorted(errors.items())
                       if not isinstance(e, threading.BrokenBarrierError)]
                i, err = (own or sorted(errors.items()))[0]
                err.add_note(f"raised on mesh shard {i} of {n}")
                raise err
            return results
