"""Sharding over a mesh of devices (port of
``repro/distributed/sharding.py``): its training section (the specs of
parameters, batches and dense caches over a data x model mesh) and its
serving section (one engine's heads, experts, FFN columns and SSM lane
rows over a 1-D serving mesh), with the placement and the collectives
both use.

**Training section.**  ``_RULES``, ``param_spec`` (modes ``fsdp`` and
``tp``), ``_fit``, ``params_shardings``, ``batch_spec`` and
``cache_shardings`` are the reference's, over the port's dict trees
(whose key paths are the reference's, ``bridge.py``).  A spec is the
reference's ``PartitionSpec`` as a tuple, one entry per dimension: an
axis name, a tuple of names (their shards in the order given, the first
major), or None; ``()`` is a replicated leaf.  ``Mesh`` is an n-D named
mesh (``make_mesh``); with no devices it is abstract, for specs and the
dry run (``launch/dryrun.py``), as a JAX ``AbstractMesh``.

A leaf rests as its spec cuts it (``shard_tree``), but a shard computes
with the serving plan's layout (``compute_param_specs``): the model axis
splits only what the plan splits (``heads``, ``mla_heads``, ``mlp``,
``experts``), every other leaf is whole, and nothing is split over the
data axes.  ``MeshShard.relayout`` moves a leaf between the two layouts:
an all-gather for each axis the target does not split on a dimension, a
slice for each axis it splits that the source did not.  So a shard
gathers its parameters at use (FSDP) and takes its slice of each
gradient back.

**Serving section.**  The reference's rule is kept: shards combine only
by CONCATENATION (an all-gather of per-head context or of the dense
FFN's hidden columns) or by a sum in which exactly one shard contributes
each value (MoE), never by partial sums of activations through an
output projection.  So no float addition changes order for any token's
logits, and a sharded engine serves the greedy streams of the unsharded
one.  Hence:

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
serving spec is the index of the sharded axis of a leaf, or None for a
replicated leaf: ``serving_param_specs`` and ``serving_cache_specs`` give
the reference's ``PartitionSpec`` trees in that form, and ``shard_tree``
cuts a tree into per-shard trees on the shards' devices (the reference's
``jax.device_put`` onto ``NamedSharding``s), in either spec form.

**Shards and collectives.**  Where JAX runs one SPMD program, the port
keeps one controller: each device program runs once per shard on a
persistent worker thread of that shard (``ShardWorkers``).  A serving
shard gets a ``ShardCtx`` as ``shard=``: the plan, the shard's index and
the collectives (``ShardComm``, a ``threading.Barrier`` underneath).  A
training shard gets a ``MeshShard``: its coordinates and one
``ShardComm`` per group of every set of axes (``MeshComms``: the model
group of each data index, the data group of each model index, ...); its
``model_ctx`` is the ``ShardCtx`` the model reads.  ``torch.distributed``
processes would need one planner each, and the planner breaks decode
ties by ``id()``, so separate planners would pick different batches;
NCCL also refuses two ranks on one card.  The devices of a mesh may
repeat (two shards on one card).  Every ``ShardComm`` counts, per member,
the collectives it ran and their result bytes (the reference's
convention for a collective's bytes).

Under autograd the collectives are Megatron's operators
(``torch.autograd.Function``s), so that no shard's graph reaches another
shard's tensors: ``enter`` (the identity forward; a sum over the model
group of the gradient backward) at the input of each split block,
``all_gather`` (the concatenation forward; the shard's own slice of the
gradient backward) where it combines, ``psum`` of MoE slots (a sum
forward; the identity backward: each slot has one contributor) and
``data_mean`` (the mean over the data group forward; the identity
backward, since every data shard's loss carries the same mean and the
step averages the gradients over the data group).  A shard runs its
backward pass on its own thread
(``torch.autograd.set_multithreading_enabled(False)``): the autograd
engine would otherwise run every CUDA backward of one card on one
engine thread, where the first shard to wait in a collective would
block the others' backward for good."""
from __future__ import annotations

import dataclasses
import itertools
import math
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


# =============================== meshes ================================= #
@dataclasses.dataclass(frozen=True)
class Mesh:
    """An n-D named mesh: ``axis_names`` and ``sizes`` (a JAX mesh's
    ``shape`` is ``dict(zip(axis_names, sizes))``) and the device of every
    shard in row-major order (the last axis fastest); devices may repeat.
    ``devices`` None: an abstract mesh, for specs and the dry run."""
    axis_names: tuple
    sizes: tuple
    devices: Optional[tuple] = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, i: int) -> dict:
        """Shard i's index along every axis."""
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.sizes)):
            out[name] = i % n
            i //= n
        return {a: out[a] for a in self.axis_names}

    def part(self, i: int, entry) -> tuple[int, int]:
        """(which part, how many parts) shard i holds of a dimension whose
        spec entry is ``entry`` (an axis name or a tuple of names, the
        first major)."""
        c = self.coords(i)
        idx, n = 0, 1
        for a in _names(entry):
            idx, n = idx * self.shape[a] + c[a], n * self.shape[a]
        return idx, n


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def make_mesh(shape, axis_names, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (row-major, each through
    ``resolve_device``; ``["cpu"] * 4`` is a 4-shard mesh on the CPU,
    ``[cuda:0] * 4`` four shards sharing one card), or an abstract one
    without devices."""
    shape, names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"make_mesh: shape {shape} and axes {names}")
    if devices is None:
        return Mesh(names, shape)
    devs = tuple(resolve_device(d) for d in devices)
    if len(devs) != math.prod(shape):
        raise ValueError(f"make_mesh: {len(devs)} devices for {shape}")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"make_mesh: one device type, got {devs}")
    return Mesh(names, shape, devs)


# ======================= training: specs over a mesh ===================== #
def _data_axes(mesh):
    return (("pod", "data") if "pod" in mesh.axis_names else "data")


def data_group(mesh) -> Optional[tuple]:
    """The mesh's data axes (``_data_axes``) that it has, as an entry;
    None when they hold one shard (no data parallelism)."""
    d = tuple(a for a in _names(_data_axes(mesh)) if a in mesh.axis_names)
    return d if d and _axis_size(mesh, d) > 1 else None


# (regex over path, spec builder(data_ax) -> tuple of axis names/None)
# Paths look like: segments/0/p/attn/wq, shared_attn/moe/w_gate, embed/embed
_RULES = [
    # embeddings / unembedding: vocab on model, d_model on data
    (r"embed/embed$",            lambda d: ("model", d)),
    (r"pos_embed$",              lambda d: (None, d)),
    (r"unembed$",                lambda d: (d, "model")),
    # attention: stacked segments have a leading layer axis handled later
    (r"attn/wq$",                lambda d: (d, "model", None)),
    (r"attn/wk$",                lambda d: (d, "model", None)),
    (r"attn/wv$",                lambda d: (d, "model", None)),
    (r"attn/wo$",                lambda d: ("model", None, d)),
    (r"cross/wq$",               lambda d: (d, "model", None)),
    (r"cross/wk$",               lambda d: (d, "model", None)),
    (r"cross/wv$",               lambda d: (d, "model", None)),
    (r"cross/wo$",               lambda d: ("model", None, d)),
    # MLA
    (r"attn/w_dkv$",             lambda d: (d, None)),
    (r"attn/w_krope$",           lambda d: (d, None)),
    (r"attn/w_uk$",              lambda d: (None, "model", None)),
    (r"attn/w_uv$",              lambda d: (None, "model", None)),
    (r"attn/w_dq$",              lambda d: (d, None)),
    (r"attn/w_uq$",              lambda d: (None, "model", None)),
    # dense FFN
    (r"mlp/w_gate$",             lambda d: (d, "model")),
    (r"mlp/w_up$",               lambda d: (d, "model")),
    (r"mlp/w_down$",             lambda d: ("model", d)),
    (r"mlp/b_up$",               lambda d: ("model",)),
    # MoE: expert parallel on model, d_model on data
    (r"moe/router$",             lambda d: (d, None)),
    (r"moe/w_gate$",             lambda d: ("model", d, None)),
    (r"moe/w_up$",               lambda d: ("model", d, None)),
    (r"moe/w_down$",             lambda d: ("model", None, d)),
    (r"moe/shared_gate$",        lambda d: (d, "model")),
    (r"moe/shared_up$",          lambda d: (d, "model")),
    (r"moe/shared_down$",        lambda d: ("model", d)),
    # SSM: inner channels on model
    (r"ssm/w_in$",               lambda d: (d, "model")),
    (r"ssm/conv_w$",             lambda d: (None, "model")),
    (r"ssm/conv_b$",             lambda d: ("model",)),
    (r"ssm/w_out$",              lambda d: ("model", d)),
    (r"ssm/norm_scale$",         lambda d: ("model",)),
    # encoder (whisper)
    (r"encoder/pos$",            lambda d: (None, None)),
]


def param_spec(path: str, shape: tuple, mesh, stacked: bool,
               mode: str = "fsdp") -> tuple:
    """mode="fsdp" (default): weights sharded over "data" on one dim
    (often the contracting one) + tensor parallel over "model".
    mode="tp": weights replicated over "data".  Axes that do not divide
    their dimension evenly are dropped (``_fit``); ``()`` replicates."""
    d = _data_axes(mesh)
    for pat, builder in _RULES:
        if re.search(pat, path):
            spec = tuple(builder(d))
            if mode == "tp":
                spec = tuple(None if ax == d else ax for ax in spec)
            if stacked:
                spec = (None,) + spec
            spec = spec[:len(shape)]
            return tuple(_fit(ax, dim, mesh) for ax, dim in zip(spec, shape))
    return ()                                    # replicate (norms, scalars)


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        return math.prod(mesh.shape[a] for a in ax)
    return mesh.shape[ax]


def _fit(ax, dim: int, mesh):
    if ax is None:
        return None
    if dim % _axis_size(mesh, ax) == 0:
        return ax
    if isinstance(ax, tuple):                    # try a shorter axis product
        for sub in (ax[1:], ax[:1]):
            if sub and dim % _axis_size(mesh, sub) == 0:
                return sub if len(sub) > 1 else sub[0]
    return None


def params_shardings(params, cfg: ModelConfig, mesh, mode: str = "fsdp"):
    """The spec of every leaf of a parameter tree (real or meta)."""
    segs = cfg.segments()

    def one(path, leaf):
        stacked = False
        m = re.match(r"segments/(\d+)/", path)
        if m:
            stacked = segs[int(m.group(1))][1] > 1
        if path.startswith("encoder/layers/"):
            stacked = True
        return param_spec(path, tuple(leaf.shape), mesh, stacked, mode)

    return _map_paths(one, params)


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> tuple:
    """Shard the batch dim over (pod, data) when divisible, else fewer."""
    return (_fit(_data_axes(mesh), batch, mesh),) + (None,) * extra_dims


def cache_shardings(cache, cfg: ModelConfig, mesh, batch: int,
                    seq_shard: bool = False):
    """Dense caches (``transformer.init_cache``): batch on data (x pod);
    kv-heads on model where divisible.  seq_shard=True (long-context,
    batch=1): the sequence dim on data instead."""
    d = _data_axes(mesh)
    segs = cfg.segments()

    def one(path, leaf):
        m = re.match(r"(\d+)/", path)
        stacked = bool(m) and segs[int(m.group(1))][1] > 1
        pre = (None,) if stacked else ()
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        b_ax = _fit(d, shape[0], mesh) if not seq_shard else None
        if path.endswith("/k") or path.endswith("/v"):
            seq_ax = _fit(d, shape[1], mesh) if seq_shard else None
            kv_ax = _fit("model", shape[2], mesh)
            spec = pre + (b_ax, seq_ax, kv_ax, None)
        elif path.endswith("ckv") or path.endswith("krope"):
            seq_ax = _fit(d, shape[1], mesh) if seq_shard else None
            spec = pre + (b_ax, seq_ax, None)
        elif path.endswith("state"):                  # (B, H, P, N)
            h_ax = _fit("model", shape[1], mesh)
            spec = pre + (b_ax, h_ax, None, None)
        elif path.endswith("conv"):                   # (B, K-1, C)
            c_ax = _fit("model", shape[2], mesh)
            spec = pre + (b_ax, None, c_ax)
        else:
            spec = pre + (b_ax,) + (None,) * (len(shape) - 1)
        return spec[:leaf.dim()]

    return _map_paths(one, cache)


# ========================= serving (1-D mesh) =========================== #


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

    def part(self, i: int, entry) -> tuple[int, int]:
        return i, len(self.devices)


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


# ------------------------------ placement ------------------------------- #
def _entries(spec, ndim: int, mesh=None) -> tuple:
    """A leaf's spec as one entry per dimension: a tuple spec padded with
    None, or a serving spec (the index of ``mesh.axis``, or None)."""
    if spec is None:
        return (None,) * ndim
    if isinstance(spec, int):
        return tuple(mesh.axis if d == spec else None for d in range(ndim))
    return tuple(spec) + (None,) * (ndim - len(spec))


def local_slice(t: torch.Tensor, spec, mesh, i: int) -> torch.Tensor:
    """Shard i's slice of ``t`` (a view): along each dimension whose spec
    entry names axes, its part of the equal parts those axes cut."""
    for dim, e in enumerate(_entries(spec, t.dim(), mesh)):
        if e is None:
            continue
        idx, n = mesh.part(i, e)
        if t.shape[dim] % n:
            raise ValueError(f"shard_tree: axis {dim} of {tuple(t.shape)} "
                             f"does not split over {n} shards")
        w = t.shape[dim] // n
        t = t.narrow(dim, idx * w, w)
    return t


def _walk(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists),
    the first a tree of tensors (a spec tree's leaves are tuples)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _walk(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_walk(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def shard_tree(tree, specs, mesh, *, copy: bool = False,
               consume: bool = False) -> list:
    """Per-shard trees of ``tree``: shard i takes each leaf's
    ``local_slice`` onto ``mesh.devices[i]``.  ``specs`` are serving specs
    over a ``ServingMesh`` (a leaf cut into ``mesh.size`` slices along the
    named axis, or whole to every shard) or tuple specs over a ``Mesh``.
    ``copy``: every shard gets memory of its own for every leaf (page
    pools and training state, which each shard writes); otherwise a leaf
    or a contiguous slice already on the shard's device is shared, not
    copied (read-only weights).  ``consume``: each leaf is removed from
    ``tree``'s dicts once cut, so that at most one whole leaf lives beside
    the shards."""
    n = mesh.size

    def split(t, sp):
        out = []
        for i, dev in enumerate(mesh.devices):
            x = local_slice(t, sp, mesh, i)
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


def unshard_tree(parts: list, specs, mesh, device=None):
    """The whole tree back from every shard's tree (``shard_tree``'s
    inverse), on ``device`` (default: shard 0's).  A replicated part is
    read from the last shard that holds it."""
    def leaf(*ts_sp):
        ts, sp = ts_sp[:-1], ts_sp[-1]
        ent = _entries(sp, ts[0].dim(), mesh)
        shape = [s * (mesh.part(0, e)[1] if e is not None else 1)
                 for s, e in zip(ts[0].shape, ent)]
        out = torch.empty(shape, dtype=ts[0].dtype,
                          device=device or ts[0].device)
        for i, t in enumerate(ts):
            view = out
            for dim, e in enumerate(ent):
                if e is not None:
                    w = t.shape[dim]
                    view = view.narrow(dim, mesh.part(i, e)[0] * w, w)
            view.copy_(t)
        return out
    return _walk(leaf, *parts, specs)


def replicas_equal(parts: list, specs, mesh) -> bool:
    """Do the shards that hold the same part of a leaf (``parts``: every
    shard's tree) hold it bit for bit?"""
    ok = []

    def leaf(*ts_sp):
        ts, sp = ts_sp[:-1], ts_sp[-1]
        ent = _entries(sp, ts[0].dim(), mesh)
        seen = {}
        for i, t in enumerate(ts):
            key = tuple(None if e is None else mesh.part(i, e) for e in ent)
            if key in seen:
                ok.append(torch.equal(t, seen[key]))
            seen[key] = t
    _walk(leaf, *parts, specs)
    return all(ok)


def shard_nbytes(tree, specs, mesh, i: int = 0) -> int:
    """The bytes shard i holds of ``tree`` as ``specs`` cut it."""
    sizes = []

    def one(t, sp):
        n = t.numel()
        for e in _entries(sp, t.dim(), mesh):
            if e is not None:
                n //= mesh.part(i, e)[1]
        sizes.append(n * t.element_size())
    _walk(one, tree, specs)
    return sum(sizes)


def _tuple_spec(ax: Optional[int], ndim: int, name: str) -> tuple:
    return () if ax is None else tuple(
        name if d == ax else None for d in range(ndim))


def compute_param_specs(params, cfg: ModelConfig, plan: ServingShardPlan):
    """The layout a training shard computes with: the serving plan's
    split on its axis (``serving_param_specs``) as tuple specs; every
    other leaf whole."""
    axes = serving_param_specs(params, cfg, plan)
    return _walk(lambda t, ax: _tuple_spec(ax, t.dim(), plan.axis),
                 params, axes)


def compute_cache_specs(cache, rest_specs, plan: ServingShardPlan):
    """The layout a shard computes a dense cache with: its rest spec
    (batch or sequence on the data axes kept) without the model axis,
    but for the kv-head dim of ``k`` / ``v`` when the plan splits
    heads (SSM state and conv compute replicated, as in serving)."""
    def one(path, t):
        sp = _entries(_at(rest_specs, path), t.dim())
        keep = plan.heads and (path.endswith("/k") or path.endswith("/v"))
        return tuple(e if e != plan.axis or (keep and d == t.dim() - 2)
                     else None for d, e in enumerate(sp))
    return _map_paths(one, cache)


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


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


# ------------------------------ collectives ----------------------------- #
class ShardComm:
    """The collectives of one group of shards, each shard on a thread of
    its own; member i of the group calls them with its index i.  A
    collective deposits the caller's tensor in its slot, waits at a
    ``threading.Barrier`` for every member, and reads all slots.  Two
    sets of slots are used in turn: a member writes collective k + 2's
    slot only after every member passed collective k + 1, so after every
    member has read collective k's.  A member that fails aborts the
    barrier, and every member waiting in a collective raises
    ``BrokenBarrierError`` at once.

    ``stats[i]`` counts member i's collectives by kind ("all-gather",
    "all-reduce"): ``{"count", "bytes"}``, the bytes of each result.
    ``solo``: a group of n of which one member runs (the dry run's shard
    alone): every other member's tensor is taken to be the caller's, so
    the results have their real shapes and the counts their real
    values."""

    def __init__(self, n: int, timeout: Optional[float] = BARRIER_TIMEOUT,
                 solo: bool = False):
        self.n = n
        self.solo = solo
        self._barrier = threading.Barrier(1 if solo else n, timeout=timeout)
        self._slots = ([None] * n, [None] * n)
        self._turn = [0] * n
        self.stats = [{} for _ in range(n)]

    def exchange(self, i: int, t) -> list:
        """Every member's ``t`` of this collective, in member order."""
        if self.solo:
            return [t] * self.n
        slots = self._slots[self._turn[i] & 1]
        self._turn[i] += 1
        slots[i] = t
        self._barrier.wait()
        return list(slots)

    def _book(self, i: int, kind: str, out: torch.Tensor) -> None:
        c = self.stats[i].setdefault(kind, {"count": 0, "bytes": 0})
        c["count"] += 1
        c["bytes"] += out.numel() * out.element_size()

    def all_gather(self, i: int, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every member's ``t`` concatenated on ``dim`` in member order,
        on the caller's device."""
        out = torch.cat([x.to(t.device) for x in self.exchange(i, t)],
                        dim=dim)
        self._book(i, "all-gather", out)
        return out

    def psum(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The sum of every member's ``t``, added in member order on the
        caller's device.  Exact when each value has one contributor and
        the other members hold zeros there (x + 0 == x)."""
        parts = self.exchange(i, t)
        out = parts[0].to(t.device)
        for x in parts[1:]:
            out = out + x.to(t.device)
        self._book(i, "all-reduce", out)
        return out

    def abort(self) -> None:
        self._barrier.abort()

    def reset(self) -> None:
        """Make the barrier usable again after an abort (no member may be
        waiting in it)."""
        self._barrier.reset()
        self._turn = [0] * self.n
        self._slots = ([None] * self.n, [None] * self.n)


class MeshComms:
    """A ``ShardComm`` for every group of every set of a mesh's axes: for
    the axes ("model",) one group per data index, for ("data",) one per
    model index, and so on.  ``solo``: the dry run's shard 0 alone, one
    solo group per set of axes."""

    def __init__(self, mesh: Mesh, timeout: Optional[float] = BARRIER_TIMEOUT,
                 solo: bool = False):
        self.mesh = mesh
        self.solo = solo
        self._groups: dict = {}
        names = mesh.axis_names
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(names, r):
                n = _axis_size(mesh, axes)
                if solo:
                    self._groups[axes] = {None: ShardComm(n, timeout, True)}
                    continue
                groups = self._groups[axes] = {}
                for i in range(mesh.size):
                    key = self._key(i, axes)
                    if key not in groups:
                        groups[key] = ShardComm(n, timeout)

    def _key(self, i: int, axes: tuple):
        if self.solo:
            return None
        return tuple(c for a, c in self.mesh.coords(i).items()
                     if a not in axes)

    def member(self, i: int, entry) -> tuple[ShardComm, int]:
        """Shard i's group over the axes of a spec entry, and its index
        in it (the entry's first axis major)."""
        axes = tuple(a for a in self.mesh.axis_names if a in _names(entry))
        return (self._groups[axes][self._key(i, axes)],
                self.mesh.part(i, axes)[0])

    def _all(self):
        return [c for g in self._groups.values() for c in g.values()]

    def stats(self, i: int) -> dict:
        """Shard i's collectives over every group it belongs to."""
        out: dict = {}
        for axes in self._groups:
            comm, j = self.member(i, axes)
            for kind, c in comm.stats[j].items():
                o = out.setdefault(kind, {"count": 0, "bytes": 0})
                o["count"] += c["count"]
                o["bytes"] += c["bytes"]
        return out

    def abort(self) -> None:
        for c in self._all():
            c.abort()

    def reset(self) -> None:
        for c in self._all():
            c.reset()


def _tracked(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _Enter(torch.autograd.Function):
    """Megatron's "enter": the identity forward; backward, the sum over
    the model group of every shard's partial gradients, all of one
    region's tensors in one collective (so each shard runs its regions'
    collectives in the one order the layers chain them in)."""

    @staticmethod
    def forward(ctx, comm, i, *ts):
        ctx.comm, ctx.i = comm, i
        ctx.shapes = [t.shape for t in ts]
        ctx.meta = [(t.dtype, t.device) for t in ts]
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        dt = ctx.meta[0][0]
        for d, _ in ctx.meta[1:]:
            dt = torch.promote_types(dt, d)
        flat = torch.cat([
            (torch.zeros(s, dtype=dt, device=dev) if g is None
             else g.to(dt)).reshape(-1)
            for g, s, (_, dev) in zip(gs, ctx.shapes, ctx.meta)])
        summed = ctx.comm.psum(ctx.i, flat)
        out, o = [], 0
        for s, (d, _) in zip(ctx.shapes, ctx.meta):
            n = math.prod(s)
            out.append(summed[o:o + n].view(s).to(d))
            o += n
        return (None, None, *out)


class _Gather(torch.autograd.Function):
    """Megatron's "gather": the concatenation forward; backward, the
    shard's own slice of the gradient (every shard's is the same)."""

    @staticmethod
    def forward(ctx, t, comm, i, dim):
        ctx.dim, ctx.w = dim, t.shape[dim]
        ctx.off = i * ctx.w
        return comm.all_gather(i, t, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.off, ctx.w), None, None, None


class _SlotSum(torch.autograd.Function):
    """A sum over the model group in which each value has one
    contributor (MoE slots); backward, the identity."""

    @staticmethod
    def forward(ctx, t, comm, i):
        return comm.psum(i, t)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _DataMean(torch.autograd.Function):
    """The mean over the data group (MoE batch statistics); backward, the
    identity: every data shard's loss holds the same mean, and the step
    averages the gradients over the data group."""

    @staticmethod
    def forward(ctx, t, comm, i):
        return comm.psum(i, t) / comm.n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """What a model call of shard ``index`` is given as ``shard=``: the
    plan's flags (read as ``shard.heads`` etc., as the reference reads
    its plan) and the collectives of its group on the plan's axis
    (``comm``).  A training shard also has a data group
    (``data_comm``, its index ``data_index`` there), over which MoE
    batch statistics are averaged; ``seq``: a dense cache's sequence dim
    is split over that group (sequence-sharded decode)."""
    plan: ServingShardPlan
    index: int
    comm: ShardComm
    data_comm: Optional[ShardComm] = None
    data_index: int = 0
    seq: bool = False

    def __getattr__(self, name):
        # heads, mla_heads, experts, mlp, ssm_lanes, size, axis
        return getattr(self.plan, name)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        if _tracked(t):
            return _Gather.apply(t, self.comm, self.index, dim)
        return self.comm.all_gather(self.index, t, dim)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """A sum of one contributor per value (the MoE slot buffer)."""
        if _tracked(t):
            return _SlotSum.apply(t, self.comm, self.index)
        return self.comm.psum(self.index, t)

    def enter(self, *ts):
        """Mark the replicated tensors that feed one region of this
        shard's split compute: the identity (one tensor back for one,
        else a tuple); their gradients are summed over the group."""
        if any(_tracked(t) for t in ts):
            ts = _Enter.apply(self.comm, self.index, *ts)
        return ts[0] if len(ts) == 1 else tuple(ts)

    @property
    def data_size(self) -> int:
        return 1 if self.data_comm is None else self.data_comm.n

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the data group (``t`` itself without
        one)."""
        if self.data_comm is None:
            return t
        if _tracked(t):
            return _DataMean.apply(t, self.data_comm, self.data_index)
        return self.data_comm.psum(self.data_index, t) / self.data_comm.n

    def data_all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every data shard's ``t`` (not tracked by autograd)."""
        if self.data_comm is None:
            return t
        return self.data_comm.all_gather(self.data_index, t, dim)

    def abort(self) -> None:
        self.comm.abort()


@dataclasses.dataclass(frozen=True)
class MeshShard:
    """Shard ``index`` of a training mesh: its coordinates and the groups
    it belongs to, what a per-shard program (``launch/steps.py``) is
    given.  Its collectives here are outside autograd."""
    mesh: Mesh
    comms: MeshComms
    index: int

    @property
    def coords(self) -> dict:
        return self.mesh.coords(self.index)

    def all_gather(self, t: torch.Tensor, dim: int, entry) -> torch.Tensor:
        comm, j = self.comms.member(self.index, entry)
        return comm.all_gather(j, t, dim)

    def psum(self, t: torch.Tensor, entry) -> torch.Tensor:
        comm, j = self.comms.member(self.index, entry)
        return comm.psum(j, t)

    def relayout(self, t: torch.Tensor, src, dst) -> torch.Tensor:
        """``t``, this shard's part of a leaf laid out by spec ``src``, as
        its part under ``dst``: dimension by dimension an all-gather over
        the axes ``src`` splits it on, then a slice on those ``dst``
        does."""
        src = _entries(src, t.dim())
        dst = _entries(dst, t.dim())
        for dim, (a, b) in enumerate(zip(src, dst)):
            if a == b:
                continue
            if a is not None:
                t = self.all_gather(t, dim, a)
            if b is not None:
                idx, n = self.mesh.part(self.index, b)
                w = t.shape[dim] // n
                t = t.narrow(dim, idx * w, w)
        return t

    def relayout_tree(self, tree, src, dst):
        return _walk(lambda t, a, b: self.relayout(t, a, b), tree, src, dst)

    def model_ctx(self, plan: ServingShardPlan, seq: bool = False) -> ShardCtx:
        """The ``ShardCtx`` of this shard for a model call: the plan's
        axis group, and the data group of the mesh's data axes."""
        comm, i = self.comms.member(self.index, plan.axis)
        data_comm, j = None, 0
        d = data_group(self.mesh)
        if d is not None:
            data_comm, j = self.comms.member(self.index, d)
        return ShardCtx(plan, i, comm, data_comm, j, seq)

    def abort(self) -> None:
        self.comms.abort()


# ---------------------------- shard workers ----------------------------- #
def _serve(tasks: queue.Queue, done: queue.Queue, dev: torch.device,
           ctx) -> None:
    """A shard's worker loop: run each task with the shard's device
    current and the caller's grad mode; a failure aborts the barriers."""
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
            ctx.abort()
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
    returns the results in shard order: ``ctx`` is shard i's ``ShardCtx``
    on a ``ServingMesh`` (``plan`` given), its ``MeshShard`` on a
    ``Mesh``.  A shard that raises aborts the barriers, so the others
    leave their collectives instead of hanging, and ``run`` raises the
    first shard's own error (never a ``BrokenBarrierError`` that error
    caused), noted with its shard.  The threads stop when the pool is
    collected."""

    def __init__(self, mesh, plan: Optional[ServingShardPlan] = None,
                 timeout: Optional[float] = BARRIER_TIMEOUT):
        self.mesh = mesh
        self.timeout = timeout
        if isinstance(mesh, Mesh):
            if mesh.devices is None:
                raise ValueError("ShardWorkers: an abstract mesh has no "
                                 "devices to run on")
            self.comm = MeshComms(mesh, timeout)
            ctxs = [MeshShard(mesh, self.comm, i) for i in range(mesh.size)]
        else:
            self.comm = ShardComm(mesh.size, timeout)
            ctxs = [ShardCtx(plan, i, self.comm) for i in range(mesh.size)]
        self._done: queue.Queue = queue.Queue()
        self._tasks = [queue.Queue() for _ in mesh.devices]
        self._lock = threading.Lock()
        self._broken = None
        threads = [threading.Thread(
            target=_serve, name=f"mesh-shard-{i}", daemon=True,
            args=(self._tasks[i], self._done, dev, ctxs[i]))
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
