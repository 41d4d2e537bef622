"""FLOP, byte and collective counts of one shard's step program (the
port's counterpart of ``repro/launch/hlo_analysis.py``).

The reference compiles the step, parses the partitioned HLO and
multiplies each ``while`` body by its trip count.  The port has no HLO
and runs eagerly: every layer's ops run (and are counted) as often as
they execute, so there is no loop to multiply.  ``CostMode`` is a
``TorchDispatchMode`` that sees every aten op of the program, its
backward pass included:

* FLOPs: the matmul-like ops (``mm``, ``bmm``, ``addmm``, convolutions,
  attention ops) as ``torch.utils.flop_counter`` counts them, and every
  other pointwise op at one a result element.  Reductions, softmax,
  indexing and copies count no FLOPs.
* Bytes: the operands plus the results of every aten op that is not a
  view.  This is unfused: each op reads and writes its tensors in HBM,
  where XLA fuses elementwise chains and counts bytes only at fusion
  boundaries, so the count is above the reference's for the same step.
* Collective bytes: the result bytes each collective of the shard's
  ``ShardComm`` groups booked (``distributed/sharding.py``), by kind, in
  the reference's keys (``all-gather``, ``all-reduce``, ...).

All counts are the shard's own (per chip, as the reference's partitioned
module gives them)."""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts ``flops`` and ``bytes`` of every aten op run under it (the
    module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.flops += float(sum(t.numel() for t in _tensors(out)))
        if not _is_view(func):
            self.bytes += float(sum(_nbytes(t) for t in
                                    _tensors((args, kwargs)) + _tensors(out)))
        return out


def collective_counts(stats: dict) -> dict:
    """A shard's ``MeshComms.stats`` in the reference's keys."""
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for k, c in stats.items():
        out[k] = dict(c)
    return out


def analyze(fn, *args) -> dict:
    """Run ``fn(*args)`` (which returns (result, MeshComms), as
    ``steps.run_shard0``) under ``CostMode``.  Returns the reference's
    keys: ``flops``, ``bytes``, ``collective_bytes``, ``collectives``, and
    ``result`` and ``ops`` (aten ops run)."""
    with CostMode() as cm:
        result, comms = fn(*args)
    coll = collective_counts(comms.stats(0))
    return {"flops": cm.flops, "bytes": cm.bytes,
            "collective_bytes": sum(c["bytes"] for c in coll.values()),
            "collectives": coll, "result": result, "ops": cm.ops}
