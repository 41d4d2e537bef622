"""Batch representation (paper Eqn. 1).

    Batch := [(ID_i, S_i ∈ {Prefill, Decode}, #Token_i)_i]

A batch supports chunked prefill (entry with fewer tokens than the request's
remaining prompt) and speculative decoding (decode entry verifying more than
one token).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.slo import StageKind


@dataclasses.dataclass
class BatchEntry:
    rid: int
    kind: StageKind
    n_tokens: int

    def __post_init__(self):
        assert self.n_tokens >= 0


@dataclasses.dataclass
class Batch:
    entries: list[BatchEntry] = dataclasses.field(default_factory=list)
    # Planner annotations:
    est_duration: float = 0.0       # perf-model estimate for this batch
    prefill_budget: int = 0         # unallocated tokens reserved for prefill
    spec_step: int = 0              # draft-model depth (0 = autoregressive)
    _index: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_tokens(self) -> int:
        return sum(e.n_tokens for e in self.entries) + self.prefill_budget

    @property
    def decode_tokens(self) -> int:
        return sum(e.n_tokens for e in self.entries
                   if e.kind == StageKind.DECODE)

    @property
    def prefill_tokens(self) -> int:
        return sum(e.n_tokens for e in self.entries
                   if e.kind == StageKind.PREFILL)

    def add(self, rid: int, kind: StageKind, n: int) -> None:
        if n <= 0:
            return
        e = self._index.get((rid, kind))
        if e is not None:
            e.n_tokens += n
            return
        e = BatchEntry(rid, kind, n)
        self._index[(rid, kind)] = e
        self.entries.append(e)

    def rids(self) -> set[int]:
        return {e.rid for e in self.entries}
