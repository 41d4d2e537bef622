"""Batch-execution performance model (paper §3.1.1).

The paper models one ``BatchForward`` call as a generalized roofline —
a max over affine "sources of execution time":

    T(batch) = max_l ( k1_l * #Tokens + k2_l * #SpecStep + b_l )

with in practice l = 2 terms: a compute line (k1 per token) and a fixed
memory line (weight read, b).  #SpecStep is the depth of draft-model
autoregression in the batch (max prefill chunk in the paper's Algorithm 3,
which doubles as the speculation depth for verification batches).

We provide:
  * ``from_roofline``  — derive (k1, k2, b) from hardware constants
    (TPU v5e target by default, A100-like for paper-fidelity runs).
  * ``fit``            — regress max-of-affine parameters from profiled
    samples, by alternating term assignment (the paper fits on profiled
    GPU runs; we fit on simulated/compiled-cost samples, R² reported in
    benchmarks/fidelity.py like Fig 10b).
  * ``time2bs``        — inverse model: the largest token budget that
    finishes within a latency target (used by Algorithm 2's dynamic
    batch-size tuning).

Beyond-paper extension (disabled by default, see EXPERIMENTS.md §Perf):
``k3 * #CtxKVBytes`` — a KV-read bandwidth term the paper omits; long-context
decode batches are KV-bandwidth-bound, not weight-bound.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


# ----------------------------- hardware specs ----------------------------- #
@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float      # FLOP/s per chip (bf16)
    hbm_bw: float          # bytes/s per chip
    link_bw: float         # bytes/s per ICI/NVLink link
    hbm_bytes: float       # HBM capacity per chip
    step_overhead: float = 200e-6   # fixed dispatch/launch overhead (s)


TPU_V5E = HardwareSpec("tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                       link_bw=50e9, hbm_bytes=16e9)
A100_40G = HardwareSpec("a100-40g", peak_flops=312e12, hbm_bw=1555e9,
                        link_bw=300e9, hbm_bytes=40e9)
H100_80G = HardwareSpec("h100-80g", peak_flops=989e12, hbm_bw=3352e9,
                        link_bw=450e9, hbm_bytes=80e9)

HARDWARE = {h.name: h for h in (TPU_V5E, A100_40G, H100_80G)}


@dataclasses.dataclass(frozen=True)
class PerfModel:
    """T(batch) = max_l (k1[l]*#tokens + k2[l]*#spec_step + b[l])."""

    terms: tuple[tuple[float, float, float], ...]  # (k1, k2, b) per line
    # Optional context-aware extension (beyond paper): seconds per KV byte.
    k3_kv: float = 0.0

    # ------------------------------------------------------------------ #
    def batch_time(self, n_tokens: float, spec_step: float = 0.0,
                   kv_bytes: float = 0.0) -> float:
        t = max(k1 * n_tokens + k2 * spec_step + b
                for (k1, k2, b) in self.terms)
        return t + self.k3_kv * kv_bytes

    def time2bs(self, t: float, spec_step: float = 0.0,
                kv_bytes: float = 0.0) -> int:
        """Largest #tokens with batch_time(...) <= t  (Algorithm 2, line 7)."""
        t = t - self.k3_kv * kv_bytes
        best = math.inf
        for (k1, k2, b) in self.terms:
            rem = t - b - k2 * spec_step
            if k1 <= 0:
                if rem < -1e-12:
                    return 0
                continue
            best = min(best, rem / k1)
        if best is math.inf:
            return 0
        return max(0, int(math.floor(best + 1e-9)))

    def max_token_tpt(self) -> float:
        """Asymptotic tokens/s (slope of the compute-bound line)."""
        k1 = max(k for (k, _, _) in self.terms)
        return 1.0 / k1

    # ------------------------------------------------------------------ #
    @classmethod
    def from_roofline(cls, n_params_active: float, weight_bytes: float,
                      hw: HardwareSpec, n_chips: int = 1,
                      spec_params: float = 0.0, mfu: float = 0.55,
                      hbm_eff: float = 0.80) -> "PerfModel":
        """Derive the two paper terms from hardware + model constants.

        compute line:  k1 = 2*N_active / (mfu * peak * chips) per token
                       (forward pass ~2 FLOPs / param / token)
        memory line:   b  = weight_bytes / (hbm_eff * hbm_bw * chips)
                       (every batch streams the weights from HBM once)
        spec overhead: k2 = per-draft-step latency of the draft model
                       (its own weight-read floor dominates at small batch).
        """
        flops = mfu * hw.peak_flops * n_chips
        bw = hbm_eff * hw.hbm_bw * n_chips
        k1 = 2.0 * n_params_active / flops
        b_mem = weight_bytes / bw
        k2 = 0.0
        if spec_params > 0:
            # One draft step is memory-bound: read draft weights once.
            k2 = (2.0 * spec_params) / bw
        compute_line = (k1, k2, hw.step_overhead)
        memory_line = (k1 * 0.1, k2, b_mem + hw.step_overhead)
        return cls(terms=(compute_line, memory_line))

    @classmethod
    def fit(cls, n_tokens: np.ndarray, spec_steps: np.ndarray,
            times: np.ndarray, n_terms: int = 2, iters: int = 50,
            seed: int = 0) -> "PerfModel":
        """Fit max-of-affine by alternating assignment/regression.

        Each sample is assigned to the term achieving the max, then each
        term is re-fit by least squares on its samples (a convex-piecewise
        analogue of Lloyd's algorithm).
        """
        rng = np.random.default_rng(seed)
        n_tokens = np.asarray(n_tokens, float)
        spec_steps = np.asarray(spec_steps, float)
        times = np.asarray(times, float)
        n = len(times)
        X = np.stack([n_tokens, spec_steps, np.ones(n)], axis=1)
        # init: split by token count quantile
        order = np.argsort(n_tokens)
        assign = np.zeros(n, int)
        assign[order[n // 2:]] = n_terms - 1
        params = np.zeros((n_terms, 3))
        for _ in range(iters):
            for l in range(n_terms):
                mask = assign == l
                if mask.sum() < 3:
                    idx = rng.choice(n, size=3, replace=False)
                    mask = np.zeros(n, bool)
                    mask[idx] = True
                sol, *_ = np.linalg.lstsq(X[mask], times[mask], rcond=None)
                params[l] = sol
            preds = X @ params.T              # (n, n_terms)
            new_assign = np.argmax(preds, axis=1)
            if np.array_equal(new_assign, assign):
                break
            assign = new_assign
        params = np.maximum(params, 0.0)      # physical: nonneg slopes/intercepts
        return cls(terms=tuple((float(a), float(b), float(c))
                               for a, b, c in params))

    def r_squared(self, n_tokens, spec_steps, times) -> float:
        pred = np.array([self.batch_time(t, s)
                         for t, s in zip(n_tokens, spec_steps)])
        times = np.asarray(times, float)
        ss_res = float(((times - pred) ** 2).sum())
        ss_tot = float(((times - times.mean()) ** 2).sum())
        return 1.0 - ss_res / max(ss_tot, 1e-30)


def opt_perf_model(n_params: float, hw: HardwareSpec = A100_40G,
                   n_chips: int = 1, spec: bool = False) -> PerfModel:
    """Paper-fidelity model for the OPT family (§6 Setup)."""
    spec_params = 125e6 if spec else 0.0
    return PerfModel.from_roofline(
        n_params_active=n_params, weight_bytes=2.0 * n_params, hw=hw,
        n_chips=n_chips, spec_params=spec_params)


def cpu_scale_perf_model() -> PerfModel:
    """Virtual-chip model scaled to CPU-miniaturized request lengths
    (~200 tok/s with a 20 ms weight-read floor) so TTFT/TPOT SLOs stay
    meaningful when a real reduced-config engine executes shrunken
    requests.  Single source of truth for launch/serve.py, the cluster
    example/benchmark, and the frontend/cluster tests."""
    return PerfModel(terms=((5e-3, 0.0, 1e-3), (5e-4, 0.0, 2e-2)))
