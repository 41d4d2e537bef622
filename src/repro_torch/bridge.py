"""Move weights and KV state between the JAX reference and the port as
numpy arrays, so both run the same weights and their state can be compared.

The caller turns JAX arrays into numpy (``jax.tree.map(np.asarray, tree)``);
this module never imports JAX.  Key paths are the same on both sides:
``params["segments"][i]["p"]["attn"]["wq"]`` is the same (stacked) array.
Page pools differ by one page: the port's pools end in a write-off page
(``models/attention.py``) that the reference does not have.  The page axis
is found by the leaf's name: GQA pools (``k_pages``, ``v_pages``) are
(..., P, page, KVH, hd) and MLA pools (``ckv_pages``, ``krope_pages``)
(..., P, page, r | rope), each with an optional leading layer axis.  SSM
lane rows (``conv`` (..., max_seqs, d_conv - 1, C) and ``state`` (...,
max_seqs, H, P, N), lane axis 1 when stacked over layers) are the same on
both sides and cross unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


# trailing axes after the page axis, by pool leaf name
_PAGE_TAIL = {"k_pages": 3, "v_pages": 3, "ckv_pages": 2, "krope_pages": 2}
# SSM lane-row leaves: no page axis
_LANE_ROWS = ("conv", "state")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _map_pools(fn, pools):
    """``fn(leaf, page_axis)`` over every pool leaf of a cache pytree;
    the page axis of a lane-row leaf is None."""
    def leaf(k, v):
        if k in _PAGE_TAIL:
            return fn(v, v.ndim - 1 - _PAGE_TAIL[k])
        if k in _LANE_ROWS:
            return fn(v, None)
        return _map_pools(fn, v)
    if isinstance(pools, dict):
        return {k: leaf(k, v) for k, v in pools.items()}
    if isinstance(pools, (list, tuple)):
        return type(pools)(_map_pools(fn, v) for v in pools)
    raise ValueError(f"not a page pool leaf: {type(pools)}")


def params_from_numpy(tree, device=None):
    """A pytree of numpy arrays (from ``repro.models.init_params``) as
    torch tensors under the same key paths, on ``resolve_device(device)``
    (CUDA unless named)."""
    device = resolve_device(device)
    return _map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def pools_from_numpy(pools, device=None):
    """Reference page pools (per-segment ``{"self": {"k_pages", ...}}`` or
    ``{"self": {"ckv_pages", ...}}``, page axis 1 when stacked over layers,
    else 0) and SSM lane rows (``{"conv", "state"}``) as port pools on
    ``resolve_device(device)``: each page pool gets its trailing write-off
    page (zeros); lane rows cross as they are."""
    device = resolve_device(device)

    def conv(a, ax):
        a = np.asarray(a)
        if ax is None:
            return torch.from_numpy(np.array(a)).to(device)
        pad = [(0, 0)] * a.ndim
        pad[ax] = (0, 1)
        return torch.from_numpy(np.pad(a, pad)).to(device)
    return _map_pools(conv, pools)


def pools_to_numpy(pools):
    """Port page pools as reference-shaped numpy arrays (write-off page
    dropped) and lane rows as they are, for bit-level state comparisons."""
    def conv(t, ax):
        a = t.detach().cpu().numpy()
        if ax is None:
            return a
        return np.take(a, np.arange(a.shape[ax] - 1), axis=ax)
    return _map_pools(conv, pools)
