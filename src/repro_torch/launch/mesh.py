"""Production and host meshes (port of ``repro/launch/mesh.py``).

Functions, not module constants: building a mesh touches no device
state, and an abstract one none at all.
"""
from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; multi_pod adds a leading 2-pod axis.
    Abstract (no devices): the dry run's mesh (``launch/dryrun.py``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(device=None) -> Mesh:
    """1x1 mesh over ``resolve_device(device)`` (CUDA unless named): the
    sharded step code path on one device."""
    return make_mesh((1, 1), ("data", "model"), [resolve_device(device)])
