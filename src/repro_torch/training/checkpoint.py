"""Checkpoints (port of ``repro/training/checkpoint.py``): one ``.npz``
per step holding every leaf of ``{"params", "opt_state"}`` as
``leaf_<i>`` in ``tree.flatten`` order, with the leaves' key paths under
``__paths__`` (the reference stores its treedef's text), plus a
``latest`` marker file holding the newest step."""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from repro_torch.training.tree import flatten, unflatten


def save_checkpoint(path: str, step: int, params, opt_state=None) -> str:
    os.makedirs(path, exist_ok=True)
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    paths, leaves = flatten(state)
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, x in enumerate(leaves)}
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    np.savez(fname, __paths__=np.array(paths), **arrays)
    with open(os.path.join(path, "latest"), "w") as f:
        f.write(str(step))
    return fname


def latest_step(path: str) -> int:
    marker = os.path.join(path, "latest")
    if os.path.exists(marker):
        with open(marker) as f:
            return int(f.read().strip())
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.match(r"ckpt_(\d+)\.npz", f))]
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {path}")
    return max(steps)


def restore_checkpoint(path: str, template, step: int = None):
    """Restore into the structure of ``template`` (the same key paths):
    returns (tree, step), each tensor on its template leaf's device.
    Raises ``ValueError`` when the paths or a shape differ."""
    step = step if step is not None else latest_step(path)
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    paths, leaves = flatten(template)
    with np.load(fname) as data:
        saved = [str(p) for p in data["__paths__"]]
        if saved != paths:
            raise ValueError(f"{fname}: its key paths differ from the "
                             "template's")
        restored = []
        for i, t in enumerate(leaves):
            a = data[f"leaf_{i}"]
            if a.shape != tuple(t.shape):
                raise ValueError(f"{fname}: {paths[i]} is {a.shape}, the "
                                 f"template's {tuple(t.shape)}")
            restored.append(torch.from_numpy(a).to(t.device))
    return unflatten(template, restored), step
