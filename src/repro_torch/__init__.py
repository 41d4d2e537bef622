"""PyTorch/CUDA port of the SLOs-Serve runtime.

A second package beside the JAX reference ``repro``: the same planner,
paged KV runtime and serving engine, with every TPU Pallas kernel on the
serving path rewritten by hand in CUDA C++ for Hopper (``csrc/``).  It
imports ``torch`` and never JAX or ``repro``; its tests hold each module
against its JAX counterpart on the same seeded inputs.

Every entry point takes an explicit ``device`` (see ``device.py``): the
default is CUDA, and a missing card raises instead of falling back.
"""
