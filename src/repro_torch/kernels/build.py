"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared library,
loaded with ``ctypes``.  Nothing includes PyTorch's headers, so a build
takes seconds.  The build runs at first use (never at import: the CPU
tests import every module on machines with no ``nvcc``), from the sources
in the checkout only, into ``build/repro_torch_kernels/`` at the root of
the checkout.  A library is named after a hash of its source, of every
header under ``csrc/`` that it includes (``#include "x.cuh"``, followed
recursively) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded.

``build_all()`` starts one ``nvcc`` per source at once and waits for all
of them; ``chip_smoke.py`` calls it to build the kernels in parallel.

Beside its float32 launcher each source exports the variants of
``LAUNCHERS``, each with the float32 launcher's C signature: B1-B4 over
bfloat16 and float16 pages ("bf16", "f16"), B1 with bf16 queries and
output over bf16 pages ("bf16q"), and B5 and B6 over bf16 inputs and
outputs ("bf16"); ``load(name, variant)`` returns one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the exported launchers: every pointer and the stream
# are c_void_p (a plain int would truncate them to 32 bits)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "paged_decode": ("repro_paged_decode_f32",
                     [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P]),
    "paged_prefill": ("repro_paged_prefill_f32",
                      [_P] * 12 + [_I] * 7 + [_F, _I, _I, _P]),
    "paged_verify": ("repro_paged_verify_f32",
                     [_P] * 13 + [_I] * 7 + [_F, _I, _I, _P]),
    "mla_paged_prefill": ("repro_mla_paged_prefill_f32",
                          [_P] * 13 + [_I] * 7 + [_F, _I, _P]),
    "ssd_scan": ("repro_ssd_scan_f32", [_P] * 9 + [_I] * 6 + [_P]),
    "flash_attention": ("repro_flash_attention_f32",
                        [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P]),
}

# the launchers beside each source's float32 one, by variant (same
# argument types as the float32 launcher in SIGNATURES): pages in bf16 or
# f16 (B1-B4); B1's bf16 queries and output over bf16 pages; bf16 inputs
# and outputs of B5 and B6
_PAGED = ("paged_decode", "paged_prefill", "paged_verify",
          "mla_paged_prefill")
LAUNCHERS = {
    "bf16": {name: f"repro_{name}_bf16"
             for name in _PAGED + ("ssd_scan", "flash_attention")},
    "f16": {name: f"repro_{name}_f16" for name in _PAGED},
    "bf16q": {"paged_decode": "repro_paged_decode_bf16q"},
}

_FNS: dict = {}
_LOAD_LOCK = threading.Lock()   # mesh shards load from threads of their own
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "on a machine with the CUDA toolkit")


def _sources(path: Path, seen: list) -> list:
    """``path`` and every header under its directory that it includes,
    directly or through another header, each once, in include order."""
    if path in seen or not path.exists():
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        _sources(path.parent / inc.decode(), seen)
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu", []):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (Popen, final path, temp path) or
    None when the library for this exact source already exists."""
    out = _lib_path(name)
    if out.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, out, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)            # atomic: a reader never sees a partial .so
    return log


def build_all() -> dict:
    """Compile every kernel source in parallel (one nvcc each).  Returns
    ``{"seconds": wall time, "ptxas": {name: nvcc's -Xptxas -v output}}``."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SIGNATURES}
    logs = {name: _finish(name, s) for name, s in started.items()}
    return {"seconds": time.perf_counter() - t0, "ptxas": logs}


def load(name: str, variant: str = "f32"):
    """The exported launcher of ``csrc/<name>.cu`` for ``variant`` ("f32",
    or a key of ``LAUNCHERS`` that lists the source), building the
    library if needed.  Its C signature is set once, when the library is
    loaded; later calls return the same configured function."""
    key = name if variant == "f32" else (name, variant)
    fn = _FNS.get(key)
    if fn is not None:
        return fn
    with _LOAD_LOCK:
        fn = _FNS.get(key)
        if fn is None:
            fn_name, argtypes = SIGNATURES[name]
            if variant != "f32":
                fn_name = LAUNCHERS[variant][name]
            _finish(name, _start(name))
            fn = getattr(ctypes.CDLL(str(_lib_path(name))), fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[key] = fn
    return fn
