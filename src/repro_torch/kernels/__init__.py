"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: B1 ``paged_attention.paged_decode_attention``, B2
``paged_prefill.paged_prefill_attention``, B3
``paged_verify.paged_verify_attention``, B4
``mla_paged_prefill.mla_paged_prefill_attention``, B5
``ssd_scan.ssd_scan`` and B6 ``flash_attention.flash_attention_bh``
(with its GQA wrapper ``flash_attention.attention``; sources in
``../csrc``, built by ``build.py`` at first use).  ``ref.py`` holds the
oracles: loop-per-lane, token-by-token, one head block at a time.
Importing this package needs neither ``nvcc`` nor a card."""
import contextlib
import threading

_COUNT_LOCK = threading.Lock()
_SHAPES_ONLY = threading.local()


@contextlib.contextmanager
def shapes_only():
    """Within it, on this thread, a wrapper given meta tensors runs its
    plain version (the dry run: ``launch/steps.run_shard0``); outside it
    a meta input raises like any device without a kernel."""
    prev = getattr(_SHAPES_ONLY, "on", False)
    _SHAPES_ONLY.on = True
    try:
        yield
    finally:
        _SHAPES_ONLY.on = prev


def plain_here(t) -> bool:
    """Does a wrapper run its plain version for an input on ``t``'s
    device: the CPU, or meta inside ``shapes_only()``."""
    return t.device.type == "cpu" or (
        t.device.type == "meta" and getattr(_SHAPES_ONLY, "on", False))


def bump(counts: dict, key: str, n: int = 1) -> None:
    """Add ``n`` to ``counts[key]`` under one lock: the shards of a mesh
    (``distributed/sharding.py``) launch kernels from threads of their
    own, and ``+=`` on a dict entry is not atomic across threads."""
    with _COUNT_LOCK:
        counts[key] += n
