"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: B1 ``paged_attention.paged_decode_attention``, B2
``paged_prefill.paged_prefill_attention`` and B3
``paged_verify.paged_verify_attention`` (sources in ``../csrc``, built by
``build.py`` at first use).  ``ref.py`` holds the loop-per-lane oracles.
Importing this package needs neither ``nvcc`` nor a card."""
