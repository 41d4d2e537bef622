"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: B1 ``paged_attention.paged_decode_attention``, B2
``paged_prefill.paged_prefill_attention``, B3
``paged_verify.paged_verify_attention`` and B4
``mla_paged_prefill.mla_paged_prefill_attention`` (sources in ``../csrc``,
built by ``build.py`` at first use).  ``ref.py`` holds the loop-per-lane oracles.
Importing this package needs neither ``nvcc`` nor a card."""
