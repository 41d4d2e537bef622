"""End-to-end serving on the PyTorch port (the paper's kind of workload):
the SLOs-Serve scheduler plans token batches and the port's engine
executes them with batched requests, chunked prefill and KV paging, on
the card through the hand-written CUDA kernels.  On the card it serves
smollm-135m at its published width; ``--reduced`` serves the reduced
config (with ``--device cpu``, the kernels' plain versions on the CPU).

  PYTHONPATH=src python examples/torch_serve_e2e.py                 # card
  PYTHONPATH=src python examples/torch_serve_e2e.py --device cpu --reduced

Pass ``--http`` to expose the same stack as a live HTTP/SSE gateway
(2 replicas, Ctrl-C drains in-flight streams before exit):

  PYTHONPATH=src python examples/torch_serve_e2e.py --http --port 8080

Every other argument goes to ``repro_torch.launch.serve``.
"""
import sys

from repro_torch.launch.serve import main as serve_main

ARGS = ["--arch", "smollm-135m", "--scenario", "chatbot", "--rate", "2.0",
        "--duration", "6.0"]


def main(argv=None) -> dict:
    """``repro_torch.launch.serve.main`` with this example's arguments
    ahead of ``argv`` (later ones win); returns its numbers."""
    argv = sys.argv[1:] if argv is None else list(argv)
    return serve_main(ARGS + argv)


if __name__ == "__main__":
    main()
