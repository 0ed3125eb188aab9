"""Batched serving example: prefill a batch of prompts on a sliding-window
architecture (the gemma3-family smoke config), then decode with the
ring-buffer KV cache (counterpart of ``examples/serve_batched.py``).

Every flag goes to ``repro_torch.launch.serve`` and overrides the
example's; ``--arch`` picks any architecture of the registry (MoE,
RG-LRU, xLSTM and the frontend archs included). It runs on ``cuda``
unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
      --arch recurrentgemma-9b --device cpu
"""
from __future__ import annotations

import sys

from repro_torch.launch import serve

#: The example's settings; later flags override them.
EXAMPLE_ARGS = ["--arch", "gemma3-27b", "--batch", "4", "--prompt-len", "96",
                "--gen", "24"]


def main(argv=None) -> dict:
    """Run the example with ``argv`` (default: the command line); returns
    ``launch.serve.main``'s result."""
    args = list(sys.argv[1:] if argv is None else argv)
    return serve.main(EXAMPLE_ARGS + args)


if __name__ == "__main__":
    main()
