"""End-to-end example: federated training of the ~100M-parameter fedlm-100m
decoder on the synthetic-token federated corpus, through the port's
``launch/train.py`` (counterpart of ``examples/train_lm_federated.py``).

The reduced config by default; ``--full`` trains the whole 100M model.
Every other flag goes to ``repro_torch.launch.train`` and overrides the
example's: ``--arch`` trains any of the 11 archs instead (MoE, RG-LRU,
xLSTM, the frontend archs), reduced unless ``--full``. It runs on
``cuda`` unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.examples.train_lm_federated \\
      --device cpu                                            # smoke
  PYTHONPATH=src python -m repro_torch.examples.train_lm_federated \\
      --device cpu --arch qwen3-moe-30b-a3b                   # smoke MoE
  PYTHONPATH=src python -m repro_torch.examples.train_lm_federated --full \\
      --rounds 300 --clients 8 --batch 8 --seq-len 512        # real
"""
from __future__ import annotations

import sys

from repro_torch.launch import train

#: The example's settings; later flags override them.
EXAMPLE_ARGS = ["--arch", "fedlm-100m", "--algorithm", "fedpa",
                "--rounds", "20", "--clients", "4", "--local-steps", "8",
                "--burn-in-rounds", "5", "--server-lr", "0.3"]


def main(argv=None) -> dict:
    """Run the example with ``argv`` (default: the command line); returns
    ``launch.train.main``'s result."""
    args = list(sys.argv[1:] if argv is None else argv)
    full = "--full" in args
    args = [a for a in args if a != "--full"]
    return train.main(EXAMPLE_ARGS + ([] if full else ["--smoke"]) + args)


if __name__ == "__main__":
    main()
