"""Hand-written CUDA kernels of the port (``csrc/``), their wrappers and
their plain PyTorch twins (``ref.py``)."""
