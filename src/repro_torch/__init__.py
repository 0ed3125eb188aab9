"""PyTorch/CUDA port of the FedPA round (``src/repro`` is the JAX reference).

The port holds the synchronous FedPA/FedAvg round at ``parallel``
placement (``core.round.FedSim``), the EMNIST CNN, and the Sherman-Morrison
DP step as two hand-written CUDA kernels for Hopper
(``kernels/csrc/fedpa_dp.cu``). It imports ``torch``, numpy and the
standard library only; nothing of JAX or of the ``repro`` package.

Importing this package builds nothing and touches no device: the kernels
are compiled with ``nvcc`` at their first launch.
"""
