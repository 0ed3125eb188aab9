"""PyTorch/CUDA port of the FedPA round (``src/repro`` is the JAX reference).

The port holds the stateless synchronous round (``core.round.FedSim``:
FedAvg, FedPA, FedProx, MIME and precision-weighted FedPA in all three
placements, with cohort faults and q-FFL), the least-squares quickstart
(``examples.quickstart``), the EMNIST CNN, LM serving, and the
Sherman-Morrison DP step and decode attention as hand-written CUDA kernels
for Hopper (``kernels/csrc``). It imports ``torch``, numpy and the
standard library only; nothing of JAX or of the ``repro`` package.

Importing this package builds nothing and touches no device: the kernels
are compiled with ``nvcc`` at their first launch.
"""
