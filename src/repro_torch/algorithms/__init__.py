"""Federated-algorithm strategy API of the port (see ``base.py``).

Importing this package registers the ported algorithms: ``fedavg``,
``fedpa`` (batch and streaming DP), ``fedprox``, ``mime``,
``fedpa_precision``, the stateful ``scaffold`` and ``fedep``, and
``fedlora`` (compressed payloads, stateful with error feedback).
"""
from repro_torch.algorithms.base import (  # noqa: F401  (base binds the
    ClientResult,                          # registry before the modules
    FedAlgorithm,                          # below populate it)
    algorithm_names,
    get_algorithm,
    get_algorithm_class,
    phase_name,
    register_algorithm,
    resolve_algorithm,
)
from repro_torch.algorithms.fedavg import FedAvg  # noqa: F401
from repro_torch.algorithms.fedep import FedEP  # noqa: F401
from repro_torch.algorithms.fedlora import FedLoRA  # noqa: F401
from repro_torch.algorithms.fedpa import FedPA  # noqa: F401
from repro_torch.algorithms.fedpa_precision import FedPAPrecision  # noqa: F401
from repro_torch.algorithms.fedprox import FedProx  # noqa: F401
from repro_torch.algorithms.mime import Mime  # noqa: F401
from repro_torch.algorithms.scaffold import Scaffold  # noqa: F401
