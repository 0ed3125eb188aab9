"""Carry parameters between the JAX package and the port, as numpy.

Both packages keep the same layout for every leaf, so conversion is a
dtype-preserving copy of each array:

* the EMNIST CNN (``models/cnn.py`` in both): a dict with ``conv0``
  (k, k, in, c0) and ``conv1`` (k, k, c0, c1) in HWIO order, ``dense``
  (side*side*c1, hidden) with rows in NHWC flatten order, ``out``
  (hidden, classes), and the biases ``b0``, ``b1``, ``bd``, ``bo``;
* any other model: whatever tree of arrays the JAX side holds — a dict
  of arrays, or one bare array (the least-squares problems).

The caller turns JAX arrays into numpy first (``np.asarray``), so this
module needs nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tree_math as tm


def params_from_jax(numpy_tree, device):
    """A tree of numpy arrays (from the JAX package) -> the port's tensors
    on ``device``, same keys, shapes and dtypes."""
    return tm.tmap(lambda x: torch.from_numpy(np.array(x)).to(device),
                   numpy_tree)


def params_to_numpy(params):
    """The port's tensors -> numpy arrays (same keys, shapes, dtypes), for
    the JAX package to load."""
    return tm.tmap(lambda x: x.detach().cpu().numpy(), params)
