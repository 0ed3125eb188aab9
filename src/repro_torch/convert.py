"""Carry parameters between the JAX package and the port, as numpy.

Both packages keep the same layout for every leaf, so conversion is a
dtype-preserving copy of each array:

* the EMNIST CNN (``models/cnn.py`` in both): a dict with ``conv0``
  (k, k, in, c0) and ``conv1`` (k, k, c0, c1) in HWIO order, ``dense``
  (side*side*c1, hidden) with rows in NHWC flatten order, ``out``
  (hidden, classes), and the biases ``b0``, ``b1``, ``bd``, ``bo``;
* the LM (``models/model.py`` in both): ``embed`` (V, d),
  ``final_norm``, ``pattern/pos_i/...`` stacked over repeats (leading axis
  R) and ``tail/layer_i/...`` (``lm_params_from_jax``);
* any other model: whatever tree of arrays the JAX side holds — a dict
  of arrays, or one bare array (the least-squares problems).

The caller turns JAX arrays into numpy first (``np.asarray``), so this
module needs nothing of JAX. A bf16 leaf arrives as numpy's
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: its bits are
carried across through a ``uint16`` view, exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tree_math as tm


def _tensor(x) -> torch.Tensor:
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def params_from_jax(numpy_tree, device):
    """A tree of numpy arrays (from the JAX package) -> the port's tensors
    on ``device``, same keys, shapes and dtypes (bf16 bit for bit)."""
    return tm.tmap(lambda x: _tensor(x).to(device), numpy_tree)


def lm_params_from_jax(numpy_tree, device, dtype=None):
    """The JAX LM tree (``embed``, ``final_norm``, ``pattern``, ``tail``)
    -> the port's tensors on ``device``, in the JAX layout, cast to
    ``dtype`` if given."""
    missing = {"embed", "final_norm", "pattern"} - set(numpy_tree)
    if missing:
        raise KeyError(f"not a JAX LM tree: missing {sorted(missing)}")
    params = params_from_jax(numpy_tree, device)
    return params if dtype is None else tm.tcast(params, dtype)


def params_to_numpy(params):
    """The port's tensors -> numpy arrays (same keys, shapes, dtypes), for
    the JAX package to load."""
    return tm.tmap(lambda x: x.detach().cpu().numpy(), params)
