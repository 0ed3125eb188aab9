"""The paper's own EMNIST-62 model: 2x(conv 3x3 + maxpool) + 128-dense
(TFF reference architecture, Reddi et al. 2020), port of
``repro/models/cnn.py``; dropout omitted (deterministic evaluation).

The public functions keep the reference's layouts: NHWC images and HWIO
conv kernels, dense weights as (in, out). Inside, the convolutions permute
to ``conv2d``'s NCHW/OIHW, and the conv features are flattened in NHWC
order so the dense weights match the reference's row for row. Plain
functions of a params dict, so ``torch.func`` can batch them over clients.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.emnist_cnn import CNNConfig


def init_cnn_params(generator: torch.Generator, cfg: CNNConfig,
                    device=None, dtype=torch.float32):
    """Init the two conv layers and two dense layers (scaled normal
    weights, zero biases) from ``generator``."""
    c0, c1 = cfg.conv_channels
    k = cfg.kernel_size
    side = cfg.image_size // 4     # two 'SAME' conv + 2x2 maxpool stages
    flat = side * side * c1

    def normal(shape, fan):
        x = torch.randn(shape, generator=generator, dtype=dtype)
        return (x / math.sqrt(fan)).to(device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    return {
        "conv0": normal((k, k, cfg.in_channels, c0), k * k * cfg.in_channels),
        "b0": zeros(c0),
        "conv1": normal((k, k, c0, c1), k * k * c0),
        "b1": zeros(c1),
        "dense": normal((flat, cfg.hidden), flat),
        "bd": zeros(cfg.hidden),
        "out": normal((cfg.hidden, cfg.num_classes), cfg.hidden),
        "bo": zeros(cfg.num_classes),
    }


def _conv_relu_pool(h, w, b):
    """NCHW ``h``, HWIO ``w``: 'SAME' 3x3 conv, bias, ReLU, 2x2 max pool."""
    y = F.conv2d(h, w.permute(3, 2, 0, 1), b, padding=w.shape[0] // 2)
    return F.max_pool2d(F.relu(y), 2)


def cnn_forward(params, x, cfg: CNNConfig):
    """x: (B, H, W, C) -> logits (B, num_classes)."""
    del cfg
    h = x.permute(0, 3, 1, 2)
    h = _conv_relu_pool(h, params["conv0"], params["b0"])
    h = _conv_relu_pool(h, params["conv1"], params["b1"])
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ params["dense"] + params["bd"])
    return h @ params["out"] + params["bo"]


def cnn_loss(params, batch, cfg: CNNConfig):
    """Mean softmax cross-entropy over a {"x", "y"} batch."""
    logits = cnn_forward(params, batch["x"], cfg)
    labels = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return (logz - gold).mean()


def cnn_grad_fn(cfg: CNNConfig):
    """``grad_fn(params, batch) -> (loss, grads)`` for one client, built
    with ``torch.func`` so ``FedSim`` can batch it over the cohort."""
    grad_and_value = torch.func.grad_and_value(
        lambda p, batch: cnn_loss(p, batch, cfg))

    def grad_fn(params, batch):
        grads, loss = grad_and_value(params, batch)
        return loss, grads

    return grad_fn
