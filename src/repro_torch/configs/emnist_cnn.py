"""EMNIST-62 CNN — the paper's own benchmark model (Reddi et al. 2020 /
TensorFlow Federated reference: 2 conv layers 3x3 + maxpool + dropout +
128-unit dense + 62-way softmax).

This is NOT a decoder LM, so it has its own small config consumed by
``repro.models.cnn``; it exists for the paper-faithful Table-3-style
simulated benchmark (benchmarks/table3_benchmark_sim.py).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class CNNConfig:
    """Shape of the EMNIST-62 CNN (conv channels, kernel, dense width)."""

    name: str = "emnist-cnn"
    image_size: int = 28
    in_channels: int = 1
    conv_channels: tuple = (32, 64)
    kernel_size: int = 3
    hidden: int = 128
    num_classes: int = 62
    citation: str = "Reddi et al. 2020 (TFF reference model)"


def config() -> CNNConfig:
    """Build the paper-faithful EMNIST-62 CNN config."""
    return CNNConfig()


def smoke() -> CNNConfig:
    """Build a tiny CNN config for fast tests (14x14 inputs, 10 classes)."""
    return CNNConfig(name="emnist-cnn-smoke", image_size=14, conv_channels=(8, 16),
                     hidden=32, num_classes=10)
