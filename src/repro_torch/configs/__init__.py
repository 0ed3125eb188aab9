"""Configs of the port: ``FedConfig`` and the EMNIST CNN."""
