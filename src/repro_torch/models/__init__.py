"""Models of the port: the EMNIST CNN."""
