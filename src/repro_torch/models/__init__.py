"""Models of the port: the EMNIST CNN and the attention decoder (gemma3,
qwen3) with its serving steps."""
