"""Round math of the port: tree ops, IASG, the Sherman-Morrison DP, the
server, the round program, the engine and ``FedSim``."""
