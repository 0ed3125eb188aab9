"""Round math of the port: tree ops, IASG, the Sherman-Morrison DP, the
shrinkage and exact-posterior oracles, the server, the client update, the
round program, the engine and ``FedSim``."""
