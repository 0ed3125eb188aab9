"""Payload byte accounting of the port (dense payloads only)."""
