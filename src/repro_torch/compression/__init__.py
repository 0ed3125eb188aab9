"""Payload byte accounting of the port (dense payloads; codecs wait for
ROADMAP.md queue 1, item 9)."""
