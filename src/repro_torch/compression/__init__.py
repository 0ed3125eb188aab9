"""Payload byte accounting and codec-spec validation of the port (dense
payloads; the codecs wait for ROADMAP.md queue 1, item 9)."""
