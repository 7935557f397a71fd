"""Proteus-backed checkpointing of the port (twin of ``repro.checkpoint``)."""
