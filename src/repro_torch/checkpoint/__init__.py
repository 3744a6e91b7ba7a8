"""Sharded, compressed, atomic checkpoints, the port of
``repro.checkpoint``."""
