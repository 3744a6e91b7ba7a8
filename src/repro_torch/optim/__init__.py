"""Optimizer (AdamW with clipping and schedule) and gradient compression,
the ports of the reference package's ``repro.optim``."""
