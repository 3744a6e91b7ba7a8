"""Chip-side measurement tools of the port, run as modules on one NVIDIA
GPU (``PYTHONPATH=src python3 -m repro_torch.tools.<name>``); they import
nothing of JAX."""
