"""PyTorch/CUDA port of the uops.info characterization pipeline.

Mirrors the reference JAX package ``repro`` module for module and holds to
its results bit for bit: a :class:`~repro_torch.core.engine.Campaign` runs
the measurement plans through ``BatchSimMachine`` waves, whose
dispatch/dependency recurrence runs in a hand-written CUDA kernel
(``csrc/wave_dispatch.cu``), and ``core.model_io`` exports the inferred
models as uops.info-style XML and JSON.  Entry points run on the card
(``backend="cuda"``, ``device="cuda"``) unless the caller asks for the CPU.
The package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.
"""
