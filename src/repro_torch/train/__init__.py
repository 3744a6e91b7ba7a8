"""Serving (prefill, decode step, sampling) and the training step on the
port's models; the pipeline-parallel schedule waits for the mesh slice."""
