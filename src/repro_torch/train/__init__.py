"""Serving (prefill, decode step, sampling), the training step and the
GPipe pipeline over a mesh axis on the port's models."""
