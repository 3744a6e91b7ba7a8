"""Serving on the port's models (prefill, decode step, sampling); the
training loop and pipeline wait for the training slice."""
