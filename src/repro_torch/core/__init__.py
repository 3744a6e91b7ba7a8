"""Characterization pipeline of the PyTorch port (see ``repro_torch``)."""
