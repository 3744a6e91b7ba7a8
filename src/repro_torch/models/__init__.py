"""Model-level code of the port (so far the chunked SSD of ``mamba.py``)."""
