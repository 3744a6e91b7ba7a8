"""Corpora of the PyTorch port.

:mod:`repro_torch.corpus.jit_ops` holds the op corpus that the hardware
characterization path (``core/hardware.py``) measures.  The basic-block
corpus of the reference package (generation, store, evaluation, scoring)
is not ported yet.
"""
from repro_torch.corpus.jit_ops import build_jit_corpus

__all__ = ["build_jit_corpus"]
