"""Deprecated location: the jitted-op corpus moved to
:mod:`repro_torch.corpus.jit_ops` when the corpus subsystem landed (one
"corpus" in the tree). This shim keeps old imports working.

The port of the reference package's ``repro.ops.corpus``."""
from repro_torch.corpus.jit_ops import build_corpus, build_jit_corpus

__all__ = ["build_corpus", "build_jit_corpus"]
