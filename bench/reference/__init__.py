"""Plain float32 references of the benchmark's model families, one module
a family (``ssm``), each with ``leaf_specs``, ``prefill`` and
``loss``; the shared blocks are in :mod:`common`."""
