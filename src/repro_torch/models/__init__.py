"""The model substrate of the port: the dense, VLM, MoE, SSM, hybrid and
encoder-decoder families (``transformer.py``, ``model.build_model``) with
their losses and serving paths, their layers, the Mamba2 blocks and SSD
scan, and the carry of the reference's weights (``carry.py``)."""
