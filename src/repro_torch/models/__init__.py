"""The model substrate of the port: the dense, VLM, MoE, SSM and hybrid
families (``transformer.py``, ``model.build_model``), their layers, the
Mamba2 blocks and SSD scan, and the carry of the reference's weights
(``carry.py``)."""
