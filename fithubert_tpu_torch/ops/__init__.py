"""Layers and kernels of the PyTorch port (``fithubert_tpu/ops``)."""
