"""Models of the PyTorch port (``fithubert_tpu/models``)."""
