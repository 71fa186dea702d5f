"""Serving and weight exchange of the PyTorch port (``fithubert_tpu/export``)."""
