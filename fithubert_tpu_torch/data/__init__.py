"""The data pipeline of the PyTorch port (``fithubert_tpu/data``)."""
