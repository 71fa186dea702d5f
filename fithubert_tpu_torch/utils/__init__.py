"""Logging and profiling of the PyTorch port's loop (``fithubert_tpu/utils``)."""
