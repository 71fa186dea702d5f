"""Python wrappers of the port's hand-written CUDA kernels (``csrc/``)."""

SOURCES = ("conv_frontend", "flash_attention", "flash_attention_bwd")  # csrc/<name>.cu
