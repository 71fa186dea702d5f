"""Python wrappers of the port's hand-written CUDA kernels (``csrc/``)."""

SOURCES = ("conv_frontend", "conv_frontend_bwd", "flash_attention",
           "flash_attention_bwd", "seeded_dropout", "pos_conv")  # csrc/<name>.cu
