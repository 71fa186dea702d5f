"""PyTorch / CUDA port of fithubert_tpu: serving, the KD train step and the
training loop around it, for the transformer and conformer students and
the conv and log-mel front-ends.

Layout mirrors ``fithubert_tpu`` module for module. Every Pallas kernel on
the ported path has a hand-written CUDA counterpart under ``csrc/`` with a
Python wrapper under ``ops/kernels/``; on a CPU tensor the wrapper runs the
kernel's plain PyTorch version instead. This package imports neither JAX nor
anything of ``fithubert_tpu``.
"""
