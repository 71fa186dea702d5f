"""The plain reference of the benchmark's cells: fp32 PyTorch, written
from the published models (fairseq's HuBERT and wav2vec 2.0 encoders, the
FitHuBERT and DistilHuBERT students and their losses, AdamW), importing
nothing of the program under test."""
