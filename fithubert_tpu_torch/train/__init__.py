"""Training: the KD train step (losses, optimizer, the Distiller), checkpoints
and the export pair, and the loop."""
