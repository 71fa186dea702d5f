"""The KD train step: losses, optimizer and the Distiller."""
