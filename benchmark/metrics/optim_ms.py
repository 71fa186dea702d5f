"""Device ms a train step spends in the program's ``step.optim`` phase (the
gradients' fill, division and norm, AdamW and the logs), from the events the
step records at its phase boundaries, over the steps of the profiled
stretch's last graph replay; its microbatches summed. Prints the phase's
largest device ops there."""

from benchmark import program


def read(r):
    return program.phase_ms(r, "step.optim") if r.kind == "train" else None
