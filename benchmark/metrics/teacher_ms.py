"""Device ms a train step spends in the program's ``step.teacher`` phase
(the teacher's forward), from the events the step records at its phase
boundaries, over the steps of the profiled stretch's last graph replay; its
microbatches summed. Prints the phase's largest device ops there."""

from benchmark import program


def read(r):
    return program.phase_ms(r, "step.teacher") if r.kind == "train" else None
