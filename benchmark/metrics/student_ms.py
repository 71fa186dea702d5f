"""Device ms a train step spends in the program's ``step.student`` phase
(the student's training forward and its losses), from the events the step
records at its phase boundaries, over the steps of the profiled stretch's
last graph replay; its microbatches summed. Prints the phase's largest
device ops there."""

from benchmark import program


def read(r):
    return program.phase_ms(r, "step.student") if r.kind == "train" else None
