"""Model FLOPs of the profiled stretch's work over its wall time and the
H100's bf16 peak. It counts the work, not which kernel does it, by the
counts of the configuration's reference module (``reference.load``; for
``reference/model.py`` those of ``work.py``):

train: each row's teacher forward and student forward at its own unpadded
  length, plus twice the student's forward for its backward, nothing
  recomputed (``kd_step_flops``).
serve: each utterance's student forward at its own unpadded length,
  through the heads the served model keeps (``student_fwd_flops``)."""

from benchmark import reference, work


def read(r):
    if not r.units:
        return None
    model = reference.load(r.cell.config)
    d = r.cell.config["experiment"]["distiller"]
    if r.kind == "train":
        g = r.cell.config["teacher_geometry"]
        flops = sum(model.kd_step_flops(d, g, u["lengths"]) for u in r.units)
    else:
        live = 1 if d["layerwise_proj"] else 0
        flops = sum(model.student_fwd_flops(d, n, live_heads=live)
                    for u in r.units for n in u["lengths"])
    return 100.0 * flops / r.stretch.window_s / work.BF16_PEAK
