"""Model FLOPs of the profiled stretch's work over its wall time and the
H100's bf16 peak. It counts the work, not which kernel does it.

train: each row's teacher forward and student forward at its own unpadded
  length, plus twice the student's forward for its backward, nothing
  recomputed (``work.kd_step_flops``).
serve: each utterance's student forward at its own unpadded length,
  through the heads the served model keeps."""

from benchmark import work


def read(r):
    if not r.units:
        return None
    d = r.cell.config["experiment"]["distiller"]
    if r.kind == "train":
        g = r.cell.config["teacher_geometry"]
        flops = sum(work.kd_step_flops(d, g, u["lengths"]) for u in r.units)
    else:
        live = 1 if d["layerwise_proj"] else 0
        flops = sum(work.student_fwd_flops(d, n, live_heads=live)
                    for u in r.units for n in u["lengths"])
    return 100.0 * flops / r.stretch.window_s / work.BF16_PEAK
