"""The relative-position core's share of its roofline in serving: the least
time of its work at the stretch's calls over the device time of what the
program's ``conformer.rel_pos`` spans launched (``relpos_ms``). The work is
the configuration's reference module's ``relpos_work`` at each row's
unpadded length, whatever computes it: 3 x 2 t^2 H d_k FLOPs a layer and
row of t frames (Q K^T, the position term at the t^2 offsets rel_shift
keeps, P V), and q, k, v, the 2t - 1 position rows and the output in bf16.
Its least time is the larger of its FLOPs over 989 TFLOP/s and its bytes
over 3.35 TB/s, a call's work taken whole. None where the module counts no
such work or the stretch holds no such span."""

from benchmark import reference, span_device, work


def read(r):
    if r.kind != "serve" or not r.units:
        return None
    count = getattr(reference.load(r.cell.config), "relpos_work", None)
    ms = span_device.device_ms(r.stretch, "conformer.rel_pos")
    if count is None or ms is None:
        return None
    d = r.cell.config["experiment"]["distiller"]
    least = sum(work.bound(*count(d, u["lengths"]))[0] for u in r.units)
    return 100.0 * least / (ms / 1e3 * len(r.units))
