"""Device ms a served call spends in what the program's
``conformer.rel_pos`` spans launched (``RelPositionAttention.forward``: the
two score products, rel_shift, the mask, softmax and P V, every layer; not
the q / k / v / pos / out projections), over the profiled stretch's calls
(``span_device.py``). None in a model with no relative-position attention,
or a program without the span."""

from benchmark import span_device


def read(r):
    return span_device.device_ms(r.stretch, "conformer.rel_pos") if r.kind == "serve" else None
