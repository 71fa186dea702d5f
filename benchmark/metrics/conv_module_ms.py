"""Device ms a served call spends in what the program's
``conformer.conv_module`` spans launched (``ConvolutionModule.forward``:
LayerNorm, the pointwise conv, GLU, the depthwise conv, BatchNorm, SiLU,
the pointwise conv, every layer), over the profiled stretch's calls
(``span_device.py``). None in a model with no conformer layer, or a program
without the span."""

from benchmark import span_device


def read(r):
    if r.kind != "serve":
        return None
    return span_device.device_ms(r.stretch, "conformer.conv_module")
