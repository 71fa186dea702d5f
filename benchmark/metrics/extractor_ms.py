"""Device ms a served call spends in what the program's
``extractor.unfused`` span launched (``ConvFeatureExtractor``'s unfused
loop: each block's conv, bias, norm and GELU, as a ``layer_norm`` extractor
or one with conv bias runs), over the profiled stretch's calls
(``span_device.py``). None where the extractor takes the fused path (K1) or
the program has no such span."""

from benchmark import span_device


def read(r):
    return span_device.device_ms(r.stretch, "extractor.unfused") if r.kind == "serve" else None
