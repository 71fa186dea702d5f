"""torch.hub entry points of the port, as the reference's s3prl hook
(``fithubert/hubconf.py``) and the repo's ``hubconf.py:8-15`` define them:

    expert = torch.hub.load("<repo>/fithubert_tpu_torch", "fithubert", source="local",
                            ckpt="FitHuBERT-960h.ckpt", model_config="FitHuBERT-960h.yaml")

``ckpt`` is the reference's Lightning ``.ckpt``, the port's export
(``student.pt``) or a state dict; ``model_config`` the dumped YAML or a
``StudentConfig``; the other arguments go to ``UpstreamExpert`` (``device``
defaults to the card).
"""

import os
import sys

# torch.hub puts this directory on sys.path; the package lives one above it
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from fithubert_tpu_torch.export.expert import UpstreamExpert  # noqa: E402

dependencies = ["torch", "numpy"]


def fithubert(ckpt, model_config, *args, **kwargs) -> UpstreamExpert:
    """The s3prl upstream expert of a trained student."""
    if not ckpt or not model_config:
        raise ValueError("both ckpt and model_config are required")
    return UpstreamExpert(ckpt, model_config, *args, **kwargs)


fithubert_local = fithubert
