"""s3prl-style upstream expert (``fithubert_tpu/export/expert.py:33``).

    UpstreamExpert(ckpt, model_config, *args, device="cuda", length_quantum=16000, **kwargs)
    forward(wavs: list of 1-D waveforms, 16 kHz) ->
        {'last_hidden_state': (B, T, D_out) at 50 Hz,
         'hidden_states':     tuple of per-layer (B, T', D) hiddens,
         'padding_mask':      (B, T') bool, True = padding}
    get_downsample_rates(key) -> 320

The arguments come in the reference's order, as the s3prl hub hook passes
them (``hubconf.py:8-12``): ``ckpt`` is a torch state dict, a ``.pt`` file
of one, or the reference's Lightning ``.ckpt`` (``reference_import.py``),
``model_config`` a reference-schema YAML path (its teacher-init flags are
turned off) or a ``StudentConfig``. Extra hub arguments are accepted and
ignored, as the JAX expert ignores its ``**kwargs``; ``int8=True`` raises.
Every layer-wise projection head but the last is dropped, as the
reference's export does; a SplitLinear head (``layerwise_proj=False``) goes
whole, and ``last_hidden_state`` is the upsampled final hidden. The rest
must match the model's keys exactly (a Lightning ``.ckpt``'s conformer keys
that the port drops on load excepted: ``reference_import.py``). A
conformer student serves from its BatchNorm running statistics, a mel
student without SpecAugment. The outputs are tensors on the expert's
device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Union

import numpy as np
import torch

from fithubert_tpu_torch.config import StudentConfig, load_yaml_config
from fithubert_tpu_torch.data.librispeech import quantize_length
from fithubert_tpu_torch.device import resolve_device
from fithubert_tpu_torch.export.reference_import import reference_student_state_dict
from fithubert_tpu_torch.models.student import StudentModel


class UpstreamExpert:
    def __init__(self, ckpt: Union[Mapping[str, torch.Tensor], str],
                 model_config: Union[StudentConfig, str], *args: Any,
                 device: Union[str, torch.device] = "cuda", length_quantum: int = 16000,
                 **kwargs: Any):
        if kwargs.get("int8"):
            raise NotImplementedError("int8=True (quantize_matmuls): the PyTorch port "
                                      "serves only unquantized matmuls")
        self.device = resolve_device(device)
        self.cfg = load_yaml_config(model_config) if isinstance(model_config, str) \
            else model_config
        self.length_quantum = length_quantum
        if not isinstance(ckpt, str):
            sd = ckpt
        elif ckpt.endswith(".ckpt"):
            sd = reference_student_state_dict(ckpt)
        else:
            sd = torch.load(ckpt, map_location="cpu", weights_only=True)
        last = f"proj_head.{self.cfg.encoder_layers - 1}." if self.cfg.layerwise_proj \
            else None
        sd = {k: v for k, v in sd.items()
              if not k.startswith("proj_head.") or (last and k.startswith(last))}
        self.model = StudentModel(self.cfg, disable_projections=True, device=self.device)
        self.model.load_state_dict(sd)
        self.model.eval()

    def get_downsample_rates(self, key: str = "") -> int:
        return self.cfg.downsample_rate

    def __call__(self, wavs: Sequence[Any]) -> Dict[str, Any]:
        return self.forward(wavs)

    def forward(self, wavs: Sequence[Any]) -> Dict[str, Any]:
        """wavs: 1-D float waveforms (numpy arrays or tensors)."""
        wavs = [w.detach().float().cpu().numpy() if isinstance(w, torch.Tensor)
                else np.asarray(w, np.float32) for w in wavs]
        lengths = [int(w.shape[0]) for w in wavs]
        t_pad = quantize_length(max(lengths), self.length_quantum)
        batch = np.zeros((len(wavs), t_pad), np.float32)
        mask = np.ones((len(wavs), t_pad), bool)
        for i, (w, n) in enumerate(zip(wavs, lengths)):
            batch[i, :n] = w
            mask[i, :n] = False
        out = self.model(torch.from_numpy(batch).to(self.device),
                         torch.from_numpy(mask).to(self.device))
        return {
            "last_hidden_state": out.x,
            "hidden_states": tuple(h for (h, _, _) in out.layer_results),
            "padding_mask": out.padding_mask,
        }
