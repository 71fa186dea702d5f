"""s3prl-style upstream expert (``fithubert_tpu/export/expert.py:33``).

    UpstreamExpert(ckpt, model_config, *args, device="cuda", length_quantum=16000, **kwargs)
    forward(wavs: list of 1-D waveforms, 16 kHz) ->
        {'last_hidden_state': (B, T, D_out) at 50 Hz,
         'hidden_states':     tuple of per-layer (B, T', D) hiddens,
         'padding_mask':      (B, T') bool, True = padding}
    get_downsample_rates(key) -> 320

The arguments come in the reference's order, as the s3prl hub hook passes
them (``hubconf.py:8-12``): ``ckpt`` is a torch state dict or a ``.pt`` file
of one, ``model_config`` a reference-schema YAML path or a
``StudentConfig``. Extra hub arguments are accepted and ignored, as the JAX
expert ignores its ``**kwargs``. Every projection head but the last is
dropped, as the reference's export does. The outputs are tensors on the
expert's device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Union

import numpy as np
import torch

from fithubert_tpu_torch.config import StudentConfig, load_yaml_config
from fithubert_tpu_torch.data.librispeech import quantize_length
from fithubert_tpu_torch.device import resolve_device
from fithubert_tpu_torch.models.student import StudentModel


class UpstreamExpert:
    def __init__(self, ckpt: Union[Mapping[str, torch.Tensor], str],
                 model_config: Union[StudentConfig, str], *args: Any,
                 device: Union[str, torch.device] = "cuda", length_quantum: int = 16000,
                 **kwargs: Any):
        if isinstance(ckpt, str) and ckpt.endswith(".ckpt"):
            raise NotImplementedError(
                f"{ckpt}: the reference's Lightning .ckpt is not read yet (ROADMAP Queue 1 "
                "item 5); pass a torch state dict or a .pt file of one")
        if kwargs.get("int8"):
            raise NotImplementedError("int8=True (quantize_matmuls): the PyTorch port "
                                      "serves only unquantized matmuls")
        self.device = resolve_device(device)
        self.cfg = load_yaml_config(model_config) if isinstance(model_config, str) \
            else model_config
        self.length_quantum = length_quantum
        sd = (torch.load(ckpt, map_location="cpu", weights_only=True)
              if isinstance(ckpt, str) else ckpt)
        last = f"proj_head.{self.cfg.encoder_layers - 1}."
        sd = {k: v for k, v in sd.items()
              if not k.startswith("proj_head.") or k.startswith(last)}
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
