"""Student configuration for the PyTorch port.

A copy of the fields of ``fithubert_tpu.config.StudentConfig`` that the
serving forward reads, with the same names and defaults, plus the preset
``fithubert_960h()`` whose values are ``configs/fithubert.yaml``'s
``distiller`` section as ``load_yaml_config`` resolves it (``use_fp16: True``
selects bfloat16 compute). ``yaml`` is imported only inside the function
that reads a file, so the package runs where ``yaml`` is not installed.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple


def _eval_node(node: ast.AST) -> Any:
    if isinstance(node, ast.Expression):
        return _eval_node(node.body)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (int, float)) or node.value is None:
            return node.value
        raise ValueError(f"disallowed constant in spec: {node.value!r}")
    if isinstance(node, (ast.List, ast.Tuple)):
        vals = [_eval_node(e) for e in node.elts]
        return vals if isinstance(node, ast.List) else tuple(vals)
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Mult)):
        left, right = _eval_node(node.left), _eval_node(node.right)
        return left + right if isinstance(node.op, ast.Add) else left * right
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_eval_node(node.operand)
    if isinstance(node, ast.Name) and node.id in ("None", "none"):
        return None
    raise ValueError(f"disallowed expression in spec: {ast.dump(node)}")


def parse_spec(spec: Any) -> Any:
    """Parse a spec string such as ``"[(128, 10, 5)] + [(256, 3, 2)] * 4"``:
    list/tuple arithmetic only, no arbitrary eval. Accepts already-parsed
    lists, None, "" and "None"."""
    if spec is None or spec == "" or spec == "None":
        return None
    if isinstance(spec, (list, tuple)):
        return list(spec)
    return _eval_node(ast.parse(str(spec), mode="eval"))


def conv_spec_tuple(spec: Any) -> Tuple[Tuple[int, int, int], ...]:
    """Parse a conv layer spec into a hashable tuple of (dim, kernel, stride)."""
    parsed = parse_spec(spec)
    if parsed is None:
        return ()
    out = []
    for cl in parsed:
        if len(cl) != 3:
            raise ValueError(f"invalid conv definition: {cl}")
        out.append((int(cl[0]), int(cl[1]), int(cl[2])))
    return tuple(out)


@dataclass(frozen=True)
class StudentConfig:
    # Extractor
    extractor_mode: str = "default"  # only 'default' (GroupNorm on block 0)
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    conv_bias: bool = False

    # Positional conv embedding
    conv_pos: int = 128
    conv_pos_groups: int = 16
    pos_conv_depth: int = 1

    # Encoder geometry
    layer_type: str = "transformer"
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    activation_fn: str = "gelu"
    layer_norm_first: bool = False

    # Heads
    pred_head_final_dim: int = 768
    layerwise_proj: bool = False

    # Time-reduction layer
    enable_tr_layer: bool = True
    tr_reduce_factor: int = 2
    tr_layer_type: str = "fc1"
    tr_layer_index: int = 1

    # Seq-length plumbing
    required_seq_len_multiple: int = 2
    crop_seq_to_multiple: int = 1

    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'

    @property
    def embed(self) -> int:
        """Feature-extractor output dim."""
        return self.conv_feature_layers[-1][0]

    @property
    def downsample_rate(self) -> int:
        """Total waveform stride of the front-end (320 for the release config)."""
        r = 1
        for _, _, s in self.conv_feature_layers:
            r *= s
        return r

    def check_supported(self) -> None:
        """Raise on options the port's forward does not implement yet."""
        unsupported = {
            "extractor_mode": (self.extractor_mode, "default"),
            "conv_bias": (self.conv_bias, False),
            "pos_conv_depth": (self.pos_conv_depth, 1),
            "layer_type": (self.layer_type, "transformer"),
            "activation_fn": (self.activation_fn, "gelu"),
            "layerwise_proj": (self.layerwise_proj, True),
        }
        if self.enable_tr_layer:
            unsupported["tr_layer_type"] = (self.tr_layer_type, "conv1d")
        for name, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(
                    f"{name}={got!r}: the PyTorch port supports only {want!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any], use_fp16: bool = False) -> "StudentConfig":
        """Build from a reference-style ``distiller:`` section, keeping only the
        fields this config has; ``use_fp16`` (the ``train:`` key) selects
        bfloat16 compute as the JAX loader does."""
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if "conv_feature_layers" in kw:
            kw["conv_feature_layers"] = conv_spec_tuple(kw["conv_feature_layers"])
        if use_fp16:
            kw["compute_dtype"] = "bfloat16"
        return cls(**kw)


def load_yaml_config(path: str) -> StudentConfig:
    """The student config of a reference-schema YAML file."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return StudentConfig.from_dict(
        raw.get("distiller", {}),
        use_fp16=bool(raw.get("train", {}).get("use_fp16", False)))


def fithubert_960h() -> StudentConfig:
    """FitHuBERT-960h (``configs/fithubert.yaml``), bfloat16 compute."""
    return StudentConfig(
        extractor_mode="default",
        conv_feature_layers=((128, 10, 5), (256, 1, 1)) + ((256, 3, 2),) * 4
        + ((512, 1, 1),) + ((512, 2, 2),) * 2,
        conv_bias=False,
        conv_pos=128,
        conv_pos_groups=16,
        pos_conv_depth=1,
        layer_type="transformer",
        encoder_layers=12,
        encoder_embed_dim=480,
        encoder_ffn_embed_dim=480,
        encoder_attention_heads=12,
        activation_fn="gelu",
        layer_norm_first=False,
        pred_head_final_dim=768,
        layerwise_proj=True,
        enable_tr_layer=True,
        tr_reduce_factor=2,
        tr_layer_type="conv1d",
        tr_layer_index=0,
        required_seq_len_multiple=1,
        crop_seq_to_multiple=1,
        compute_dtype="bfloat16",
    )
