"""Configuration of the PyTorch port.

Copies of ``fithubert_tpu.config``'s dataclasses, with the same names and
defaults: ``StudentConfig`` (the fields the port's student has),
``LossConfig``, ``TrainConfig``, ``OptimizerConfig``, ``DataConfig``,
``SpecAugConfig``, ``TeacherConfig`` and ``ExperimentConfig``.

    config_from_yaml_dict(raw)  a reference-schema dict -> ExperimentConfig
    load_experiment_yaml(path)  the same from a file
    load_yaml_config(path)      the student that UpstreamExpert serves
    dump_config(cfg, path)      a YAML file, written without a YAML library
    read_yaml(path)             a YAML file as a dict

The presets are ``fithubert_960h()`` (the student of
``configs/fithubert.yaml`` as ``load_yaml_config`` resolves it;
``use_fp16: True`` selects bfloat16 compute) and
``fithubert_960h_experiment()`` (the whole file), ``ex_experiment()``
(``configs/ex.yaml``), ``conformer_experiment(pos_enc_type)`` (the release
file with conformer layers) and ``mel_experiment()`` (the release file with
the log-mel front-end, MelSpecHead and SpecAugment). ``yaml`` is imported only
inside ``read_yaml``, the one function that reads a file, so the package
imports where ``yaml`` is not installed.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


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


# Fields of the JAX StudentConfig (fithubert_tpu/config.py:95-169) that
# ``from_dict`` reads and drops: none of them changes the model the JAX
# package builds. ``tr_conv1d_kernel`` is ignored there too
# (``fithubert_tpu/ops/transformer.py:141-143``); ``final_dim``,
# ``max_positions`` and ``fp16`` are read by no JAX module; the rest are
# its TPU compile switches (lax.scan over layers, the Pallas kernels).
NO_EFFECT = ("final_dim", "fp16", "max_positions", "scan_layers",
             "tr_conv1d_kernel", "use_pallas_attention", "use_pallas_conv")


@dataclass(frozen=True)
class StudentConfig:
    # Extractor
    extractor_mode: str = "default"  # 'default' (GroupNorm on block 0) | 'layer_norm' (every block)
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
    feature_grad_mult: float = 1.0

    # Mel front-end alternative (n_mels > 0: no conv extractor)
    n_mels: int = 0
    enable_log_mel: bool = False
    mel_spec_head_conv_layers: Tuple[Tuple[int, int, int], ...] = ()

    # Positional conv embedding
    conv_pos: int = 128
    conv_pos_groups: int = 16
    pos_conv_depth: int = 1

    # Encoder geometry
    layer_type: str = "transformer"  # 'transformer' | 'conformer'
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    activation_fn: str = "gelu"
    layer_norm_first: bool = False

    # Conformer: 'espnet' builds the rel_pos / rope / abs attentions of
    # pos_enc_type; any other attn_type is the plain fairseq MHA
    depthwise_conv_kernel_size: int = 31
    attn_type: str = ""
    pos_enc_type: str = "abs"

    # Dropouts (training only; the serving forward is deterministic)
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    encoder_layerdrop: float = 0.0
    dropout_input: float = 0.0

    # Heads
    pred_head_final_dim: int = 768
    pred_head_inter_dim: int = 0  # SplitLinear's input width per task (0 = embed dim)
    pred_layer_id: Tuple[int, ...] = (3, 7, 11)
    layerwise_proj: bool = False

    # Teacher hint-init (models/surgery.py), read by training only
    init_conv_layers: bool = False
    init_encoder_layers: int = 0

    # Time-reduction layer
    enable_tr_layer: bool = True
    tr_reduce_factor: int = 2
    tr_layer_type: str = "fc1"
    tr_layer_index: int = 1

    # Seq-length plumbing
    required_seq_len_multiple: int = 2
    crop_seq_to_multiple: int = 1

    # Driver-injected: a wav2vec_ctc teacher makes the student task-specific
    # (a CTC term on its output), and the cnn loss weight (a cnn_proj_head
    # exists when > 0)
    teacher_task_agnostic: bool = True
    cnn_weight: float = 0.0

    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # int8 matmuls (ops/quant.py) at the encoder's q/k/v/out, fc1 / fc2 and
    # the conformer's projections and FFN: serving only (Distiller refuses it)
    quantize_matmuls: bool = False
    # activation checkpointing of each encoder layer in training (ops/remat.py),
    # the JAX package's nn.remat: the same results, less activation memory
    checkpoint_activations: bool = False

    @property
    def embed(self) -> int:
        """Feature-extractor output dim: the last conv's, or with the mel
        front-end MelSpecHead's last conv's (the mel count without one)."""
        if self.n_mels > 0:
            if self.mel_spec_head_conv_layers:
                return self.mel_spec_head_conv_layers[-1][0]
            return self.n_mels
        return self.conv_feature_layers[-1][0]

    @property
    def dedicated_conformer(self) -> bool:
        """The conformer encoder of its own (``ops/conformer.py``): no TR
        module, no positional conv; ``abs`` conformer layers sit in the
        transformer encoder."""
        return self.layer_type == "conformer" and self.pos_enc_type in ("rel_pos", "rope")

    @property
    def n_tasks(self) -> int:
        """Teacher layers the SplitLinear head predicts (``layerwise_proj=False``)."""
        return len(self.pred_layer_id)

    @property
    def downsample_rate(self) -> int:
        """Total waveform stride of the front-end (320 for the release
        config, the hop of the mel front-end)."""
        if self.n_mels > 0:
            return 320
        r = 1
        for _, _, s in self.conv_feature_layers:
            r *= s
        return r

    def check_supported(self) -> None:
        """Raise where the JAX package raises on building the model: an
        unknown extractor mode, activation or layer type, a TR type other
        than conv1d / fc1 / fc2 (``fc3`` included), log-mel without mels.
        The heads are checked by ``StudentModel``, so the teacher's encoder
        view (no TR layer, no heads) passes."""
        from fithubert_tpu_torch.ops.activations import ACTIVATIONS

        if self.extractor_mode not in ("default", "layer_norm"):
            raise ValueError(f"extractor_mode {self.extractor_mode!r}: one of 'default', "
                             "'layer_norm'")
        if self.activation_fn not in ACTIVATIONS:
            raise ValueError(f"activation_fn {self.activation_fn!r}: one of "
                             f"{sorted(ACTIVATIONS)}")
        if self.layer_type not in ("transformer", "conformer"):
            raise NotImplementedError(
                f"layer_type={self.layer_type!r}: one of 'transformer' and 'conformer'")
        if self.n_mels <= 0 and self.enable_log_mel:
            raise ValueError("enable_log_mel needs n_mels > 0")
        if self.enable_tr_layer and self.tr_layer_type not in ("conv1d", "fc1", "fc2"):
            raise NotImplementedError(
                "tr_layer_type must be one of ['fc1', 'fc2', 'conv1d']")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any], use_fp16: bool = False) -> "StudentConfig":
        """Build from a reference-style ``distiller:`` section; ``use_fp16``
        (the ``train:`` key) selects bfloat16 compute as the JAX loader
        does. The fields of ``NO_EFFECT`` are read and dropped; any key that
        the JAX StudentConfig lacks too raises ValueError, naming it, as
        ``fithubert_tpu/config.py:209-212`` does."""
        d = dict(d)
        if "_teacher_task_agnostic" in d:  # the reference's private field names
            d["teacher_task_agnostic"] = bool(d.pop("_teacher_task_agnostic"))
        if "_cnn_weight" in d:
            d["cnn_weight"] = float(d.pop("_cnn_weight"))
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known - set(NO_EFFECT)
        if unknown:
            raise ValueError(f"unknown distiller config keys: {sorted(unknown)}")
        kw = {k: v for k, v in d.items() if k in known}
        for key in ("conv_feature_layers", "mel_spec_head_conv_layers"):
            if key in kw:
                kw[key] = conv_spec_tuple(kw[key])
        if "pred_layer_id" in kw:
            kw["pred_layer_id"] = tuple(int(i) for i in (parse_spec(kw["pred_layer_id"]) or ()))
        if use_fp16:
            kw["compute_dtype"] = "bfloat16"
        return cls(**kw)

    def to_dict(self) -> Dict[str, Any]:
        """The reference's ``distiller:`` field names and spec strings, as
        the JAX package's ``StudentConfig.to_dict`` writes them."""
        d = dataclasses.asdict(self)
        d["_teacher_task_agnostic"] = d.pop("teacher_task_agnostic")
        d["_cnn_weight"] = d.pop("cnn_weight")
        d["conv_feature_layers"] = str([tuple(t) for t in self.conv_feature_layers])
        d["mel_spec_head_conv_layers"] = (str([tuple(t) for t in self.mel_spec_head_conv_layers])
                                          if self.mel_spec_head_conv_layers else "None")
        d["pred_layer_id"] = str(list(self.pred_layer_id))
        return d


def read_yaml(path: str) -> Dict[str, Any]:
    """A YAML file as a dict (needs PyYAML)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_yaml_config(path: str) -> StudentConfig:
    """The student config that ``UpstreamExpert`` serves from a
    reference-schema YAML file. The teacher-init flags only tell training how
    to start, so they are turned off first, as the JAX expert does
    (``fithubert_tpu/export/expert.py:57-65``)."""
    raw = read_yaml(path)
    distiller = dict(raw.get("distiller", {}), init_conv_layers=False, init_encoder_layers=0)
    cfg = StudentConfig.from_dict(
        distiller,
        use_fp16=bool(raw.get("train", {}).get("use_fp16", False)))
    # the JAX loader derives it from the teacher's type
    return dataclasses.replace(cfg, teacher_task_agnostic=(
        (raw.get("teacher") or {}).get("model_type", "hubert") != "wav2vec_ctc"))


def fithubert_960h() -> StudentConfig:
    """FitHuBERT-960h (``configs/fithubert.yaml``), bfloat16 compute."""
    return StudentConfig(
        extractor_mode="default",
        conv_feature_layers=((128, 10, 5), (256, 1, 1)) + ((256, 3, 2),) * 4
        + ((512, 1, 1),) + ((512, 2, 2),) * 2,
        conv_bias=False,
        feature_grad_mult=1.0,
        n_mels=0,
        enable_log_mel=False,
        mel_spec_head_conv_layers=((128, 7, 1), (256, 5, 1), (512, 5, 1), (512, 5, 1)),
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
        depthwise_conv_kernel_size=31,
        attn_type="",
        pos_enc_type="abs",
        dropout=0.1,
        attention_dropout=0.1,
        activation_dropout=0.1,
        encoder_layerdrop=0.0,
        dropout_input=0.05,
        pred_head_final_dim=768,
        pred_layer_id=(11,),
        layerwise_proj=True,
        enable_tr_layer=True,
        tr_reduce_factor=2,
        tr_layer_type="conv1d",
        tr_layer_index=0,
        required_seq_len_multiple=1,
        crop_seq_to_multiple=1,
        compute_dtype="bfloat16",
    )


@dataclass(frozen=True)
class LossConfig:
    """The KD loss weights (``fithubert_tpu/config.py:236``)."""

    cnn_loss_weight: float = 0.0
    rec_loss_weight: float = 1.0
    rec_loss_type: str = "l1"  # 'l1' | 'mse'
    sim_loss_weight: float = 1.0
    attn_loss_weight: float = 0.0
    attn_loss_type: str = "kldiv"
    v_rel_loss_weight: float = 0.0
    distil_random_layer: int = 0
    random_layer_weight: float = 0.0
    use_gt_for_ctc: bool = True
    ctc_loss_weight: float = 1.0
    masked_reduction: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """``fithubert_tpu/config.py:256 TrainConfig``: the loop's settings and
    the train step's."""

    output_dir: str = "results/pretrain/test"
    checkpoint: Optional[str] = None
    num_epochs: int = 100
    num_devices: int = 0  # 0 = every visible card ('gpus' in the reference yaml)
    batch_size: int = 4
    accumulate_grad_batches: int = 1
    use_fp16: bool = False  # -> bfloat16 compute for teacher and student
    monitor_losses: bool = True
    delete_projections: bool = False
    specaug: bool = False
    early_stop_patience: int = 15
    save_top_k: int = 3
    log_every: int = 50
    seed: int = 0
    max_steps: int = 0  # 0 = no cap
    profile_steps: int = 0  # trace steps [2, 2 + N) into <output_dir>/trace
    fuse_grad_accum: bool = True
    # K optimizer steps per launch: on the card one CUDA graph of K steps
    # (train/step.py Distiller.train_step_chain), on the CPU K single steps
    steps_per_launch: int = 1
    rng_impl: str = "auto"  # the JAX package's PRNG; the port's draws are ops/dropout.py's


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "AdamW_with_schedule"
    lr: float = 2.0e-4
    warmup_proportion: float = 0.07
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1.0e-6
    weight_decay: float = 1.0e-6


@dataclass(frozen=True)
class DataConfig:
    """``fithubert_tpu/config.py:316 DataConfig``."""

    bucketing_path: str = "./data/len_for_bucket"
    libri_root: str = "../LibriSpeech"
    train_set: Tuple[str, ...] = ("train-clean-100", "train-clean-360", "train-other-500")
    test_set: Tuple[str, ...] = ("test-clean",)
    dev_set: Tuple[str, ...] = ("dev-clean",)
    length_quantum: int = 40960  # padded lengths are multiples of this (128 frames)
    max_wav_length: int = 0  # 0 = no crop
    num_workers: int = 4
    prefetch: int = 2
    synthetic: bool = False  # sine + noise batches, no corpus
    synthetic_num_batches: int = 64
    synthetic_wav_length: int = 163840
    load_labels: bool = False
    label_quantum: int = 64
    dict_path: str = ""


@dataclass(frozen=True)
class SpecAugConfig:
    """``fithubert_tpu/config.py:341 SpecAugConfig``: the masks that
    ``ops/specaug.py`` applies to the mel features when ``train.specaug``."""

    apply_time_warp: bool = False
    time_warp_window: int = 5
    time_warp_mode: str = "bicubic"
    apply_freq_mask: bool = True
    freq_mask_width_range: Tuple[int, int] = (0, 20)
    num_freq_mask: int = 2
    apply_time_mask: bool = True
    time_mask_width_range: Tuple[int, int] = (0, 100)
    num_time_mask: int = 2
    adaptive: bool = False
    adaptive_number_ratio: float = 0.04
    adaptive_size_ratio: float = 0.04
    max_n_time_masks: int = 20
    replace_with_zero: bool = False


@dataclass(frozen=True)
class TeacherConfig:
    teacher_model: str = "hubert_base_ls960.pt"  # fairseq .pt, or a converted .json
    model_type: str = "hubert"  # 'hubert' | 'wav2vec2' | 'wav2vec_ctc'
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    vocab_size: int = 32  # the CTC head's width of a wav2vec_ctc teacher
    quantize_int8: bool = False


@dataclass(frozen=True)
class ExperimentConfig:
    teacher: TeacherConfig = field(default_factory=TeacherConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    distiller: StudentConfig = field(default_factory=StudentConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    specaug: SpecAugConfig = field(default_factory=SpecAugConfig)


_LOSS_KEYS = {f.name for f in dataclasses.fields(LossConfig)}


def _section(cls, d: Dict[str, Any]):
    """``cls`` from the known keys of a YAML section, lists as tuples where
    the field is a tuple."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in d:
            v = d[f.name]
            kw[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)


def config_from_yaml_dict(raw: Dict[str, Any]) -> ExperimentConfig:
    """A reference-schema dict (teacher / train / distiller / optimizer /
    data / specaug) -> ``ExperimentConfig``, resolved as the JAX package's
    ``config_from_yaml_dict`` (``fithubert_tpu/config.py:390``) resolves it.
    Raises ValueError for a ``distiller:`` key the JAX package does not
    know (``StudentConfig.from_dict``)."""
    raw = dict(raw or {})
    teacher = _section(TeacherConfig, raw.get("teacher") or {})
    train_d = dict(raw.get("train") or {})
    if "gpus" in train_d:
        g = train_d.pop("gpus")
        train_d["num_devices"] = len(g) if isinstance(g, list) else int(g)
    loss = _section(LossConfig, {k: v for k, v in train_d.items() if k in _LOSS_KEYS})
    if "output_dir" in train_d and "/" not in str(train_d["output_dir"]):
        train_d["output_dir"] = "results/pretrain/" + str(train_d["output_dir"])
    train = _section(TrainConfig, train_d)
    distiller_d = raw.get("distiller") or {}
    if loss.distil_random_layer > 0 and not distiller_d.get("layerwise_proj", False):
        raise ValueError("distil_random_layer > 0 requires layerwise_proj: true (random-"
                         "layer distillation gathers per-layer projection heads)")
    distiller = dataclasses.replace(StudentConfig.from_dict(distiller_d, use_fp16=train.use_fp16),
                                    cnn_weight=float(loss.cnn_loss_weight),
                                    teacher_task_agnostic=teacher.model_type != "wav2vec_ctc")
    data = _section(DataConfig, raw.get("data") or {})
    if teacher.model_type == "wav2vec_ctc":
        data = dataclasses.replace(data, load_labels=True)
    cfg = ExperimentConfig(teacher=teacher, train=train, loss=loss, distiller=distiller,
                           optimizer=_section(OptimizerConfig, raw.get("optimizer") or {}),
                           data=data, specaug=_section(SpecAugConfig, raw.get("specaug") or {}))
    return cfg


def load_experiment_yaml(path: str) -> ExperimentConfig:
    """The whole experiment of a reference-schema YAML file
    (``load_yaml_config`` is the expert's reader of the student alone)."""
    return config_from_yaml_dict(read_yaml(path))


def timestamp_tag() -> str:
    """Asia/Seoul run tag, as the reference's ``utils/utils.py:182-184``
    (a fixed UTC+9 offset: Seoul keeps no daylight saving time)."""
    from datetime import datetime, timedelta, timezone

    return datetime.now(timezone(timedelta(hours=9))).strftime("%Y-%m-%d-%H%M%S")


def _yaml_scalar(v: Any) -> str:
    """One value in the YAML subset that JSON is, readable by PyYAML: a
    float keeps a '.' (PyYAML reads '1e-06' as a string)."""
    if isinstance(v, float):
        text = repr(v)
        if "." not in text:
            mant, _, exp = text.partition("e")
            text = f"{mant}.0" + (f"e{exp}" if exp else "")
        return text
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
    return json.dumps(v)


def dump_config(cfg: ExperimentConfig, path: str) -> Dict[str, Dict[str, Any]]:
    """Write ``cfg`` as a reference-schema YAML file, with no YAML library:
    ``section:`` then ``  key: value`` with JSON values. PyYAML and the JAX
    package's ``load_yaml_config`` read it back. The counterpart of
    ``fithubert_tpu/config.py:463 dump_yaml_config``; this file is the
    model-config half of the export pair."""
    sections = {
        "teacher": dataclasses.asdict(cfg.teacher),
        "train": {**dataclasses.asdict(cfg.train), **dataclasses.asdict(cfg.loss)},
        "distiller": cfg.distiller.to_dict(),
        "optimizer": dataclasses.asdict(cfg.optimizer),
        "data": dataclasses.asdict(cfg.data),
        "specaug": dataclasses.asdict(cfg.specaug),
    }
    lines = []
    for name, sect in sections.items():
        lines.append(f"{name}:")
        lines += [f"  {k}: {_yaml_scalar(v)}" for k, v in sect.items()]
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)
    return sections


def fithubert_960h_experiment() -> ExperimentConfig:
    """The whole of ``configs/fithubert.yaml``: a HuBERT-Base teacher,
    random-layer rec-MSE over all 12 layers, AdamW 5e-4 with 5% warmup,
    batch 3 x 4 accumulated, bf16, LibriSpeech 960 h."""
    return ExperimentConfig(
        teacher=TeacherConfig(teacher_model="hubert_base_ls960.pt", model_type="hubert"),
        train=TrainConfig(output_dir="results/pretrain/FitHuBERT-960h", num_epochs=100,
                          num_devices=2, batch_size=3, accumulate_grad_batches=4,
                          use_fp16=True, monitor_losses=True, delete_projections=False,
                          specaug=False),
        loss=LossConfig(cnn_loss_weight=0.0, rec_loss_weight=1.0, rec_loss_type="mse",
                        sim_loss_weight=0.0, attn_loss_weight=0.0, attn_loss_type="kldiv",
                        v_rel_loss_weight=0.0, distil_random_layer=11,
                        random_layer_weight=0.1, use_gt_for_ctc=True),
        distiller=fithubert_960h(),
        optimizer=OptimizerConfig(name="AdamW_with_schedule", lr=5e-4,
                                  warmup_proportion=0.05, betas=(0.9, 0.98), eps=1e-6,
                                  weight_decay=1e-6),
        data=DataConfig(bucketing_path="./data/len_for_bucket", libri_root="../LibriSpeech",
                        train_set=("train-clean-100", "train-clean-360", "train-other-500"),
                        test_set=("test-clean",), dev_set=("dev-clean",),
                        length_quantum=40960),
        specaug=SpecAugConfig(freq_mask_width_range=(0, 27)),
    )


def ex_experiment() -> ExperimentConfig:
    """The whole of ``configs/ex.yaml``: a DistilHuBERT-style student (2
    layers of 768, no time reduction, a SplitLinear head predicting teacher
    layers 3, 7 and 11) distilled from HuBERT-Base by L1 + cosine loss,
    starting from the teacher's conv front-end and first 2 layers; AdamW
    2e-4 with 7% warmup, batch 4 x 2 accumulated, bf16, train-clean-100."""
    return ExperimentConfig(
        teacher=TeacherConfig(teacher_model="hubert_base_ls960.pt", model_type="hubert"),
        train=TrainConfig(output_dir="results/pretrain/ex", num_epochs=100, num_devices=2,
                          batch_size=4, accumulate_grad_batches=2, use_fp16=True,
                          monitor_losses=True, delete_projections=False, specaug=False),
        loss=LossConfig(cnn_loss_weight=0.0, rec_loss_weight=1.0, rec_loss_type="l1",
                        sim_loss_weight=1.0, attn_loss_weight=0.0, attn_loss_type="kldiv",
                        v_rel_loss_weight=0.0, distil_random_layer=0,
                        random_layer_weight=0.0, use_gt_for_ctc=True),
        distiller=StudentConfig(
            extractor_mode="default",
            conv_feature_layers=((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2,
            conv_bias=False, feature_grad_mult=1.0, n_mels=0, enable_log_mel=False,
            mel_spec_head_conv_layers=((128, 7, 1), (256, 5, 1), (512, 5, 1), (512, 5, 1)),
            conv_pos=128, conv_pos_groups=16,
            pos_conv_depth=1, layer_type="transformer", encoder_layers=2,
            depthwise_conv_kernel_size=31, attn_type="", pos_enc_type="abs",
            encoder_embed_dim=768, encoder_ffn_embed_dim=3072, encoder_attention_heads=12,
            activation_fn="gelu", layer_norm_first=False, dropout=0.1,
            attention_dropout=0.1, activation_dropout=0.1, encoder_layerdrop=0.0,
            dropout_input=0.0, pred_head_final_dim=768, pred_head_inter_dim=0,
            pred_layer_id=(3, 7, 11), layerwise_proj=False, init_conv_layers=True,
            init_encoder_layers=2, enable_tr_layer=False, tr_reduce_factor=2,
            tr_layer_type="fc1", tr_layer_index=1, required_seq_len_multiple=2,
            crop_seq_to_multiple=1, compute_dtype="bfloat16"),
        optimizer=OptimizerConfig(name="AdamW_with_schedule", lr=2e-4,
                                  warmup_proportion=0.07, betas=(0.9, 0.98), eps=1e-6,
                                  weight_decay=1e-6),
        data=DataConfig(bucketing_path="./data/len_for_bucket", libri_root="../LibriSpeech",
                        train_set=("train-clean-100",), test_set=("test-clean",),
                        dev_set=("dev-clean",)),
        specaug=SpecAugConfig(),
    )


def conformer_experiment(pos_enc_type: str = "rel_pos") -> ExperimentConfig:
    """``configs/fithubert.yaml`` with conformer layers (``layer_type:
    conformer``, ``attn_type: espnet``): 12 layers of 480, FFN 480, 12 heads
    of 40, depthwise kernel 31, dropout 0.1, bf16. ``rel_pos`` and ``rope``
    build the conformer encoder of its own, which has no TR module, so the
    TR is off there (with it on, the heads would upsample frames that were
    never reduced); ``abs`` puts conformer layers in the transformer
    encoder and keeps the release's TR and positional conv."""
    if pos_enc_type not in ("rel_pos", "rope", "abs"):
        raise ValueError(f"pos_enc_type {pos_enc_type!r}: one of 'rel_pos', 'rope', 'abs'")
    exp = fithubert_960h_experiment()
    distiller = dataclasses.replace(exp.distiller, layer_type="conformer", attn_type="espnet",
                                    pos_enc_type=pos_enc_type)
    if pos_enc_type != "abs":
        distiller = dataclasses.replace(distiller, enable_tr_layer=False)
    return dataclasses.replace(exp, distiller=distiller)


def mel_experiment() -> ExperimentConfig:
    """``configs/fithubert.yaml`` with the log-mel front-end: 80 mels (the
    file leaves ``n_mels`` at 0; 80 is the common log-mel width), its
    ``mel_spec_head_conv_layers``, and ``train.specaug: true`` with its
    ``specaug:`` section (2 frequency masks of width [0, 27), 2 time masks
    of [0, 100), no time warp, masked values replaced by the batch mean)."""
    exp = fithubert_960h_experiment()
    return dataclasses.replace(
        exp, train=dataclasses.replace(exp.train, specaug=True),
        distiller=dataclasses.replace(exp.distiller, n_mels=80, enable_log_mel=True))
