"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points run on the card unless the caller asks for the CPU, its
kernel modules import without a CUDA toolkit, and each CUDA source says
which TPU kernel it replaces."""

import ast
import os

import pytest
import torch

import fithubert_tpu_torch
from fithubert_tpu_torch.config import fithubert_960h
from fithubert_tpu_torch.device import resolve_device
from fithubert_tpu_torch.export.expert import UpstreamExpert
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.ops.kernels import SOURCES, _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(fithubert_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "fithubert_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "train_torch.py")]
    for d, _dirs, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_scan_covers_every_module_of_the_package():
    """The import rules below read every module of the package, the
    conformer, mel and SpecAugment modules among them."""
    files = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("ops/conformer.py", "ops/mel.py", "ops/specaug.py", "ops/attention.py",
                 "models/student.py", "train/step.py"):
        assert name in files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{os.path.relpath(path, ROOT)} imports {mod}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_yaml_only_inside_a_function(path):
    """The port imports where yaml is not installed: a module may import it
    only inside the one function that reads a file, never when it is
    imported."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert not any(n.split(".")[0] == "yaml" for n in names), path


def test_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = fithubert_960h()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StudentModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UpstreamExpert({}, cfg)
    assert resolve_device("cpu").type == "cpu"
    assert next(StudentModel(cfg, device="cpu").parameters()).device.type == "cpu"


def test_loop_and_teacher_checkpoints_need_the_card_unless_cpu_is_asked(monkeypatch,
                                                                       tmp_path):
    """run_training, and a teacher built from a fairseq checkpoint, raise
    without a card before they write anything, unless device='cpu'."""
    from fithubert_tpu_torch.config import ExperimentConfig, TrainConfig
    from fithubert_tpu_torch.export.fairseq_import import load_fairseq_teacher
    from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
    from fithubert_tpu_torch.train.loop import run_training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "run"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(ExperimentConfig(train=TrainConfig(output_dir=str(out))))
    assert not out.exists()
    geom = TeacherGeometry(conv_feature_layers=((32, 10, 5), (48, 3, 2)), encoder_layers=1,
                           encoder_embed_dim=64, encoder_ffn_embed_dim=64,
                           encoder_attention_heads=1, conv_pos=16, conv_pos_groups=4)
    sd = TeacherModel(geom, device="cpu").init_weights(torch.Generator().manual_seed(0))
    torch.save({"model": {**sd.state_dict(), "label_embs_concat": torch.zeros(2, 64)},
                "cfg": {"model": {"encoder_attention_heads": 1}}}, tmp_path / "t.pt")
    loaded, state = load_fairseq_teacher(str(tmp_path / "t.pt"))
    assert loaded == geom and all(v.device.type == "cpu" for v in state.values())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TeacherModel(loaded)
    TeacherModel(loaded, device="cpu").load_state_dict(state)


def test_data_parallel_and_export_entry_points_need_the_card_unless_cpu_is_asked(
        monkeypatch, tmp_path):
    """maybe_initialize, the torch.hub entry and extract_features raise
    without a card, before they write anything, unless device='cpu'."""
    from fithubert_tpu_torch import hubconf
    from fithubert_tpu_torch.export import extract_features
    from fithubert_tpu_torch.parallel.distributed import maybe_initialize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = fithubert_960h()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        maybe_initialize()
    assert maybe_initialize("cpu")[2].type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hubconf.fithubert({"w": torch.zeros(1)}, cfg)
    out = tmp_path / "feats"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_features.main(["--ckpt", "student.pt", "--config", "student.yaml", "--inputs",
                               "a.flac", "--out", str(out)])
    assert not out.exists()


def test_the_scan_covers_the_modules_of_this_slice():
    scanned = {os.path.relpath(p, PKG) for p in _port_files()}
    assert {"hubconf.py", "parallel/distributed.py", "export/reference_import.py",
            "export/extract_features.py"} <= scanned


def test_kernel_modules_import_and_build_raises_without_nvcc(monkeypatch, tmp_path):
    import importlib

    for name in ("_build", "conv_frontend", "dropout", "flash_attention", "philox"):
        importlib.import_module(f"fithubert_tpu_torch.ops.kernels.{name}")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))
    _build.load.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("conv_frontend")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(SOURCES)
    assert not (tmp_path / "build").exists()  # nothing half-built is left behind
    _build.load.cache_clear()


@pytest.mark.parametrize("name", SOURCES)
def test_cuda_source_notes_what_it_replaces(name):
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        head = f.read(3000)
    assert "Replaces: fithubert_tpu/ops/pallas/" in head
    assert "Bound on the H100:" in head and "Design:" in head
    assert 'extern "C"' in open(os.path.join(_build.CSRC, f"{name}.cu")).read()


def test_build_path_is_keyed_on_the_source(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("int a;")
    monkeypatch.setattr(_build, "CSRC", str(src))
    first = _build._lib_path("k")
    (src / "k.cu").write_text("int b;")
    assert _build._lib_path("k") != first
    assert os.path.basename(first) == "libk.so"


def test_ptxas_report_gives_each_kernels_registers_and_spills():
    """The ``-Xptxas -v`` lines of entry functions in an anonymous namespace
    whose hash ends in digits, one of them a template, and at global scope."""
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__68b50a81_16_conv_frontend_cu_ec84f43916conv_layer_wgmmaE14CUtensorMap_stS0_i' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__68b50a81_16_conv_frontend_cu_ec84f43916conv_layer_wgmmaE14CUtensorMap_stS0_i
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 2 barriers, 128 bytes smem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__68b50a81_16_conv_frontend_cu_ec84f43916conv_layer_wgmmaILb1EEEv14CUtensorMap_stS0_i' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 92 registers, used 2 barriers, 128 bytes smem
ptxas info    : Compiling entry function '_Z13bwd_dw_reducePKfPfxi' for 'sm_90a'
ptxas info    : Function properties for _Z13bwd_dw_reducePKfPfxi
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers
"""
    assert _build.parse_ptxas(log) == [("conv_layer_wgmma", 90, 0, 0),
                                       ("conv_layer_wgmma<1>", 92, 0, 0),
                                       ("bwd_dw_reduce", 255, 12, 16)]
