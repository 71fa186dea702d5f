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
    files = [os.path.join(ROOT, "chip_smoke.py")]
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


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{os.path.relpath(path, ROOT)} imports {mod}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_yaml_only_inside_a_function(path):
    """The card's machine has no yaml: a module may import it only inside
    the one function that reads a file, never when it is imported."""
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
        UpstreamExpert(cfg, {})
    assert resolve_device("cpu").type == "cpu"
    assert next(StudentModel(cfg, device="cpu").parameters()).device.type == "cpu"


def test_kernel_modules_import_and_build_raises_without_nvcc(monkeypatch, tmp_path):
    import importlib

    for name in ("_build", "conv_frontend", "flash_attention"):
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
