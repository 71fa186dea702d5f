"""Nothing under benchmark/ imports JAX, the JAX package, bench.py or
chip_smoke.py (top-level names compared whole: the port's name begins
with the JAX package's), and the reference imports nothing of the port."""

import ast
import glob
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "fithubert_tpu", "bench", "chip_smoke"}
MODULES = sorted(glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True))


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", MODULES, ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN
    # no path into the JAX package's folder, and neither of its scripts
    for const in strings(path):
        assert "fithubert_tpu" + "/" not in const
        assert not const.endswith(("bench" + ".py", "chip_smoke" + ".py"))


def strings(path):
    """The string constants of a module but its docstrings."""
    tree = ast.parse(open(path).read(), path)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(HERE, "reference", "*.py"))),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    assert "fithubert_tpu_torch" not in imported_tops(path)
    assert "fithubert_tpu_torch" not in open(path).read()
    assert {"benchmark"} & imported_tops(path) == set()  # only its own package, relatively


def test_the_check_sees_whole_names():
    src = "import fithubert_tpu_torch.ops\nfrom fithubert_tpu import x\n"
    tree = ast.parse(src)
    tops = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import) else n.module.split(".")[0]
            for n in tree.body}
    assert tops & FORBIDDEN == {"fithubert_tpu"}
