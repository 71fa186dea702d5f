"""Tolerant loading of torch checkpoints without fairseq/omegaconf installed
(a copy of ``fithubert_tpu/export/torch_pickle.py``).

fairseq checkpoints (reference utils/utils.py:104 load_checkpoint_to_cpu)
pickle omegaconf DictConfig objects and fairseq dataclasses alongside the
tensor state dict. Without fairseq and omegaconf installed, unpickling would
fail on the missing classes, so import-time stubs are installed whose
instances just record their pickled state, and that state is then turned
into plain Python containers.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.machinery
import sys
import types
from typing import Any, Dict


class StubObject:
    """Absorbs any pickled construction/state without the real class."""

    def __init__(self, *args, **kwargs):
        self._stub_args = args
        self._stub_kwargs = kwargs
        self._stub_state: Any = None

    def __setstate__(self, state):
        self._stub_state = state
        if isinstance(state, dict):
            self.__dict__.update(state)

    def __call__(self, *args, **kwargs):  # classmethods pickled as callables
        return StubObject(*args, **kwargs)

    def __repr__(self):
        return f"StubObject(state={type(self._stub_state).__name__})"


class _StubModule(types.ModuleType):
    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        cls = type(name, (StubObject,), {"__module__": self.__name__})
        setattr(self, name, cls)
        return cls


_STUB_ROOTS = ("omegaconf", "fairseq", "hydra", "pytorch_lightning", "lightning")


class _StubFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in _STUB_ROOTS:
            # is_package: real checkpoints reference SUBmodule classes
            # (omegaconf.dictconfig.DictConfig, omegaconf.nodes.AnyNode...);
            # without a package spec the child import dies with
            # "'omegaconf' is not a package" before the stub ever loads
            return importlib.machinery.ModuleSpec(
                fullname, self, is_package=True
            )
        return None

    def create_module(self, spec):
        return _StubModule(spec.name)

    def exec_module(self, module):
        pass


_finder = _StubFinder()


def tolerant_torch_load(path: str) -> Dict[str, Any]:
    """torch.load that stubs out fairseq/omegaconf/lightning classes."""
    import torch

    installed = False
    if not any(isinstance(f, _StubFinder) for f in sys.meta_path):
        sys.meta_path.insert(0, _finder)
        installed = True
    before = set(sys.modules)
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    finally:
        if installed:
            sys.meta_path.remove(_finder)
        # drop any stub modules the unpickle imported: leaving them in
        # sys.modules would permanently shadow later REAL imports of e.g.
        # omegaconf/lightning with attribute-fabricating stubs
        for name in set(sys.modules) - before:
            if isinstance(sys.modules.get(name), _StubModule):
                del sys.modules[name]


def unstub(obj: Any) -> Any:
    """Recursively convert stubbed omegaconf/dataclass objects to plain data.

    omegaconf containers pickle with `_content` (dict/list of value nodes);
    value nodes carry `_val`. argparse.Namespace and fairseq dataclasses end
    up as attribute dicts.
    """
    import argparse

    if isinstance(obj, StubObject):
        state = obj.__dict__
        if "_content" in state:
            return unstub(state["_content"])
        if "_val" in state:
            return unstub(state["_val"])
        if isinstance(obj._stub_state, dict):
            return {
                k: unstub(v)
                for k, v in obj._stub_state.items()
                if not k.startswith("_stub")
            }
        return None
    if isinstance(obj, argparse.Namespace):
        return {k: unstub(v) for k, v in vars(obj).items()}
    if isinstance(obj, dict):
        return {k: unstub(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [unstub(v) for v in obj]
    return obj
