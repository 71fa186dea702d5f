"""The ('data', 'model') mesh over ``torch.distributed``
(``fithubert_tpu/parallel/mesh.py``): data parallelism on the 'data' axis,
tensor parallelism on the 'model' axis.

    rank, world, dev = maybe_initialize("cuda")   # torchrun's environment
    mesh = make_mesh(model_axis=2)                # on every rank, in one order
    d = Distiller(cfg, teacher_state, student_state, device=dev, mesh=mesh)

The ranks form a (world / model_axis, model_axis) grid, row-major, as
``make_mesh`` lays out the devices (``mesh.py:23-34``): rank r is data index
r // model_axis and model index r % model_axis. The ranks of a row share one
stripe of the global batch and hold the shards of one model; the ranks of
a column hold the same shards and take their stripes. ``Mesh.dp`` is a
``DataParallel`` over this rank's column (None when the data axis is 1),
``Mesh.tp`` a ``ModelParallel`` over its row (None when the model axis is
1), ``Mesh.world`` a ``DataParallel`` over every rank.

The weights are sharded in Megatron's layout, by ``TP_RULES`` (JAX's
``_TP_RULES``, ``mesh.py:47-59``, under the port's module names):

  - column-parallel (weight and bias on the output dim): ``q_proj``,
    ``k_proj``, ``v_proj`` (espnet ``linear_q``, ``linear_k``,
    ``linear_v``), ``fc1``, ``w_1`` and ``proj_head.0`` (JAX's
    ``proj_head_in``); the layer reads ``copy_to_model(x)``;
  - row-parallel (weight on the input dim, bias replicated): ``out_proj``
    (espnet ``linear_out``), ``fc2`` and ``w_2``; the layer sums its
    partial products with ``reduce_from_model`` and then adds its bias once.

An int8 layer's payload is sliced with its weight, from the full weight's
quantization; a column-parallel layer's per-channel scale follows its
output dim and a row-parallel one's stays whole (``ops/quant.py``). A layer
is sharded only where JAX's ``param_sharding`` shards it (its sharded dim
divides the model axis) and, besides, an attention only where its heads
divide the model axis (as JAX's kernel path, ``flash_attention.py:458-461``;
otherwise the whole attention stays replicated, where JAX shards its
weights and lets XLA regather them). The time-reduction Linears (JAX's
``fc`` / ``fc_a`` / ``fc_b``) match no rule. Everything else is replicated.

``copy_to_model``, ``reduce_from_model`` and ``gather_from_model``
(``ModelParallel.copy``, ``.reduce``, ``.gather``) are the axis's
collectives inside autograd, built on ``all_reduce`` and ``all_gather``
only, which gloo runs on CUDA tensors too. A float sum runs in fp32 and is
cast back to the tensor's dtype once.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from fithubert_tpu_torch.parallel.distributed import DataParallel

COLUMN, ROW = "column", "row"

# (pattern over a module's full name, its layout); the layer must be an
# nn.Linear (the layer-wise heads' ``proj_head.0`` is not)
TP_RULES: Tuple[Tuple[str, str], ...] = (
    (r"(.*\.)?(q_proj|k_proj|v_proj|linear_q|linear_k|linear_v|fc1|w_1)", COLUMN),
    (r"proj_head\.0", COLUMN),
    (r"(.*\.)?(out_proj|linear_out|fc2|w_2)", ROW),
)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, as a new tensor: floats in fp32, then
    cast back to x's dtype; integers exactly."""
    acc = torch.float32 if x.is_floating_point() else x.dtype
    out = torch.empty(x.shape, dtype=acc, device=x.device)
    out.copy_(x)
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.tp.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _sum(x, tp.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.local(grad, ctx.dim).contiguous(), None, None


@dataclass(frozen=True)
class ModelParallel:
    """The 'model' axis of one mesh row: this rank's index ``rank`` of
    ``size``, over the row's process ``group``."""

    rank: int
    size: int
    group: Any = None

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """copy_to_model: ``x`` unchanged; its gradient summed over the row."""
        return _CopyToModel.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """reduce_from_model: ``x`` summed over the row; the gradient passes."""
        return _ReduceFromModel.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """gather_from_model: the row's ``x`` concatenated on ``dim`` in
        rank order; the gradient of this rank's slice comes back."""
        return _GatherFromModel.apply(x, self, dim)

    def local(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's 1/size of ``x`` on ``dim`` (a view)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The row's ``x`` concatenated on ``dim``, outside autograd."""
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the row, outside autograd (exact for integers)."""
        return _sum(x.detach(), self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``x`` over the row, outside autograd."""
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the ('data', 'model') grid of ``data`` x
    ``model`` ranks, and the collectives of its column (``dp``), its row
    (``tp``) and every rank (``world``)."""

    rank: int
    data: int
    model: int
    dp: Optional[DataParallel]
    tp: Optional[ModelParallel]
    world: DataParallel

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def backend(self) -> str:
        return self.world.backend


def make_mesh(num_devices: int = 0, model_axis: int = 1) -> Mesh:
    """The mesh over the initialised default process group, whose ranks it
    must cover (``num_devices`` 0 or the world size); without one, a
    one-rank mesh. Every rank calls it, in the same order: it makes one
    process group per row and one per column (``new_group`` on every
    rank)."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    if num_devices and num_devices != world:
        raise ValueError(f"a mesh of {num_devices} ranks over a process group of {world}")
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide {world} ranks")
    if model_axis > 1 and not dist.is_initialized():
        raise ValueError("a model axis above 1 needs an initialised process group")
    data = world // model_axis
    rows = [list(range(r * model_axis, (r + 1) * model_axis)) for r in range(data)]
    cols = [list(range(c, world, model_axis)) for c in range(model_axis)]
    tp = dp = None
    if model_axis > 1:
        for ranks in rows:  # every rank makes every group, in one order
            group = dist.new_group(ranks)
            if rank in ranks:
                tp = ModelParallel(ranks.index(rank), model_axis, group)
    if data > 1:
        for ranks in cols:
            group = dist.new_group(ranks) if model_axis > 1 else None
            if rank in ranks:
                dp = DataParallel(ranks.index(rank), data, group)
    return Mesh(rank, data, model_axis, dp, tp, DataParallel(rank, world))


# ------------------------------------------------------------------ sharding
def shard_plan(model: nn.Module, size: int) -> Dict[str, str]:
    """{module name: COLUMN or ROW} of the Linears of ``model`` that a model
    axis of ``size`` shards: those ``TP_RULES`` name whose sharded dim
    divides ``size``, and of an attention's projections only those whose
    attention's heads divide it."""
    if size <= 1:
        return {}
    modules = dict(model.named_modules())
    plan = {}
    for name, mod in modules.items():
        kind = next((k for pattern, k in TP_RULES if re.fullmatch(pattern, name)), None)
        if kind is None or not isinstance(mod, nn.Linear):
            continue
        if (mod.out_features if kind == COLUMN else mod.in_features) % size:
            continue
        parent = modules.get(name.rpartition(".")[0])
        if getattr(parent, "num_heads", None) is not None and parent.num_heads % size:
            continue
        plan[name] = kind
    return plan


def shard_dims(model: nn.Module, size: int) -> Dict[str, int]:
    """{state-dict key: the dim it is sharded on} under ``shard_plan``:
    the one-process keys, with the int8 payload (``weight_q``) and a
    column-parallel layer's ``weight_scale`` beside their weight."""
    dims = {}
    for name, kind in shard_plan(model, size).items():
        layer = model.get_submodule(name)
        for attr, dim in (("weight", 0 if kind == COLUMN else 1),
                          ("bias", 0 if kind == COLUMN else None),
                          ("weight_q", 0 if kind == COLUMN else 1),
                          ("weight_scale", 0 if kind == COLUMN else None)):
            if dim is not None and getattr(layer, attr, None) is not None:
                dims[f"{name}.{attr}"] = dim
    return dims


@torch.no_grad()
def shard_(model: nn.Module, tp: Optional[ModelParallel]) -> Dict[str, int]:
    """Keep this rank's slices of the sharded parameters (and int8
    payloads) of ``model``, mark each sharded Linear with its layout
    (``tp_mode``) and the axis (``tp``), and each attention whose
    projections are sharded with ``tp``. Returns ``shard_dims`` of the
    parameters: what ``gather_state`` / ``local_state`` map. An int8 layer
    must be prequantized first (``ops/quant.py prequantize_``): a
    row-parallel scale is the whole input's."""
    if tp is None:
        return {}
    dims = shard_dims(model, tp.size)
    for name, kind in shard_plan(model, tp.size).items():
        layer = model.get_submodule(name)
        if getattr(layer, "quantize", False) and getattr(layer, "weight_q", None) is None:
            raise ValueError(f"{name}: an int8 layer is sharded after prequantize_")
        dim = 0 if kind == COLUMN else 1
        layer.weight = nn.Parameter(tp.local(layer.weight, dim).clone(),
                                    requires_grad=layer.weight.requires_grad)
        if kind == COLUMN and layer.bias is not None:
            layer.bias = nn.Parameter(tp.local(layer.bias, 0).clone(),
                                      requires_grad=layer.bias.requires_grad)
        if getattr(layer, "weight_q", None) is not None:
            layer.weight_q = tp.local(layer.weight_q, dim).clone()
            if kind == COLUMN:
                layer.weight_scale = tp.local(layer.weight_scale, 0).clone()
        layer.tp, layer.tp_mode = tp, kind
        parent = model.get_submodule(name.rpartition(".")[0]) if "." in name else model
        if getattr(parent, "num_heads", None) is not None:
            parent.tp = tp
    params = {n for n, _ in model.named_parameters()}
    return {k: d for k, d in dims.items() if k in params}


def gather_state(state: Mapping[str, torch.Tensor], dims: Dict[str, int],
                 tp: Optional[ModelParallel]) -> Mapping[str, torch.Tensor]:
    """A sharded model's state dict with one process's keys and shapes:
    each key of ``dims`` gathered over the row on its dim (``state`` itself
    without a model axis)."""
    if tp is None:
        return state
    return {k: tp.all_gather(v, dims[k]) if k in dims else v for k, v in state.items()}


def local_state(state: Mapping[str, torch.Tensor], dims: Dict[str, int],
                tp: Optional[ModelParallel]) -> Mapping[str, torch.Tensor]:
    """One process's state dict cut to this rank's slices of ``dims``
    (``state`` itself without a model axis)."""
    if tp is None:
        return state
    return {k: tp.local(v, dims[k]).clone() if k in dims else v for k, v in state.items()}


def global_norm(tensors: Sequence[torch.Tensor], sharded: Sequence[bool],
                tp: Optional[ModelParallel]) -> torch.Tensor:
    """The 2-norm of the logical tensors (optax ``global_norm``): the
    squares of the sharded ones summed over the row, the replicated ones
    counted once."""
    if tp is None:
        return torch.nn.utils.get_total_norm(list(tensors))
    norms = torch._foreach_norm(list(tensors))
    zero = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    sq_sh = sum((n.float() ** 2 for n, s in zip(norms, sharded) if s), zero)
    sq_rep = sum((n.float() ** 2 for n, s in zip(norms, sharded) if not s), zero)
    return torch.sqrt(tp.sum(sq_sh) + sq_rep)
