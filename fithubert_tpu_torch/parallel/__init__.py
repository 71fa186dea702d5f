"""Data and tensor parallelism over torch.distributed: ``distributed``
(ranks, ``launch``, ``DataParallel``) and ``mesh`` (the ('data', 'model')
grid, ``TP_RULES``, the model axis's collectives)."""

from fithubert_tpu_torch.parallel.distributed import (  # noqa: F401
    DataParallel,
    launch,
    maybe_initialize,
)
from fithubert_tpu_torch.parallel.mesh import (  # noqa: F401
    TP_RULES,
    Mesh,
    ModelParallel,
    make_mesh,
    shard_,
    shard_plan,
)
