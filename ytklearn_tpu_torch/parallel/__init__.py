"""Multi-device runs on torch.distributed (``ytklearn_tpu/parallel/``):
ranks and their row shards (mesh.py), the collective verbs
(collectives.py)."""

from .mesh import (
    DATA_AXIS,
    Mesh,
    distributed_initialize_if_needed,
    equal_row_target,
    make_mesh,
    pad_rows_to_multiple,
    put_col_sharded,
    put_row_sharded,
)
from . import collectives

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "collectives",
    "distributed_initialize_if_needed",
    "equal_row_target",
    "make_mesh",
    "pad_rows_to_multiple",
    "put_col_sharded",
    "put_row_sharded",
]
