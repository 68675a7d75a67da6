"""Data, tensor and sequence parallelism on ``torch.distributed``, one
process per rank (counterpart of ``multimodal_embedding_tpu/parallel``)."""

from .batched import pad_to_multiple, sharded_batch_apply
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, gather_rows, get_mesh, shard_rows

__all__ = [
    "get_mesh",
    "Mesh",
    "shard_rows",
    "gather_rows",
    "DATA_AXIS",
    "MODEL_AXIS",
    "sharded_batch_apply",
    "pad_to_multiple",
]
