"""Data parallelism over ``torch.distributed`` (port of mmtrs_tpu/parallel):
``make_group`` for JAX's ``make_mesh``, ``all_reduce_grads_`` with the
trainers' ``group=`` for ``data_parallel_jit``, and ``data_parallel_eval``
for ``data_parallel_eval_jit``."""

from mmtrs_tpu_torch.parallel.mesh import (
    DataGroup,
    all_reduce_grads_,
    data_parallel_eval,
    make_group,
    pad_to_multiple,
    replicate,
    shard_batch,
)

__all__ = [
    "DataGroup",
    "make_group",
    "shard_batch",
    "replicate",
    "all_reduce_grads_",
    "data_parallel_eval",
    "pad_to_multiple",
]
