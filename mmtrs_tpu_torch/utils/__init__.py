"""Utilities (port of mmtrs_tpu/utils/): the counterpart of each name in
the JAX package's ``mmtrs_tpu.utils.__all__``; its ``key_for_origin`` and
``split_keys`` (JAX PRNG keys) are the port's ``generator_for_origin`` and
``generators_for_batch`` (torch generators from the same lineage seed)."""

from mmtrs_tpu_torch.utils.io import ensure_dir, load_json, read_table, save_json, timestamp, write_table
from mmtrs_tpu_torch.utils.rng import generator_for_origin, generators_for_batch

__all__ = [
    "ensure_dir",
    "save_json",
    "load_json",
    "timestamp",
    "read_table",
    "write_table",
    "generator_for_origin",
    "generators_for_batch",
]
