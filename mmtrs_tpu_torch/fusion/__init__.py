"""Late fusion (port of mmtrs_tpu/fusion/: the final stack, the tabular
stack, the L1 meta-stacker, the simplex weight search, the generic fusion
trainer and its inference recipe, and ``streams.py``, the vision streams'
exporter): the counterpart of each name in the JAX package's
``mmtrs_tpu.fusion.__all__``."""

from mmtrs_tpu_torch.fusion.weight_search import blended_prob, grid_simplex, search_weights
from mmtrs_tpu_torch.fusion.meta import MetaStacker
from mmtrs_tpu_torch.fusion.stack import fit_tab_oof, run_final_stack, run_tabular_stack
from mmtrs_tpu_torch.fusion.fuse import fit_fusion
from mmtrs_tpu_torch.fusion.infer import fuse_streams, load_recipe

__all__ = [
    "grid_simplex",
    "blended_prob",
    "search_weights",
    "MetaStacker",
    "fit_tab_oof",
    "run_final_stack",
    "run_tabular_stack",
    "fit_fusion",
    "load_recipe",
    "fuse_streams",
]
