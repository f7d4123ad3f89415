"""Command-line entry points of the port, run as ``python -m
mmtrs_tpu_torch.cli.<name>``: ``run_pipeline``, the twin of the repository's
``run_pipeline.py``."""
