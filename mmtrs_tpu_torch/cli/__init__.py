"""Command-line entry points of the port, run as ``python -m
mmtrs_tpu_torch.cli.<name>``: ``run_pipeline``, ``run_augment_records``,
``run_fusion`` and ``run_train_images``, the twins of the repository's
scripts of those names."""
