"""mmtrs_tpu_torch — the PyTorch + CUDA port of ``mmtrs_tpu`` for one NVIDIA H100.

The JAX package beside it stays the reference. This package keeps its
module names and public layouts (NHWC ``[B, H, W, 3]`` images, boxes
``(y0, x0, y1, x1)``) so each module has an obvious counterpart, and uses
PyTorch idiom inside: ``nn.Module``s, plain tensor functions, an explicit
``device`` and explicit ``torch.Generator``s.

Every TPU kernel on the ported paths is a hand-written CUDA kernel for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first use (``_build.py``)
and wrapped in ``ops/kernels/``. A wrapper runs its kernel's plain PyTorch
version only for a CPU tensor; for a CUDA tensor it launches the kernel or
raises.

Slice 1 (the serving path): preprocessing (CLAHE on LAB L, deskew, saliency
crop) and the MIL EfficientNet-B0 stream behind ``serve.service.PredictService``.
Slice 2 (the augmentation chain): ``preprocess.preprocess_augment_batch`` and
``ops.augment.augment_batch`` with the ``legacy`` preset, its randomness
drawn on the host per lineage (``ops.augment.draw_legacy``).
Slice 3 (the other presets and the table builder's device loop):
``augment_batch`` with ``ten``, ``simple`` and ``randaug``, and
``data.records.augment_children``.
Slice 4 (CLAHE on the L plane): the JAX package's second CLAHE route, which
phone-shaped uploads and native-resolution archives take, and the archive
pass ``preprocess.preprocess_stream``.
Slice 10 (the full ensemble): the MM dual-head stream, the tabular GBDT
stream and the LR Stacker, wired from a weights folder of npz checkpoints
by ``serve.ensembles.build_service_from_weights``.
Slice 11 (the entry points and their codec): ``utils/codec.py``, JPEG and
PNG without Pillow (nvJPEG on the card, the system libjpeg on the CPU,
host C in ``csrc/host/``), ``utils/images.py`` and two user entry points:

    python -m mmtrs_tpu_torch.serve.app --weights <dir>      # the HTTP app
    python -m mmtrs_tpu_torch.cli.run_pipeline --input_dir <in> --output_dir <out>

Slice 12 (MM training): the pandas-free lineage table
(``utils.table.Table``, ``data.records.build_augmented_table``, the CLI
twin ``python -m mmtrs_tpu_torch.cli.run_augment_records``) and
``train.mm.run_mm_kfold``: the MM dual-head trained k-fold (train-mode
BatchNorm, dropout and drop-path in ``models/``, optax's AdamW chain in
``train.common``, on-line ``randaug``), writing npz fold checkpoints that
``build_service_from_weights`` serves.

Slice 13 (MIL, Tab and the stack trained): ``train.mil``, ``train.tabular``,
``models.gbdt.train_gbdt``, ``fusion.stack`` and the fusion CLI twin.
Slice 14 (the vision streams trained): ConvNeXt/ConvNeXtV2 in the factory,
``train.vision.VisionTrainer`` behind ``cli.run_train_images``,
``train.progressive``, ``train.kfold``, ``eval.threshold_sweep``,
``fusion.streams.collect_base_preds`` and ``train.mm.finalize_mm_from_ckpts``.

The entry points run on the card unless the caller passes ``device="cpu"``
(``device.resolve_device``).

It imports ``torch`` and never ``jax``, and nothing of ``mmtrs_tpu``: the
small jax-free pieces it shares with it (``config.PreprocessConfig``,
``config.MMJointConfig``, ``serve/choices.py``, the vision configs) are copies, held equal to
the originals by the tests.
"""

__version__ = "0.1.0"
