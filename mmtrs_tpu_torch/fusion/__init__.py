"""Late fusion (port of mmtrs_tpu/fusion/: the final stack, the tabular
stack, the L1 meta-stacker, the simplex weight search, the generic fusion
trainer and its inference recipe). ``streams.py`` (the vision streams'
exporter) comes with the vision trainer."""
