"""Offline data preparation, host only: the pronunciation table, MUSDB
mixing, dataset path rewriting and vocal separation (the port's own copies
of ``lyricalignment_tpu/prep/``)."""
