"""The benchmark of ``vdiff_tpu_torch`` (``python portbench/run.py --help``)."""
