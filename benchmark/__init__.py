"""The H100 benchmark of ``realtime_yukarin_tpu_torch``: a data-driven
harness (``run.py``), its cells' configurations, traffic mixes, drivers and
per-layer metric readers, and a plain reference that decides ``correct``."""
