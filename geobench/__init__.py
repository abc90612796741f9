"""The benchmark of the PyTorch/CUDA port of GeoLayer (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; ``sweep.py`` finds a
configuration's knee (of reads alone); ``control.py`` reads the control of
the check; ``catalog.py`` follows the read patterns through a mix's
inserts, which ``reference/replay.py`` replays for the check.
"""
