"""The benchmark of the PyTorch/CUDA port of GeoLayer (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; ``sweep.py`` finds a
configuration's knee; ``control.py`` reads the control of the check.
"""
