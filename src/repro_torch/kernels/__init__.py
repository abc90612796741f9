"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``ref`` holds the plain versions; ``dhd_spmv`` and ``route_expand`` the
kernel wrappers (sources in ``repro_torch/csrc/``, built by ``cuda_lib`` at
the first launch); ``ops`` the dispatch the store calls.  Nothing is
imported here, so importing the package neither needs CUDA nor builds.
"""
