"""repro_torch: the GeoLayer store on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` with the same module layout
(``repro_torch.core.routing`` mirrors ``repro.core.routing``).  Host logic
stays numpy; device work runs as PyTorch tensors, and the kernels the JAX
package wrote in Pallas are CUDA C++ under ``csrc/``, built with ``nvcc`` at
first use.  Importing the package never needs CUDA: submodules import
lazily, and the kernels build only when a wrapper launches one.
"""
from .device import default_device, on_cuda, resolve_device  # noqa: F401

__all__ = ["default_device", "on_cuda", "resolve_device"]
