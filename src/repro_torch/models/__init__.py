"""LM model zoo of the port: layers, MLA attention, MoE and the decoder.

Params are nested dicts of tensors with the JAX package's tree layout
(per-layer params stacked on a leading ``[L, ...]`` axis).  Submodules are
imported by name; nothing is imported here.
"""
