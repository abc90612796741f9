"""Arch registry of the port: ``get_arch(name)`` / ``list_archs()`` /
``all_cells()``.

Lists every arch of the JAX package: the five LM archs, BST and the four
GNNs, each an :class:`LMArch`, :class:`RecsysArch` or :class:`GNNArch` of
:mod:`.base` (the port of ``configs/base.py``: shape cells, abstract state
and inputs for the dry run, step functions and the smoke-training pieces),
re-exported here with :func:`make_train_step`, :func:`pad_to`,
:class:`GNNShape` and the shape tables.
"""
from __future__ import annotations

import importlib
from typing import List, Union

from .base import (  # noqa: F401
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    Cell,
    GNNArch,
    GNNShape,
    LMArch,
    LMShape,
    RecsysArch,
    RecsysShape,
    make_train_step,
    pad_to,
)

__all__ = [
    "Cell",
    "GNNArch",
    "GNNShape",
    "GNN_SHAPES",
    "LMArch",
    "LMShape",
    "LM_SHAPES",
    "RECSYS_SHAPES",
    "RecsysArch",
    "RecsysShape",
    "all_cells",
    "get_arch",
    "list_archs",
    "make_train_step",
    "pad_to",
]

_MODULES = (
    "deepseek_v2_lite_16b",
    "granite_moe_3b_a800m",
    "yi_6b",
    "gemma3_27b",
    "qwen3_0_6b",
    "egnn",
    "meshgraphnet",
    "equiformer_v2",
    "schnet",
    "bst",
)


def _archs() -> dict:
    mods = (importlib.import_module(f".{m}", __package__) for m in _MODULES)
    return {mod.ARCH.name: mod.ARCH for mod in mods}


def get_arch(name: str) -> Union[LMArch, RecsysArch, GNNArch]:
    archs = _archs()
    if name not in archs:
        raise KeyError(f"unknown or unported arch {name!r}; ported: {sorted(archs)}")
    return archs[name]


def list_archs() -> List[str]:
    return sorted(_archs())


def all_cells() -> List[Cell]:
    """Every arch's cells, archs in name order (the reference's order)."""
    archs = _archs()
    return [c for name in sorted(archs) for c in archs[name].cells()]
