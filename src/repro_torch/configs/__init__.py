"""Arch registry of the port: ``get_arch(name)`` / ``list_archs()``.

Lists the archs the port runs: the five LM archs and BST (the GNNs wait
for ROADMAP.md slice F).  An arch is a minimal :class:`LMArch` (name, full
config, smoke config, family ``"lm"``) or :class:`RecsysArch` (name, spec,
smoke spec, family ``"recsys"``); none of the JAX package's dry-run
machinery (shape cells, abstract inputs, sharding specs) is carried over.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Union

from ..models.recsys.bst import BSTSpec
from ..models.transformer import LMConfig

__all__ = ["LMArch", "RecsysArch", "get_arch", "list_archs"]

_MODULES = (
    "deepseek_v2_lite_16b",
    "granite_moe_3b_a800m",
    "yi_6b",
    "gemma3_27b",
    "qwen3_0_6b",
    "bst",
)


@dataclasses.dataclass(frozen=True)
class LMArch:
    name: str
    cfg: LMConfig
    smoke_cfg: LMConfig
    family: str = "lm"


@dataclasses.dataclass(frozen=True)
class RecsysArch:
    name: str
    spec: BSTSpec
    smoke_spec: BSTSpec
    family: str = "recsys"


def _archs() -> dict:
    mods = (importlib.import_module(f".{m}", __package__) for m in _MODULES)
    return {mod.ARCH.name: mod.ARCH for mod in mods}


def get_arch(name: str) -> Union[LMArch, RecsysArch]:
    archs = _archs()
    if name not in archs:
        raise KeyError(f"unknown or unported arch {name!r}; ported: {sorted(archs)}")
    return archs[name]


def list_archs() -> List[str]:
    return sorted(_archs())
