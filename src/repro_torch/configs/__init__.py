"""Arch registry of the port: ``get_arch(name)`` / ``list_archs()``.

Lists the LM archs the port runs (MLA configs; the others wait for
ROADMAP.md slice F).  An arch is a minimal :class:`LMArch`: its name, full
config, smoke config and family; none of the JAX package's dry-run
machinery (shape cells, abstract inputs, sharding specs) is carried over.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from ..models.transformer import LMConfig

__all__ = ["LMArch", "get_arch", "list_archs"]

_MODULES = ("deepseek_v2_lite_16b",)


@dataclasses.dataclass(frozen=True)
class LMArch:
    name: str
    cfg: LMConfig
    smoke_cfg: LMConfig
    family: str = "lm"


def _archs() -> dict:
    mods = (importlib.import_module(f".{m}", __package__) for m in _MODULES)
    return {mod.ARCH.name: mod.ARCH for mod in mods}


def get_arch(name: str) -> LMArch:
    archs = _archs()
    if name not in archs:
        raise KeyError(f"unknown or unported arch {name!r}; ported: {sorted(archs)}")
    return archs[name]


def list_archs() -> List[str]:
    return sorted(_archs())
