"""The one traffic generator: every mix is a data file of parameters.

A mix (``traffic/<name>.json``) gives the open-loop read rate, the share of
reads sent from their pattern's home DC, the warm-up drains and the
background work due in the window.  Reads arrive as a Poisson process at a
fixed rate, whatever the store does (independent users: an open loop).  A
read draws its pattern uniformly over the workload's non-empty patterns;
its origin is the pattern's home DC (``argmax r_py``) with probability
``home_share`` and otherwise uniform over the DCs, the paper's cross-border
mix.  Every stream comes from ``--seed`` alone.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

__all__ = ["ReadStream", "load_mix", "make_reads", "warmup_reads"]

TRAFFIC_DIR = pathlib.Path(__file__).resolve().parent / "traffic"


def load_mix(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


@dataclasses.dataclass
class ReadStream:
    due: np.ndarray  # [N] seconds after the window opens, ascending
    pattern: np.ndarray  # [N] index into the workload's patterns
    origin: np.ndarray  # [N] origin DC


def _draw(rng, n: int, eligible: np.ndarray, home: np.ndarray, n_dcs: int,
          home_share: float):
    pattern = eligible[rng.integers(0, len(eligible), size=n)]
    at_home = rng.random(n) < home_share
    origin = np.where(at_home, home[pattern], rng.integers(0, n_dcs, size=n))
    return pattern.astype(np.int64), origin.astype(np.int64)


def make_reads(reads: dict, eligible, home, n_dcs: int, seed: int,
               seconds: float) -> ReadStream:
    """Poisson arrivals at ``reads["rate_rps"]`` over ``[0, seconds)``."""
    rng = np.random.default_rng([seed, 1])
    rate = float(reads["rate_rps"])
    n_max = int(rate * seconds + 10 * np.sqrt(rate * seconds) + 16)
    due = np.cumsum(rng.exponential(1.0 / rate, size=n_max))
    due = due[due < seconds]
    pattern, origin = _draw(rng, len(due), np.asarray(eligible), np.asarray(home),
                            n_dcs, float(reads["home_share"]))
    return ReadStream(due=due, pattern=pattern, origin=origin)


def warmup_reads(reads: dict, eligible, home, n_dcs: int, seed: int, n: int):
    """``(pattern, origin)`` of the warm-up's reads, a stream of their own."""
    rng = np.random.default_rng([seed, 2])
    return _draw(rng, n, np.asarray(eligible), np.asarray(home), n_dcs,
                 float(reads["home_share"]))
