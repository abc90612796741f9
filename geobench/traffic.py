"""The one traffic generator: every mix is a data file of parameters.

A mix (``traffic/<name>.json``) gives the open-loop read rate, the share of
reads sent from their pattern's home DC, the warm-up drains and the
background work due in the window.  Reads arrive as a Poisson process at a
fixed rate, whatever the store does (independent users: an open loop).  A
read draws its pattern uniformly over the workload's non-empty patterns;
its origin is the pattern's home DC (``argmax r_py``) with probability
``home_share`` and otherwise uniform over the DCs, the paper's cross-border
mix.  Every stream comes from ``--seed`` alone.

A mix may also hold a ``"writes"`` block: LDBC SNB Interactive's inserts
that touch Person and knows (IU1 add person, IU8 add friendship), arriving
open-loop at ``rate_ops`` in the ratio ``kind_shares``, drawn like the
knows generator draws the graph (:func:`make_writes`).  The client's log
seals a batch every ``seal_s`` seconds; ``warmup_batches`` of them are
sealed before the window opens.  A mix without the block draws exactly
the numbers it drew before writes existed.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import List

import numpy as np

__all__ = ["ReadStream", "Batch", "load_mix", "make_reads", "warmup_reads", "make_writes"]

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


@dataclasses.dataclass
class Batch:
    """One sealed batch of inserts.  A new person takes the next vertex id
    (the persons before it, counting those of earlier batches); an edge's
    endpoints are vertex ids, a new person's among them."""

    due: float  # seconds after the window opens when the log seals it (<= 0: warm-up)
    vertex_size: np.ndarray  # [nv] float32 bytes (IU1)
    vertex_partition: np.ndarray  # [nv] int32 DC
    edge_src: np.ndarray  # [ne] int64 (IU8)
    edge_dst: np.ndarray  # [ne] int64
    edge_size: np.ndarray  # [ne] float32 bytes

    @property
    def n_ops(self) -> int:
        return len(self.vertex_size) + len(self.edge_src)


class _Weighted:
    """Persons drawn in proportion to their Chung-Lu weights: a fixed base
    set and the new persons appended to it."""

    def __init__(self, ids: np.ndarray, weight: np.ndarray) -> None:
        self.ids = np.asarray(ids, np.int64)
        self.cw = np.cumsum(np.asarray(weight, np.float64))
        self.new_ids: List[int] = []
        self.new_cw: List[float] = []

    @property
    def mass(self) -> float:
        return float(self.cw[-1] if len(self.cw) else 0.0) + (
            self.new_cw[-1] if self.new_cw else 0.0)

    def add(self, vid: int, w: float) -> None:
        self.new_ids.append(vid)
        self.new_cw.append((self.new_cw[-1] if self.new_cw else 0.0) + w)

    def draw(self, u: float) -> int:
        """The person at ``u`` in ``[0, 1)`` of the mass."""
        x = u * self.mass
        base = float(self.cw[-1]) if len(self.cw) else 0.0
        if x < base:
            return int(self.ids[min(np.searchsorted(self.cw, x, side="right"),
                                    len(self.ids) - 1)])
        j = int(np.searchsorted(np.asarray(self.new_cw), x - base, side="right"))
        return self.new_ids[min(j, len(self.new_ids) - 1)]


def make_writes(writes: dict, gc: dict, g, wiring, n_dcs: int, seed: int,
                seconds: float) -> List[Batch]:
    """The sealed batches of the write stream, warm-up first, up to the last
    one sealed before ``seconds``; what arrives after it is never sealed.

    Mutations arrive as a Poisson process at ``rate_ops`` from
    ``[-warmup_batches * seal_s, seconds)`` (their own stream,
    ``default_rng([seed, 4])``), each an IU1 or an IU8 by ``kind_shares``.
    IU1: a community drawn uniformly, as the generator draws a person's; its
    home DC holds the person with probability ``geo_affinity``, else a
    uniform DC; a weight drawn as the generator's (lognormal
    ``degree_sigma``, scaled, capped at ``max_degree``); bytes lognormal
    about ``person_bytes``.  IU8: a share ``intra_share`` inside one
    community (drawn by its weight), both endpoints by weight; the rest by
    weight over everyone; new persons take part from their insert on; a self
    loop or a pair already joined is drawn again; oriented at random; bytes
    lognormal about ``knows_bytes``.  A graph drawn with no ``Wiring`` (a
    Kronecker graph) has nothing to draw inserts like, and is refused."""
    if wiring is None:
        raise ValueError(f"a mix with writes needs a graph drawn with communities and weights; "
                         f"the {gc.get('generator')!r} graph has none")
    rng = np.random.default_rng([seed, 4])
    rate = float(writes["rate_ops"])
    seal = float(writes["seal_s"])
    n_warm = int(writes["warmup_batches"])
    shares = writes["kind_shares"]
    p_iu1 = float(shares["IU1"]) / float(shares["IU1"] + shares["IU8"])
    span = n_warm * seal + seconds
    n_max = int(rate * span + 10 * np.sqrt(rate * span) + 16)
    t = np.cumsum(rng.exponential(1.0 / rate, size=n_max))
    t = t[t < span]
    n0 = int(g.n_nodes)
    comm = wiring.community
    k = len(wiring.home_dc)
    everyone = _Weighted(np.arange(n0), wiring.weight)
    members = [np.where(comm == c)[0] for c in range(k)]
    by_comm = [_Weighted(m, wiring.weight[m]) for m in members]
    pairs = np.unique(np.minimum(g.src, g.dst).astype(np.int64) << 32
                      | np.maximum(g.src, g.dst).astype(np.int64))
    new_pairs = set()
    n = n0
    ops = []  # (time, kind, a, b, size)
    for ti in t.tolist():
        if rng.random() < p_iu1:
            c = int(rng.integers(0, k))
            home = rng.random() < float(gc["geo_affinity"])
            part = int(wiring.home_dc[c]) if home else int(rng.integers(0, n_dcs))
            w = min(rng.lognormal(0.0, float(gc["degree_sigma"])) * wiring.weight_scale,
                    float(gc["max_degree"]))
            size = np.float32(rng.lognormal(np.log(gc["person_bytes"]), 0.5))
            everyone.add(n, w)
            by_comm[c].add(n, w)
            ops.append((ti, 0, part, -1, size))
            n += 1
            continue
        for _ in range(1000):
            if rng.random() < float(gc["intra_share"]):
                masses = np.array([b.mass for b in by_comm])
                c = int(np.searchsorted(np.cumsum(masses), rng.random() * masses.sum(),
                                        side="right"))
                pool = by_comm[min(c, k - 1)]
            else:
                pool = everyone
            a, b = pool.draw(rng.random()), pool.draw(rng.random())
            lo, hi = min(a, b), max(a, b)
            key = lo << 32 | hi
            if a == b or key in new_pairs:
                continue
            at = np.searchsorted(pairs, key)
            if at < len(pairs) and pairs[at] == key:
                continue
            break
        else:  # pragma: no cover - a graph this dense is not an SNB graph
            raise RuntimeError("no unjoined pair of persons found in 1,000 draws")
        new_pairs.add(key)
        src, dst = (hi, lo) if rng.random() < 0.5 else (lo, hi)
        size = np.float32(rng.lognormal(np.log(gc["knows_bytes"]), 0.4))
        ops.append((ti, 1, src, dst, size))
    out: List[Batch] = []
    n_sealed = int(np.ceil(span / seal - 1e-9))
    at = 0
    for j in range(n_sealed):
        due = (j + 1) * seal - n_warm * seal
        if due >= seconds:
            break
        end = at
        while end < len(ops) and ops[end][0] < (j + 1) * seal:
            end += 1
        chunk = ops[at:end]
        at = end
        v = [o for o in chunk if o[1] == 0]
        e = [o for o in chunk if o[1] == 1]
        out.append(Batch(
            due=float(due),
            vertex_size=np.array([o[4] for o in v], np.float32),
            vertex_partition=np.array([o[2] for o in v], np.int32),
            edge_src=np.array([o[2] for o in e], np.int64),
            edge_dst=np.array([o[3] for o in e], np.int64),
            edge_size=np.array([o[4] for o in e], np.float32),
        ))
    return out
