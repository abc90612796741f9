"""Geo-distributed environment model: DCs, WAN latency/bandwidth, pricing.

Defaults reproduce the paper's measurements:
  * Table I  — available bandwidth + RTT among five Alibaba Cloud DCs.
  * Table II — cloud storage / GET / PUT / transfer prices (Alibaba row).
Request latency follows Eq. (1):  l = RTT + size / BW.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["GeoEnvironment", "PAPER_TABLE1_DCS", "make_paper_env", "make_synthetic_env"]

# --- Table I (paper §II).  RTT in ms (lower triangle), BW in Mbps (upper). ---
PAPER_TABLE1_DCS = ["us_east", "us_west", "london", "singapore", "beijing"]

_T1_RTT_MS = np.array(
    [
        [0.0, 69.0, 80.0, 225.0, 226.0],
        [69.0, 0.0, 136.0, 178.0, 145.0],
        [80.0, 136.0, 0.0, 213.0, 256.0],
        [225.0, 178.0, 213.0, 0.0, 75.0],
        [226.0, 145.0, 256.0, 75.0, 0.0],
    ]
)
_T1_BW_MBPS = np.array(
    [
        [0.0, 96.0, 92.0, 66.0, 68.0],
        [96.0, 0.0, 93.0, 80.0, 77.0],
        [92.0, 93.0, 0.0, 74.0, 42.0],
        [66.0, 80.0, 74.0, 0.0, 96.0],
        [68.0, 77.0, 42.0, 96.0, 0.0],
    ]
)

# --- Table II, Alibaba row: storage $/GB/month, GET $/M, PUT $/M, net $/GB ---
_ALIBABA_PRICES = dict(store=0.016, get=0.10, put=1.40, net=0.043)


@dataclasses.dataclass
class GeoEnvironment:
    """Latency / bandwidth / pricing model for a set of DCs.

    Units: latency seconds, bandwidth bytes/sec, sizes bytes, costs $.
    """

    names: Sequence[str]
    rtt_s: np.ndarray  # [D, D] round-trip seconds
    bw_Bps: np.ndarray  # [D, D] bytes/sec
    c_store: np.ndarray  # [D] $/byte/window
    c_read: np.ndarray  # [D] $/GET
    c_write: np.ndarray  # [D] $/PUT
    c_net: np.ndarray  # [D, D] $/byte  (src -> dst)

    @property
    def n_dcs(self) -> int:
        return len(self.names)

    def request_latency(self, d: int, y: int, size_bytes: float) -> float:
        """Eq. (1): latency of DC ``d`` serving ``size_bytes`` to DC ``y``."""
        if d == y:
            return 0.0
        return float(self.rtt_s[d, y] + size_bytes / self.bw_Bps[d, y])

    def request_latency_matrix(self, sizes: np.ndarray) -> np.ndarray:
        """Vectorized Eq. (1): [D_serve, D_origin] latency for per-pair sizes.

        ``sizes`` broadcastable to [D, D]; diagonal forced to 0 (local)."""
        lat = self.rtt_s + np.asarray(sizes) / self.bw_Bps_safe()
        np.fill_diagonal(lat, 0.0)
        return lat

    def bw_Bps_safe(self) -> np.ndarray:
        bw = self.bw_Bps.copy()
        np.fill_diagonal(bw, np.inf)
        return bw

    def link_budget_bytes(self, window_s: float) -> np.ndarray:
        """[src, dst] WAN bytes one migration window can ship per link.

        The link-granular form of the paper's migration condition ξ (Eq. 14):
        a transfer wave may load each (src, dst) link with at most
        ``bw_Bps * window_s`` bytes.  The diagonal is +inf — co-located
        copies never cross the WAN."""
        return self.bw_Bps_safe() * float(window_s)

    def edge_latency(self, d: int, dprime: int, size_bytes: float = 0.0) -> float:
        """Latency level assigned to a cross-partition edge (Def. 1 delta)."""
        return self.request_latency(d, dprime, size_bytes)

    def pairwise_rtt_levels(self, thresholds_s: Sequence[float]) -> np.ndarray:
        """Map each DC pair to a 1-based latency layer via threshold buckets."""
        t = np.asarray(list(thresholds_s) + [np.inf])
        lvl = np.searchsorted(t, self.rtt_s, side="right")
        np.fill_diagonal(lvl, 0)
        return lvl.astype(np.int32)


def make_paper_env(scale_rtt: float = 1.0, scale_bw: float = 1.0) -> GeoEnvironment:
    """The five-DC environment of Table I with Alibaba pricing."""
    d = len(PAPER_TABLE1_DCS)
    rtt = _T1_RTT_MS / 1e3 * scale_rtt
    bw = _T1_BW_MBPS * 1e6 / 8.0 * scale_bw  # Mbps -> bytes/s
    bw[bw == 0] = np.inf
    p = _ALIBABA_PRICES
    gb = 1 << 30
    return GeoEnvironment(
        names=list(PAPER_TABLE1_DCS),
        rtt_s=rtt,
        bw_Bps=bw,
        c_store=np.full(d, p["store"] / gb),
        c_read=np.full(d, p["get"] / 1e6),
        c_write=np.full(d, p["put"] / 1e6),
        c_net=np.full((d, d), p["net"] / gb),
    )


def make_synthetic_env(
    n_dcs: int,
    heterogeneity: str = "high",
    seed: int = 0,
    prices: Optional[Dict[str, float]] = None,
) -> GeoEnvironment:
    """Random WAN with controllable heterogeneity (paper §VII-B sensitivity).

    ``low``    — intra-country cluster: RTT ~ U[10, 40] ms
    ``medium`` — continental: RTT ~ U[30, 120] ms
    ``high``   — global: RTT ~ U[60, 260] ms (Table I-like spread)
    """
    rng = np.random.default_rng(seed)
    lo, hi = {"low": (10, 40), "medium": (30, 120), "high": (60, 260)}[heterogeneity]
    rtt_ms = rng.uniform(lo, hi, size=(n_dcs, n_dcs))
    rtt_ms = (rtt_ms + rtt_ms.T) / 2.0
    np.fill_diagonal(rtt_ms, 0.0)
    # Bandwidth anti-correlates with RTT (paper Table I trend), 40-100 Mbps.
    bw_mbps = 100.0 - 55.0 * (rtt_ms - lo) / max(hi - lo, 1)
    bw_mbps = np.clip((bw_mbps + bw_mbps.T) / 2.0, 40.0, 100.0)
    bw = bw_mbps * 1e6 / 8.0
    np.fill_diagonal(bw, np.inf)
    p = dict(_ALIBABA_PRICES)
    if prices:
        p.update(prices)
    gb = 1 << 30
    return GeoEnvironment(
        names=[f"dc{i}" for i in range(n_dcs)],
        rtt_s=rtt_ms / 1e3,
        bw_Bps=bw,
        c_store=np.full(n_dcs, p["store"] / gb),
        c_read=np.full(n_dcs, p["get"] / 1e6),
        c_write=np.full(n_dcs, p["put"] / 1e6),
        c_net=np.full((n_dcs, n_dcs), p["net"] / gb),
    )
