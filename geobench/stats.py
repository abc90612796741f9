"""The metric arithmetic of a run, kept apart from the program.

A read's time runs from when it was due to the return of the ``step()``
that served it; a read still pending when the window closes counts with its
age then, and a read that failed counts as infinitely late.
"""
from __future__ import annotations

import statistics

import numpy as np

__all__ = ["read_latencies", "p95", "spread"]


def read_latencies(due, t_ret, failed, end: float) -> np.ndarray:
    """Seconds of every read due in the window (``due < end``)."""
    due = np.asarray(due, np.float64)
    t_ret = np.asarray(t_ret, np.float64)
    lat = np.where(np.isnan(t_ret) | (t_ret > end), end - due, t_ret - due)
    return np.where(np.asarray(failed, bool), np.inf, lat)


def p95(values) -> float:
    """95th percentile by nearest rank (``method="higher"``), so an
    infinite sample gives an infinite tail rather than NaN."""
    return float(np.quantile(np.asarray(values, np.float64), 0.95, method="higher"))


def spread(values) -> float:
    """Interquartile distance as a share of the median."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2
