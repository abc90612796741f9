"""Telemetry subsystem: metrics registry and span tracer (stdlib + numpy).

The exporters of ``repro.obs.export`` come with a later slice."""
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MatrixCounter,
    MetricsRegistry,
    P2Quantile,
    get_registry,
    set_default_registry,
)
from .trace import Span, SpanRecord, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MatrixCounter",
    "MetricsRegistry",
    "P2Quantile",
    "Span",
    "SpanRecord",
    "Tracer",
    "get_registry",
    "set_default_registry",
]
