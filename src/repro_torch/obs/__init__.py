"""Telemetry subsystem: metrics registry, span tracer, exporters (stdlib +
numpy): Chrome trace-event JSON and a plain-text dashboard."""
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
from .export import export_chrome_trace, text_dashboard

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
    "export_chrome_trace",
    "get_registry",
    "set_default_registry",
    "text_dashboard",
]
