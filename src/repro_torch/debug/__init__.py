"""Runtime invariant sanitizers (enabled via ``REPRO_SANITIZE=1``)."""
from .sanitize import (
    SanitizerError,
    StoreSanitizer,
    attach_sanitizer,
    maybe_attach,
    sanitize_enabled,
)

__all__ = [
    "SanitizerError",
    "StoreSanitizer",
    "attach_sanitizer",
    "maybe_attach",
    "sanitize_enabled",
]
