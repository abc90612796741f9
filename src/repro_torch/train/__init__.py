"""Training: AdamW, checkpoints and the fault-tolerant trainer (port of
``repro/train``)."""
from . import checkpoint, optimizer, trainer  # noqa: F401
