"""Per-device kernel autotuner: measure every candidate, cache the winner.

The same measure-everything-then-index discipline bitfiltrator applies to
FPGA architectures: for each (device kind, op, shape bucket) every candidate
launch configuration is timed (min-of-repeats to shed scheduler noise), the
winner is cached in an in-process table, and both the sweep timings and the
winners land in the metrics registry (``repro_torch.obs``) as first-class
instruments instead of ad-hoc dicts.

Winner tables serialize to **sorted-key JSON under a version stamp** so two
sweeps of the same device produce byte-identical files; ``load`` ignores
stamps from other versions.  A lookup for a device/op/shape that was never
swept (e.g. a winner table shipped from a TPU host loaded on CPU) returns
``None`` — callers fall back to their built-in defaults — and bumps a
``kernels.autotune_miss`` counter so untuned serving is visible.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from ..obs import get_registry

__all__ = [
    "TABLE_VERSION",
    "Autotuner",
    "get_autotuner",
    "set_autotuner",
    "shape_bucket",
    "signature_key",
]

TABLE_VERSION = 1

Signature = Sequence[Union[int, str]]


def shape_bucket(n: int, floor: int = 8) -> int:
    """Next power of two >= max(n, floor): shapes inside one bucket share a
    jit cache entry and a winner, so sweeps amortize across the batch mix."""
    b = max(int(floor), 1)
    n = max(int(n), 1)
    while b < n:
        b <<= 1
    return b


def signature_key(signature: Signature) -> str:
    """Deterministic string key for an op signature (shape-bucket tuple)."""
    return "x".join(str(s) for s in signature)


def _config_key(config: Dict[str, Any]) -> str:
    return json.dumps(config, sort_keys=True)


class Autotuner:
    """In-process winner table keyed on (device kind, op, shape bucket)."""

    def __init__(self, registry=None) -> None:
        self._table: Dict[str, Dict[str, Dict[str, dict]]] = {}
        self._registry = registry

    # ------------------------------------------------------------- plumbing
    def _reg(self):
        return self._registry if self._registry is not None else get_registry()

    @staticmethod
    def device_kind() -> str:
        """``cuda:<device name>`` of the current CUDA device (e.g.
        ``cuda:NVIDIA H100 80GB HBM3``), or ``cpu:cpu`` without one."""
        import torch

        from ..device import on_cuda

        if on_cuda():
            return f"cuda:{torch.cuda.get_device_name()}"
        return "cpu:cpu"

    # -------------------------------------------------------------- lookups
    def lookup(
        self, op: str, signature: Signature, device: Optional[str] = None
    ) -> Optional[Dict[str, Any]]:
        """Winner config for (device, op, signature), or ``None`` (+ a
        ``kernels.autotune_miss`` count) when nothing was swept — the caller
        must fall back to its built-in defaults."""
        dev = device or self.device_kind()
        entry = self._table.get(dev, {}).get(op, {}).get(signature_key(signature))
        reg = self._reg()
        if entry is None:
            if reg.enabled:
                reg.counter("kernels.autotune_miss", op=op).inc()
            return None
        if reg.enabled:
            reg.counter("kernels.autotune_hit", op=op).inc()
        return dict(entry["config"])

    # --------------------------------------------------------------- sweeps
    def sweep(
        self,
        op: str,
        signature: Signature,
        candidates: Sequence[Dict[str, Any]],
        runner: Callable[[Dict[str, Any]], Any],
        repeats: int = 3,
        device: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Time every candidate config (one warm-up call to absorb compiles,
        then min-of-``repeats``), record the sweep into the registry, cache
        and return the winner.  Ties break on the candidate's sorted-key
        JSON, so the winner is deterministic under equal timings."""
        if not candidates:
            raise ValueError("sweep needs at least one candidate config")
        dev = device or self.device_kind()
        sig = signature_key(signature)
        reg = self._reg()
        timings: List[Tuple[float, str, Dict[str, Any]]] = []
        for config in candidates:
            runner(config)  # warm-up: compile + first-touch outside the clock
            best = float("inf")
            for _ in range(max(1, repeats)):
                t0 = time.perf_counter()
                runner(config)
                best = min(best, time.perf_counter() - t0)
            timings.append((best, _config_key(config), dict(config)))
            reg.counter("kernels.autotune_trials", op=op).inc()
            reg.histogram("kernels.autotune_sweep_s", op=op).observe(best)
        timings.sort(key=lambda t: (t[0], t[1]))
        best_s, _, winner = timings[0]
        self._table.setdefault(dev, {}).setdefault(op, {})[sig] = {
            "config": dict(winner),
            "best_s": best_s,
            "timings": [
                {"config": c, "seconds": s} for s, _, c in timings
            ],
        }
        reg.gauge("kernels.autotune_best_s", op=op, sig=sig, device=dev).set(best_s)
        return dict(winner)

    # ---------------------------------------------------------- persistence
    def snapshot(self) -> dict:
        """Serializable winner tables under the version stamp."""
        return {"version": TABLE_VERSION, "tables": self._table}

    def dumps(self) -> str:
        """Deterministic sorted-key JSON of the winner tables."""
        return json.dumps(self.snapshot(), sort_keys=True, indent=2)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())
            f.write("\n")

    def load(self, source: Union[str, dict]) -> bool:
        """Merge winner tables from a path or parsed snapshot.  Tables from
        a different :data:`TABLE_VERSION` are ignored (``False``); entries
        for devices this process never sees just sit idle — lookups for the
        local device still miss and fall back to defaults."""
        if isinstance(source, str):
            with open(source) as f:
                source = json.load(f)
        if source.get("version") != TABLE_VERSION:
            reg = self._reg()
            if reg.enabled:
                reg.counter("kernels.autotune_stale_table").inc()
            return False
        for dev, ops in source.get("tables", {}).items():
            for op, sigs in ops.items():
                self._table.setdefault(dev, {}).setdefault(op, {}).update(
                    {k: dict(v) for k, v in sigs.items()}
                )
        return True

    def reset(self) -> None:
        """Drop the in-process winner cache (sweeps must re-run)."""
        self._table.clear()


_AUTOTUNER = Autotuner()  # geolint: allow[GL001] — singleton with reset()


def get_autotuner() -> Autotuner:
    return _AUTOTUNER


def set_autotuner(tuner: Autotuner) -> Autotuner:
    global _AUTOTUNER
    _AUTOTUNER = tuner
    return tuner
