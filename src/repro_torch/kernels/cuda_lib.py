"""Build and load the port's CUDA kernels; count their launches.

Every ``*.cu`` file under ``repro_torch/csrc/`` is compiled with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface, which
is loaded with ``ctypes``.  The build happens at the first launch, never at
import: one ``nvcc -c`` per source, all started together, then one link.
The library lands in ``build/`` at the repository root under a name derived
from the sources' content, so an edited source rebuilds and an unchanged one
is reused.

Shards of a sharded store launch from several threads at once, so the
library is built and loaded under a lock, and a counter's bump takes one.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "KernelLibrary",
    "LaunchCounter",
    "check",
    "launch_counters",
    "library",
    "register_counter",
    "reset_launch_counters",
    "stream_ptr",
]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# argtypes of every C entry point: pointers and the stream as c_void_p so
# ctypes never truncates them to 32 bits
_SIGNATURES = {
    "dhd_count_batch": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "dhd_flow_batch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P),
    "dhd_count_single": (_P, _P, _P, _P, _I, _I, _P),
    "dhd_flow_single": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P),
    "route_expand_ragged_ids_launch": (
        _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _P,
    ),
    "flash_attention_fwd": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _I, _I, _I, _P,
    ),
    "embedding_bag_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "embedding_bag_instance": (_P, _P, _I, _I),
}


class LaunchCounter:
    """Number of launches of one kernel; a wrapper bumps it once per launch."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.n = 0
        self._lock = threading.Lock()

    def bump(self) -> None:
        """Count one launch (``n += 1`` is a read-modify-write that two
        launching threads could interleave)."""
        with self._lock:
            self.n += 1

    def reset(self) -> None:
        with self._lock:
            self.n = 0


_COUNTERS: Dict[str, LaunchCounter] = {}


def register_counter(name: str) -> LaunchCounter:
    """A new counter for kernel ``name``, listed by :func:`launch_counters`."""
    c = LaunchCounter(name)
    _COUNTERS[name] = c
    return c


def launch_counters() -> Dict[str, LaunchCounter]:
    """Every kernel's counter by name (the kernel modules register theirs)."""
    return dict(_COUNTERS)


def reset_launch_counters() -> None:
    for c in _COUNTERS.values():
        c.reset()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class KernelLibrary:
    """The compiled kernels, built on first :meth:`get`."""

    def __init__(self) -> None:
        self.sources: List[pathlib.Path] = sorted(CSRC.glob("*.cu"))
        self._lib: Optional[ctypes.CDLL] = None
        self.build_s = 0.0  # seconds spent compiling in this process (0 = reused)
        self.build_log = ""  # nvcc's ptxas report (registers, spills)
        self.path: Optional[pathlib.Path] = None
        self._lock = threading.Lock()  # one build and one load per process

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in self.sources:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return h.hexdigest()[:16]

    def _build(self, out: pathlib.Path) -> None:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [pathlib.Path(tmp) / (s.stem + ".o") for s in self.sources]
            procs = [
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for s, o in zip(self.sources, objs)
            ]
            logs = [p.communicate()[0] for p in procs]
            self.build_log = "".join(logs)
            failed = [s.name for s, p in zip(self.sources, procs) if p.returncode != 0]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{self.build_log}")
            tmp_so = pathlib.Path(tmp) / out.name
            link = subprocess.run(
                [nvcc, "-shared", *map(str, objs), "-o", str(tmp_so)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
            os.replace(tmp_so, out)  # atomic: a concurrent loader sees all or nothing
        self.build_s = time.perf_counter() - t0

    def get(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is not None:  # another thread built it meanwhile
                return self._lib
            out = BUILD_DIR / f"repro_torch_kernels_{self._digest()}.so"
            if not out.exists():
                self._build(out)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self.path = out
            self._lib = lib  # published last: a reader never sees it half set up
        return self._lib


_LIBRARY = KernelLibrary()


def library() -> KernelLibrary:
    """The process's kernel library (built at its first :meth:`get`)."""
    return _LIBRARY


def check(code: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
