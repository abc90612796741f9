"""Batched DHD step over symmetric ELL adjacency: CUDA kernels for Hopper.

Replaces ``_count_kernel_batch`` and ``_flow_kernel_batch`` of the JAX
package's ``kernels/dhd_spmv.py`` (Pallas, TPU).  The kernels live in
``csrc/dhd_spmv.cu``: one warp per (field, row), two launches per step
because the flow pass reads the neighbours' ``|N^out|``.  The step is bound
by memory on an H100: each pass reads ``cols`` and ``vals`` once (``n * kmax
* 8`` bytes with shared ``vals``, plus ``B * n * kmax * 4`` per-field) at
3.35 TB/s, with a few flops per slot; lanes read consecutive slots of a row
so the loads coalesce, and the heat gather hits L2.

For tensors on the CPU :func:`dhd_ell_step_batch` takes the plain version,
:func:`repro_torch.kernels.ref.dhd_ell_ref_batch`; for CUDA tensors it
launches the kernels or raises.
"""
from __future__ import annotations

import torch

from . import ref
from .cuda_lib import check, library, register_counter, stream_ptr

__all__ = ["COUNT_LAUNCHES", "FLOW_LAUNCHES", "dhd_ell_step_batch"]

COUNT_LAUNCHES = register_counter("dhd_count")
FLOW_LAUNCHES = register_counter("dhd_flow")


def _check_inputs(heat, cols, vals, q) -> None:
    if heat.dim() != 2:
        raise ValueError(f"heat must be [B, n], got {tuple(heat.shape)}")
    B, n = heat.shape
    if cols.dim() != 2 or cols.shape[0] != n:
        raise ValueError(f"cols must be [n={n}, kmax], got {tuple(cols.shape)}")
    kmax = cols.shape[1]
    if tuple(vals.shape) not in ((n, kmax), (B, n, kmax)):
        raise ValueError(
            f"vals must be [n, kmax] or [B, n, kmax], got {tuple(vals.shape)}"
        )
    if tuple(q.shape) != (B, n):
        raise ValueError(f"q must be [B={B}, n={n}], got {tuple(q.shape)}")
    for name, t, dt in (
        ("heat", heat, torch.float32), ("cols", cols, torch.int32),
        ("vals", vals, torch.float32), ("q", q, torch.float32),
    ):
        if t.device != heat.device:
            raise ValueError(f"{name} is on {t.device}, heat on {heat.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def dhd_ell_step_batch(
    heat: torch.Tensor,  # [B, n] f32
    cols: torch.Tensor,  # [n, kmax] i32 shared symmetric ELL (pad slots weight 0)
    vals: torch.Tensor,  # [n, kmax] shared or [B, n, kmax] per-field f32 weights
    q: torch.Tensor,  # [B, n] f32 source heat
    alpha: float = 0.5,
    gamma: float = 0.1,
    beta: float = 0.3,
) -> torch.Tensor:
    """One DHD update for B heat fields; same contract as
    ``ref.dhd_ell_ref_batch`` (a zero weight in 3-D ``vals`` switches the
    edge off for that field only)."""
    if heat.device.type == "cpu":
        return ref.dhd_ell_ref_batch(
            heat, cols, vals, q, alpha=alpha, gamma=gamma, beta=beta
        )
    if heat.device.type != "cuda":
        raise ValueError(f"dhd_ell_step_batch runs on cpu or cuda, not {heat.device}")
    _check_inputs(heat, cols, vals, q)
    B, n = heat.shape
    kmax = cols.shape[1]
    per_field = int(vals.dim() == 3)
    nout = torch.empty_like(heat)
    out = torch.empty_like(heat)
    lib = library().get()
    stream = stream_ptr(heat.device)
    with torch.cuda.device(heat.device):
        check(
            lib.dhd_count_batch(
                heat.data_ptr(), cols.data_ptr(), vals.data_ptr(), nout.data_ptr(),
                B, n, kmax, per_field, stream,
            ),
            "dhd_count_batch",
        )
        COUNT_LAUNCHES.n += 1
        check(
            lib.dhd_flow_batch(
                heat.data_ptr(), nout.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                q.data_ptr(), out.data_ptr(), B, n, kmax, per_field,
                float(alpha), float(1.0 - gamma), float(beta), stream,
            ),
            "dhd_flow_batch",
        )
        FLOW_LAUNCHES.n += 1
    return out
