"""DHD step over symmetric ELL adjacency: CUDA kernels for Hopper.

:func:`dhd_ell_step_batch` replaces ``_count_kernel_batch`` and
``_flow_kernel_batch`` of the JAX package's ``kernels/dhd_spmv.py`` (Pallas,
TPU): B heat fields over one column structure.  Both passes give each SM one
block over a contiguous range of rows, and each warp one row for up to 5
fields at once: the row's ``cols`` (and shared ``vals``) load once, the
fields' neighbour gathers are in flight together, and most of them hit the
SM's L1 (the first designs, a warp per (field, row), ran at 8x and 13x
their bounds on chains of dependent loads).
:func:`dhd_ell_step` replaces ``_count_kernel`` and ``_flow_kernel`` of the
same file (``dhd_spmv.py:70``, ``:82``): one heat field.  The count pass
gives half a warp to a row; the flow pass a team of 8, 16 or 32 lanes (from
``kmax``; 8 for the warm-DHD ELL's 80 slots) over contiguous rows per SM,
each lane loading its slots in 16-byte pieces before any gather.  The
kernels live in ``csrc/dhd_spmv.cu``; a step is two launches because the
flow pass reads the neighbours' ``|N^out|``.

By bytes the step is bound by HBM on an H100: each pass reads ``cols`` and
``vals`` once (``n * kmax * 8`` bytes with shared ``vals``, plus
``B * n * kmax * 4`` per-field) at 3.35 TB/s.  In fact the neighbour
gathers bound it: each reads a 32-byte sector for 4 bytes, about one a
clock per SM, and with one field every SM also reads back most of the
field from L2.  At warm DHD's streaming shape (27,136 rows x 80 slots
after two churn batches at 0.01) a pass moves 17.6-17.8 MB: 35.4 MB a
step, a bound of 10.6 us.

For tensors on the CPU both wrappers take the plain versions
(:func:`repro_torch.kernels.ref.dhd_ell_ref_batch`,
:func:`repro_torch.kernels.ref.dhd_ell_ref`); for CUDA tensors they launch
the kernels or raise.
"""
from __future__ import annotations

import torch

from . import ref
from .cuda_lib import check, library, register_counter, stream_ptr

__all__ = [
    "COUNT_LAUNCHES",
    "COUNT_SINGLE_LAUNCHES",
    "FLOW_LAUNCHES",
    "FLOW_SINGLE_LAUNCHES",
    "dhd_ell_step",
    "dhd_ell_step_batch",
]

COUNT_LAUNCHES = register_counter("dhd_count")
FLOW_LAUNCHES = register_counter("dhd_flow")
COUNT_SINGLE_LAUNCHES = register_counter("dhd_count_single")
FLOW_SINGLE_LAUNCHES = register_counter("dhd_flow_single")


def _check_inputs(heat, cols, vals, q, single: bool = False) -> None:
    if heat.dim() != (1 if single else 2):
        raise ValueError(
            f"heat must be {'[n]' if single else '[B, n]'}, got {tuple(heat.shape)}"
        )
    n = heat.shape[-1]
    if cols.dim() != 2 or cols.shape[0] != n:
        raise ValueError(f"cols must be [n={n}, kmax], got {tuple(cols.shape)}")
    kmax = cols.shape[1]
    shapes = ((n, kmax),) if single else ((n, kmax), (heat.shape[0], n, kmax))
    if tuple(vals.shape) not in shapes:
        raise ValueError(f"vals must be one of {shapes}, got {tuple(vals.shape)}")
    if q.shape != heat.shape:
        raise ValueError(f"q must be {tuple(heat.shape)}, got {tuple(q.shape)}")
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
        COUNT_LAUNCHES.bump()
        check(
            lib.dhd_flow_batch(
                heat.data_ptr(), nout.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                q.data_ptr(), out.data_ptr(), B, n, kmax, per_field,
                float(alpha), float(1.0 - gamma), float(beta), stream,
            ),
            "dhd_flow_batch",
        )
        FLOW_LAUNCHES.bump()
    return out


def dhd_ell_step(
    heat: torch.Tensor,  # [n] f32
    cols: torch.Tensor,  # [n, kmax] i32 symmetric ELL (pad slots: self, weight 0)
    vals: torch.Tensor,  # [n, kmax] f32 edge weights
    q: torch.Tensor,  # [n] f32 source heat
    alpha: float = 0.5,
    gamma: float = 0.1,
    beta: float = 0.3,
) -> torch.Tensor:
    """One DHD update for one heat field; same contract as
    ``ref.dhd_ell_ref`` (and as the JAX package's ``dhd_ell_step``)."""
    if heat.device.type == "cpu":
        return ref.dhd_ell_ref(heat, cols, vals, q, alpha=alpha, gamma=gamma, beta=beta)
    if heat.device.type != "cuda":
        raise ValueError(f"dhd_ell_step runs on cpu or cuda, not {heat.device}")
    _check_inputs(heat, cols, vals, q, single=True)
    n, kmax = cols.shape
    nout = torch.empty_like(heat)
    out = torch.empty_like(heat)
    lib = library().get()
    stream = stream_ptr(heat.device)
    with torch.cuda.device(heat.device):
        check(
            lib.dhd_count_single(
                heat.data_ptr(), cols.data_ptr(), vals.data_ptr(), nout.data_ptr(),
                n, kmax, stream,
            ),
            "dhd_count_single",
        )
        COUNT_SINGLE_LAUNCHES.bump()
        check(
            lib.dhd_flow_single(
                heat.data_ptr(), nout.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                q.data_ptr(), out.data_ptr(), n, kmax,
                float(alpha), float(1.0 - gamma), float(beta), stream,
            ),
            "dhd_flow_single",
        )
        FLOW_SINGLE_LAUNCHES.bump()
    return out
