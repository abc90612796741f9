"""Fused stepwise layered routing expansion: CUDA kernel for Hopper.

Replaces ``_expand_kernel`` of the JAX package's ``kernels/route_expand.py``
(Pallas, TPU).  The kernel lives in ``csrc/route_expand.cu``: one warp per
request walks its own greedy (local items, then per layer the cluster DC
covering the most missing items, lowest DC id on ties, escalate on no
progress) and folds Eq. 1.  Requests need no lockstep: extra greedy passes
are idempotent, so per-request walks equal the block-lockstep oracle.  The
kernel is bound by memory on an H100: ``R * K * (4 + 4)`` bytes of bitmasks
and sizes read, ``R * K * 4`` bytes of picks written, at 3.35 TB/s; a
request's passes re-read its own slots from L1/L2, and lanes own
consecutive slots so each row's loads coalesce.

For tensors on the CPU :func:`route_expand` takes the plain version,
:func:`repro_torch.kernels.ref.route_expand_ref`; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import ref
from .cuda_lib import check, library, register_counter, stream_ptr

__all__ = ["LAUNCHES", "MAX_DCS", "route_expand"]

LAUNCHES = register_counter("route_expand")
MAX_DCS = 31  # one int32 bitmask per item, one warp lane per DC (bit 31 = sign)
BLOCK_R = 4  # requests (warps) per CTA; no other value has been measured


def _check_inputs(bits, sizes, lens, origin, comp, rtt, ibw) -> None:
    if bits.dim() != 2:
        raise ValueError(f"bits must be [R, K], got {tuple(bits.shape)}")
    R, K = bits.shape
    if comp.dim() != 2 or comp.shape[0] < 1:
        raise ValueError(f"comp must be [L + 1, D], got {tuple(comp.shape)}")
    D = comp.shape[1]
    if D > MAX_DCS:
        raise ValueError(f"route_expand takes at most {MAX_DCS} DCs, got {D}")
    shapes = (
        ("sizes", sizes, (R, K), torch.float32),
        ("lens", lens, (R,), torch.int32),
        ("origin", origin, (R,), torch.int32),
        ("comp", comp, tuple(comp.shape), torch.int32),
        ("rtt", rtt, (D, D), torch.float32),
        ("ibw", ibw, (D, D), torch.float32),
        ("bits", bits, (R, K), torch.int32),
    )
    for name, t, shape, dt in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != bits.device:
            raise ValueError(f"{name} is on {t.device}, bits on {bits.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def route_expand(
    bits: torch.Tensor,  # [R, K] i32 per-item replica bitmask (bit d = DC d)
    sizes: torch.Tensor,  # [R, K] f32 item bytes (0 where padded)
    lens: torch.Tensor,  # [R] i32 real item count per request
    origin: torch.Tensor,  # [R] i32 origin DC per request
    comp: torch.Tensor,  # [hier + 1, D] i32 layer component ids
    rtt: torch.Tensor,  # [D, D] f32 env RTT matrix
    ibw: torch.Tensor,  # [D, D] f32 elementwise 1 / bandwidth matrix
) -> Tuple[torch.Tensor, ...]:
    """Same contract as ``ref.route_expand_ref``: ``(served [R, K] i32,
    bytes_rd [R, D] f32, layers_used [R] i32, miss_after [R, L+1] i32,
    straggler_s [R] f32, wan_bytes [R] f32)``."""
    if bits.device.type == "cpu":
        return ref.route_expand_ref(bits, sizes, lens, origin, comp, rtt, ibw)
    if bits.device.type != "cuda":
        raise ValueError(f"route_expand runs on cpu or cuda, not {bits.device}")
    _check_inputs(bits, sizes, lens, origin, comp, rtt, ibw)
    R, K = bits.shape
    L = comp.shape[0] - 1
    D = comp.shape[1]
    dev = bits.device
    served = torch.empty((R, K), dtype=torch.int32, device=dev)
    bytes_rd = torch.empty((R, D), dtype=torch.float32, device=dev)
    layers_used = torch.empty(R, dtype=torch.int32, device=dev)
    miss_after = torch.empty((R, L + 1), dtype=torch.int32, device=dev)
    straggler = torch.empty(R, dtype=torch.float32, device=dev)
    wan = torch.empty(R, dtype=torch.float32, device=dev)
    lib = library().get()
    with torch.cuda.device(dev):
        check(
            lib.route_expand_launch(
                bits.data_ptr(), sizes.data_ptr(), lens.data_ptr(), origin.data_ptr(),
                comp.data_ptr(), rtt.data_ptr(), ibw.data_ptr(), served.data_ptr(),
                bytes_rd.data_ptr(), layers_used.data_ptr(), miss_after.data_ptr(),
                straggler.data_ptr(), wan.data_ptr(), R, K, D, L, BLOCK_R,
                stream_ptr(dev),
            ),
            "route_expand_launch",
        )
        LAUNCHES.n += 1
    return served, bytes_rd, layers_used, miss_after, straggler, wan
