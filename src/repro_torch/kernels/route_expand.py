"""Fused stepwise layered routing expansion: CUDA kernel for Hopper.

Replaces ``_expand_kernel`` of the JAX package's ``kernels/route_expand.py``
(Pallas, TPU).  The kernel lives in ``csrc/route_expand.cu``: one warp per
request walks its own greedy (local items, then per layer the cluster DC
covering the most missing items, lowest DC id on ties, escalate on no
progress) and folds Eq. 1.  Requests need no lockstep: extra greedy passes
are idempotent, so per-request walks equal the block-lockstep oracle.

A request's walk is a chain of up to ``L * (D + 1)`` dependent passes, so
the kernel takes the latency of one warp's walk; its bytes (``R * K * 12``)
take less than a launch on an H100.  So every load of a request is issued
before its first use, and the walk and the fold touch no memory: lane ``l``
holds slots ``l + 32 j`` in registers (:func:`slots_instance` says how many
a lane), counts and argmax are warp reductions, and the picks are stored
once.  Past 256 slots each warp stages its slots in its own region of
shared memory instead.

For tensors on the CPU :func:`route_expand` takes the plain version,
:func:`repro_torch.kernels.ref.route_expand_ref`; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import ref
from .cuda_lib import check, library, register_counter, stream_ptr

__all__ = ["LAUNCHES", "MAX_DCS", "MAX_LAYERS", "MAX_SLOTS", "route_expand", "slots_instance"]

LAUNCHES = register_counter("route_expand")
MAX_DCS = 31  # one int32 bitmask per item, one warp lane per DC (bit 31 = sign)
MAX_LAYERS = 127  # per-layer masks and miss counts held one a lane, 4 words
# requests (warps) per CTA: 2 and 4 time the same on an H100, 8 up to 10%
# slower at batches of 64 and 256 (tools/kernel_ab.py)
BLOCK_R = 4
REG_SLOTS = (1, 2, 4, 8)  # the register instances' slots a lane: K <= 256
_SMEM_MAX = 232448  # dynamic shared memory a block may use on Hopper


def _smem_region(K: int) -> int:
    words = -(-K // 4) * 4  # bits and sizes as 4-byte words, picks as int8
    return 9 * words


MAX_SLOTS = _SMEM_MAX // 9 // 4 * 4  # the most item slots one warp stages


def slots_instance(K: int) -> int:
    """Item slots a lane holds in registers for ``K`` slots a request (the
    smallest of 1, 2, 4, 8 with ``32 * S >= K``), or 0 when ``K > 256`` and
    each warp stages its slots in shared memory.  Raises past
    :data:`MAX_SLOTS`, which no instance takes."""
    if K < 0 or K > MAX_SLOTS:
        raise ValueError(f"route_expand takes 0 to {MAX_SLOTS} item slots, got {K}")
    return next((s for s in REG_SLOTS if K <= 32 * s), 0)


def _check_inputs(bits, sizes, lens, origin, comp, rtt, ibw) -> None:
    if bits.dim() != 2:
        raise ValueError(f"bits must be [R, K], got {tuple(bits.shape)}")
    R, K = bits.shape
    if comp.dim() != 2 or comp.shape[0] < 1:
        raise ValueError(f"comp must be [L + 1, D], got {tuple(comp.shape)}")
    D = comp.shape[1]
    if D > MAX_DCS:
        raise ValueError(f"route_expand takes at most {MAX_DCS} DCs, got {D}")
    if comp.shape[0] - 1 > MAX_LAYERS:
        raise ValueError(f"route_expand takes at most {MAX_LAYERS} layers, got "
                         f"{comp.shape[0] - 1}")
    slots_instance(K)
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
        LAUNCHES.bump()
    return served, bytes_rd, layers_used, miss_after, straggler, wan
