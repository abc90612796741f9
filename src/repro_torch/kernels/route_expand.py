"""Fused stepwise layered routing expansion: CUDA kernel for Hopper.

Replaces ``_expand_kernel`` of the JAX package's ``kernels/route_expand.py``
(Pallas, TPU).  The kernel lives in ``csrc/route_expand.cu``: each request
walks its own greedy (local items, then per layer the cluster DC covering
the most missing items, lowest DC id on ties, escalate on no progress) and
folds its bytes per DC, Eq. 1's ``S_d``, exactly: as int64 units of
``2**-shift`` bytes (``core.route_tables.fold_shift``), with the DCs that
served it as a bitmask and its unresolved items.  The Eq. 1 latencies and
WAN bytes are the host's, from those sums.  Requests need no lockstep:
extra greedy passes are idempotent, so per-request walks equal the
block-lockstep oracle.

:func:`route_expand_ragged` takes the flat item stream as the router holds
it (item ids, request offsets, origins) over tables keyed by item id that
stay on the card (each item's replica bitmask and bytes,
``core.route_tables.RouteTables``): no ``[R, K]`` tile, so no padding, no
bound on a request's length, and a call uploads the ids, offsets, origins
and block order alone.  A caller with the rows in hand passes them as the
tables over ids ``0 .. N - 1``.  A warp walks a request of up to
:data:`WARP_SHARE` slots; a longer one gets a block of 512 threads of its
own.  A request's walk is a chain of up to ``L * (D + 1)`` dependent
passes, so a launch takes the latency of its longest walk, not its bytes.
An item is missing exactly while its bitmask shares no bit with the DCs
taken so far, so a pass reads the bits where they lie and no slot is
staged.

For tensors on the CPU the wrapper takes its plain version
(:func:`repro_torch.kernels.ref.route_expand_ragged_ids_ref`); for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import ref
from .cuda_lib import check, library, register_counter, stream_ptr

__all__ = ["MAX_DCS", "MAX_LAYERS", "RAGGED_LAUNCHES", "WARP_SHARE", "pack_ragged",
           "ragged_buffers", "ragged_int_views", "ragged_order", "route_expand_ragged",
           "unpack_ragged"]

RAGGED_LAUNCHES = register_counter("route_expand_ragged")
MAX_DCS = 31  # one int32 bitmask per item, one warp lane per DC (bit 31 = sign)
MAX_LAYERS = 127  # per-layer masks and miss counts held one a lane, 4 words
# slots a warp of the ragged kernel walks alone (8 a lane); a longer request
# gets a block of its own
WARP_SHARE = 256


def _check_comp(comp) -> None:
    if comp.dim() != 2 or comp.shape[0] < 1:
        raise ValueError(f"comp must be [L + 1, D], got {tuple(comp.shape)}")
    if comp.shape[1] > MAX_DCS:
        raise ValueError(f"route_expand takes at most {MAX_DCS} DCs, got {comp.shape[1]}")
    if comp.shape[0] - 1 > MAX_LAYERS:
        raise ValueError(f"route_expand takes at most {MAX_LAYERS} layers, got "
                         f"{comp.shape[0] - 1}")


def _check_like(ids, shapes) -> None:
    """Each ``(name, tensor, shape, dtype)`` of ``shapes`` as the launch
    needs it: that shape and dtype, contiguous, on ``ids``' device."""
    for name, t, shape, dt in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != ids.device:
            raise ValueError(f"{name} is on {t.device}, ids on {ids.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ragged_order(lens: np.ndarray) -> Tuple[np.ndarray, int]:
    """``(order [R] i32, n_long)``: the requests longer than
    :data:`WARP_SHARE`, each walked by a block, then the rest, a warp each."""
    long = lens > WARP_SHARE
    order = np.concatenate([np.flatnonzero(long), np.flatnonzero(~long)]).astype(np.int32)
    return order, int(long.sum())


def pack_ragged(ids: np.ndarray, bounds: np.ndarray, origin: np.ndarray,
                out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, int]:
    """The ragged inputs in one int32 buffer, for one upload: ``(buf,
    n_long)`` with ``buf = [ids N | offsets R + 1 | origin R | order R]``;
    written into ``out`` when given (pinned memory, say).
    :func:`unpack_ragged` takes it apart again."""
    N, R = len(ids), len(origin)
    order, n_long = ragged_order(np.diff(bounds))
    buf = np.empty(N + 3 * R + 1, np.int32) if out is None else out
    buf[:N] = ids
    buf[N:N + R + 1] = bounds
    buf[N + R + 1:N + 2 * R + 1] = origin
    buf[N + 2 * R + 1:] = order
    return buf, n_long


def unpack_ragged(buf: torch.Tensor, N: int, R: int) -> Tuple[torch.Tensor, ...]:
    """``(ids, offsets, origin, order)`` as views of a :func:`pack_ragged`
    buffer."""
    return buf[:N], buf[N:N + R + 1], buf[N + R + 1:N + 2 * R + 1], buf[N + 2 * R + 1:]


def ragged_int_views(ints: torch.Tensor, N: int, R: int, D: int,
                     L: int) -> Tuple[torch.Tensor, ...]:
    """The outputs, in :func:`route_expand_ragged`'s order, as views of one
    int32 buffer laid out ``[units (as int64) | layers_used | miss_after |
    served_dcs | n_miss | served]``: ``(served [N] i8, units [R, D] i64,
    layers_used [R] i32, miss_after [R, L+1] i32, served_dcs [R] i32,
    n_miss [R] i32)``."""
    u = 2 * R * D  # the int64 sums first, on the buffer's aligned start
    m = u + R * (L + 2)
    return (ints[m + 2 * R:].view(torch.int8)[:N], ints[:u].view(torch.int64).view(R, D),
            ints[u:u + R], ints[u + R:m].view(R, L + 1), ints[m:m + R], ints[m + R:m + 2 * R])


def ragged_buffers(N: int, R: int, D: int, L: int, device) -> Tuple[torch.Tensor, ...]:
    """The ragged outputs as views of one int32 buffer, so a caller reads
    them all back in one copy: ``(ints, *outputs)``, the outputs as
    :func:`ragged_int_views` lays them out in ``ints``."""
    ints = torch.empty(2 * R * D + R * (L + 4) + -(-N // 4), dtype=torch.int32, device=device)
    return (ints, *ragged_int_views(ints, N, R, D, L))


def _check_ragged(ids, table_bits, table_sizes, offsets, origin, order, comp) -> None:
    _check_comp(comp)
    N, I, R = ids.shape[0], table_bits.shape[0], origin.shape[0]
    _check_like(ids, (
        ("ids", ids, (N,), torch.int32), ("table_bits", table_bits, (I,), torch.int32),
        ("table_sizes", table_sizes, (I,), torch.float32),
        ("offsets", offsets, (R + 1,), torch.int32), ("origin", origin, (R,), torch.int32),
        ("order", order, (R,), torch.int32), ("comp", comp, tuple(comp.shape), torch.int32),
    ))


def route_expand_ragged(
    ids: torch.Tensor,  # [N] i32 item ids, the flat item stream
    table_bits: torch.Tensor,  # [I] i32 replica bitmask an item id
    table_sizes: torch.Tensor,  # [I] f32 item bytes an item id
    offsets: torch.Tensor,  # [R + 1] i32 request r's items: [offsets[r], offsets[r + 1])
    origin: torch.Tensor,  # [R] i32 origin DC per request
    comp: torch.Tensor,  # [hier + 1, D] i32 layer component ids
    shift: int = 0,  # a size's units: size * 2**shift
    order: Optional[torch.Tensor] = None,  # [R] i32, long requests first
    n_long: Optional[int] = None,
    out: Optional[tuple] = None,  # ragged_buffers(...) to write into
) -> Tuple[torch.Tensor, ...]:
    """Same contract as ``ref.route_expand_ragged_ids_ref``: ``(served [N]
    i8, units [R, D] i64, layers_used [R] i32, miss_after [R, L+1] i32,
    served_dcs [R] i32, n_miss [R] i32)``, slot ``k`` reading
    ``table_bits[ids[k]]`` and ``table_sizes[ids[k]]``; every id must lie in
    ``[0, I)``.  ``order`` and ``n_long`` come from :func:`ragged_order`
    when not given."""
    if ids.device.type == "cpu":
        return ref.route_expand_ragged_ids_ref(ids, table_bits, table_sizes, offsets, origin,
                                               comp, shift)
    if ids.device.type != "cuda":
        raise ValueError(f"route_expand runs on cpu or cuda, not {ids.device}")
    dev = ids.device
    if order is None:
        order_np, n_long = ragged_order(np.diff(offsets.cpu().numpy()))
        order = torch.as_tensor(order_np, device=dev)
    _check_ragged(ids, table_bits, table_sizes, offsets, origin, order, comp)
    N, R = ids.shape[0], origin.shape[0]
    L, D = comp.shape[0] - 1, comp.shape[1]
    if out is None:
        out = ragged_buffers(N, R, D, L, dev)
    outputs = out[1:]
    lib = library().get()
    with torch.cuda.device(dev):
        check(
            lib.route_expand_ragged_ids_launch(
                ids.data_ptr(), table_bits.data_ptr(), table_sizes.data_ptr(),
                offsets.data_ptr(), origin.data_ptr(), order.data_ptr(), int(n_long),
                comp.data_ptr(), int(shift), *(o.data_ptr() for o in outputs), R, D, L,
                stream_ptr(dev),
            ),
            "route_expand_ragged_ids_launch",
        )
        RAGGED_LAUNCHES.bump()
    return outputs
