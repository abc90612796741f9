"""Public kernel API: dispatch between the CUDA kernels and their plain versions.

Policy: for tensors on a CUDA device the hand-written kernels run (the
wrappers in :mod:`.dhd_spmv`, :mod:`.route_expand`, :mod:`.flash_attention`
and :mod:`.embedding_bag` launch them or raise),
and asking for any other form there raises; on the CPU the plain PyTorch
versions in :mod:`.ref` and the edge form of :mod:`repro_torch.core.dhd` run.
On the CPU ``use_kernel`` picks between the kernel wrapper's plain version and
the edge form (tests pin both).  Entry points that take numpy arrays take an
explicit ``device`` (``None`` = the card, see :mod:`repro_torch.device`).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from ..device import DeviceLike, resolve_device
from ..obs import get_registry
from . import ref
from .dhd_spmv import dhd_ell_step, dhd_ell_step_batch
from .embedding_bag import embedding_bag
from .flash_attention import flash_attention
from .route_expand import pack_ragged, ragged_buffers, ragged_int_views, unpack_ragged
from .route_expand import route_expand_ragged as _route_expand_ragged_kernel

__all__ = [
    "attention",
    "attention_pairs",
    "flash_attention_op",
    "bag_lookup",
    "dhd_step",
    "dhd_step_batch",
    "diffuse_batch",
    "edge_cache_stats",
    "route_expand_flat_ids",
]


# ------------------------------------------------------- dispatch telemetry
def _obs_t0() -> Optional[float]:
    """perf_counter() when telemetry is on, else None (zero-cost gate)."""
    return time.perf_counter() if get_registry().enabled else None


def _obs_dispatch(op: str, path: str, t0: Optional[float]) -> None:
    if t0 is None:
        return
    reg = get_registry()
    reg.counter("kernels.dispatch", op=op, path=path).inc()
    reg.histogram("kernels.op_time_s", op=op).observe(time.perf_counter() - t0)


# --------------------------------------------------- COO-tail edge recovery
# Rebuilding + deduping the full undirected edge list from (ELL, tail) is a
# host-side O(nnz log nnz) pass; callers that step the SAME adjacency every
# sweep hit a cache keyed on the *identity* of the inputs.  Entries hold
# strong references to their keys' tensors, so a live entry's ids can never
# be reused by a new object.  CONTRACT: adjacency tensors passed to
# dhd_step_batch with a tail must not be mutated in place afterwards, or the
# identity key would serve the pre-mutation edge list.
_EDGE_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_EDGE_CACHE_MAX = 8


def reset_kernel_caches() -> None:
    """Drop the identity-keyed edge cache (test isolation hook; it rebuilds
    lazily on next use)."""
    _EDGE_CACHE.clear()


def edge_cache_stats() -> dict:
    """Edge-cache hit/miss counts from the process-default registry
    (a disabled registry reports zeros)."""
    reg = get_registry()
    hits = reg.counter("kernels.edge_cache", event="hit").value
    misses = reg.counter("kernels.edge_cache", event="miss").value
    hits = 0.0 if hits != hits else hits  # NaN from the no-op singleton
    misses = 0.0 if misses != misses else misses
    total = hits + misses
    return {
        "hits": int(hits),
        "misses": int(misses),
        "hit_rate": hits / total if total else 0.0,
    }


def _tail_edges(
    n: int, cols, vals, tail_src, tail_dst, tail_val
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact undirected (a, b, w) covering ELL rows + COO tail, deduped on
    the canonical (min, max) key (an edge may sit in one endpoint's ELL row
    while overflowing the other's); on the device of ``cols``."""
    key = (n, id(cols), id(vals), id(tail_src), id(tail_dst), id(tail_val))
    hit = _EDGE_CACHE.get(key)
    if hit is not None:
        _EDGE_CACHE.move_to_end(key)
        get_registry().counter("kernels.edge_cache", event="hit").inc()
        return hit[1]
    cols_np, vals_np = cols.cpu().numpy(), vals.cpu().numpy()
    iu, ik = np.nonzero(vals_np > 0)
    e_src = np.concatenate([iu, tail_src.cpu().numpy()])
    e_dst = np.concatenate([cols_np[iu, ik], tail_dst.cpu().numpy()])
    e_w = np.concatenate([vals_np[iu, ik], tail_val.cpu().numpy()])
    a = np.minimum(e_src, e_dst)
    b = np.maximum(e_src, e_dst)
    _, first = np.unique(a.astype(np.int64) * n + b, return_index=True)
    dev = cols.device
    out = (
        torch.as_tensor(a[first], dtype=torch.int64, device=dev),
        torch.as_tensor(b[first], dtype=torch.int64, device=dev),
        torch.as_tensor(e_w[first], dtype=torch.float32, device=dev),
    )
    _EDGE_CACHE[key] = ((cols, vals, tail_src, tail_dst, tail_val), out)
    get_registry().counter("kernels.edge_cache", event="miss").inc()
    while len(_EDGE_CACHE) > _EDGE_CACHE_MAX:
        _EDGE_CACHE.popitem(last=False)
    return out


def _tail_raise_on_card(heat: torch.Tensor) -> None:
    if heat.device.type != "cpu":
        raise ValueError(
            "a COO tail takes the edge form, which has no kernel: "
            "pack a tail-free ELL (kmax = max degree) for the card"
        )


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       window: Optional[int]) -> torch.Tensor:
    """:func:`flash_attention` as a registered op: the CUDA kernel for
    tensors on the card (it raises there when the kernel does not build),
    its plain version on the CPU.  Registered so that ``FakeTensorMode``
    (the dry run) can run it by its fake form, the flop counter can count
    it, and autograd can differentiate it, the port of the JAX package's
    ``_attention_with_vjp``: the backward recomputes ``ref.attention_ref``
    from q, k and v and returns its VJP, so no ``S x S`` residual is stored
    between the passes.  That backward is plain PyTorch, as the
    reference's is plain jnp: it materialises the f32 scores and
    probabilities of one call."""
    return flash_attention(q, k, v, causal=causal, window=window)


@flash_attention_op.register_fake
def _(q, k, v, causal, window):
    return q.new_empty((q.shape[0], q.shape[1], q.shape[2], v.shape[3]))


def _flash_setup(ctx, inputs, output) -> None:
    q, k, v, causal, window = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window = causal, window


def _flash_backward(ctx, g):
    q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
    with torch.enable_grad():
        out = ref.attention_ref(q, k, v, causal=ctx.causal, window=ctx.window)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    # dense gradients: a DTensor region's caller may view them as its own
    # layout (the values are those of autograd's strided ones)
    return dq.contiguous(), dk.contiguous(), dv.contiguous(), None, None


flash_attention_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def attention_pairs(sq: int, skv: int, causal: bool, window: Optional[int]) -> int:
    """Unmasked (query, key) pairs of one head: queries suffix-aligned
    (query ``i`` sits at ``i + skv - sq``), causal keys at or before it,
    windowed keys within ``window`` of it."""
    q_pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(q_pos, skv - 1) if causal else np.full(sq, skv - 1, np.int64)
    lo = np.maximum(q_pos - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None,
                 **kwargs) -> int:
    """``2 * B * Hq * pairs * (Dqk + Dv)``: the q.k and p.v products over
    the unmasked pairs, the work the kernel's tiles need (the flash
    kernel's bound counts the same)."""
    b, hq, sq, dqk = q_shape
    return 2 * b * hq * attention_pairs(sq, k_shape[2], causal, window) * (dqk + v_shape[3])


def sharded_attention(q, k, v, fn, *rows):
    """``fn(q, k, v, *rows)`` (attention on ``[B, H, S, D]`` tensors) on
    DTensors, as a ``local_map`` region: batch over the data-parallel mesh
    dims, heads over ``model`` (the reference's ``constrain(q, dp, "model",
    None, None)`` and the same for the output), each dim only where the
    mesh axes divide it, as ``constrain`` fits; ``rows`` (per batch row,
    e.g. valid lengths) follow the batch split.  When the kv heads do not
    divide ``model`` but the q heads do, k and v are replicated over
    ``model`` and each rank takes the kv heads its q heads read (their
    gradients are then partial sums over ``model``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.sharding import fitted_spec, mesh_sizes

    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    qspec = fitted_spec(q.shape, (dp, "model", None, None), names, sizes) or (None,) * 4
    kspec = fitted_spec(k.shape, (dp, "model", None, None), names, sizes) or (None,) * 4
    heads_split = qspec[1] is not None
    kv_split = heads_split and kspec[1] is not None
    b_axes = qspec[0] if isinstance(qspec[0], tuple) else (qspec[0],)

    def pl(heads: bool):
        return tuple(
            Shard(0) if a in b_axes else Shard(1) if (a == "model" and heads) else Replicate()
            for a in names
        )

    kv_grad = tuple(Partial() if (a == "model" and heads_split and not kv_split) else p
                    for a, p in zip(names, pl(kv_split)))
    row_pl = tuple(Shard(0) if a in b_axes else Replicate() for a in names)
    group = q.shape[1] // k.shape[1]

    def local(q_, k_, v_, *rows_):
        if heads_split and not kv_split:  # the kv heads this rank's q heads read
            hq = q_.shape[1]
            h0 = mesh.get_local_rank("model") * hq
            if hq % group == 0:
                k_, v_ = k_[:, h0 // group:(h0 + hq) // group], v_[:, h0 // group:(h0 + hq) // group]
            else:
                k_ = k_.repeat_interleave(group, dim=1)[:, h0:h0 + hq]
                v_ = v_.repeat_interleave(group, dim=1)[:, h0:h0 + hq]
        return fn(q_, k_, v_, *rows_)

    region = local_map(
        local, out_placements=(pl(heads_split),),
        in_placements=(pl(heads_split), pl(kv_split), pl(kv_split)) + (row_pl,) * len(rows),
        in_grad_placements=(pl(heads_split), kv_grad, kv_grad) + (row_pl,) * len(rows),
        device_mesh=mesh, redistribute_inputs=True,
    )
    return region(q, k, v, *rows)


def attention(
    q: torch.Tensor,  # [B, Hq, Sq, Dqk]
    k: torch.Tensor,  # [B, Hkv, Skv, Dqk]
    v: torch.Tensor,  # [B, Hkv, Skv, Dv]
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Softmax attention through :func:`flash_attention_op` (the CUDA
    kernel on the card, its plain version on the CPU), differentiable:
    serving and training take the same forward.  On DTensors it runs
    sharded (:func:`sharded_attention`).  The kernel masks ragged sequence
    ends, so every shape takes it: unlike the JAX package there is no
    fallback for lengths its tiles do not divide."""
    from torch.distributed.tensor import DTensor

    t0 = _obs_t0()
    if isinstance(q, DTensor):
        out = sharded_attention(
            q, k, v, lambda q_, k_, v_: flash_attention_op(q_, k_, v_, causal, window))
    else:
        out = flash_attention_op(q, k, v, causal, window)
    _obs_dispatch("attention", "kernel", t0)
    return out


def bag_lookup(
    table: torch.Tensor,  # [V, D]
    indices: torch.Tensor,  # [B, L] ids in [0, V)
    weights: Optional[torch.Tensor] = None,  # [B, L]
    mode: str = "sum",
) -> torch.Tensor:
    """EmbeddingBag lookup (sum/mean) through :func:`embedding_bag` (the
    CUDA kernel on the card for every shape, its plain version on the CPU);
    ids go in as int32 and weights as f32."""
    t0 = _obs_t0()
    indices = indices.to(torch.int32).contiguous()
    if weights is not None:
        weights = weights.to(torch.float32).contiguous()
    out = embedding_bag(table, indices, weights, mode=mode)
    _obs_dispatch("bag_lookup", "kernel", t0)
    return out


def dhd_step(
    heat: torch.Tensor,  # [n]
    cols: torch.Tensor,  # [n, kmax]
    vals: torch.Tensor,  # [n, kmax]
    q: torch.Tensor,  # [n]
    tail_src: Optional[torch.Tensor] = None,
    tail_dst: Optional[torch.Tensor] = None,
    tail_val: Optional[torch.Tensor] = None,
    alpha: float = 0.5,
    gamma: float = 0.1,
    beta: float = 0.3,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """DHD update for one heat field over ELL (+ optional COO tail).

    Without a tail, :func:`dhd_ell_step` (the single-field CUDA kernels on
    the card, their plain version on the CPU); ``use_kernel=False`` takes
    the plain version directly, which the card refuses.  With a COO tail,
    the exact edge form over the cached undirected edge list on the CPU
    (tail edges change ``|N_u^out|`` globally, so the ELL pass cannot be
    patched additively); the edge form has no kernel, so a tail on the card
    raises."""
    t0 = _obs_t0()
    if tail_src is not None and tail_src.numel() > 0:
        _tail_raise_on_card(heat)
        n = heat.shape[0]
        a, b, w = _tail_edges(n, cols, vals, tail_src, tail_dst, tail_val)
        from ..core.dhd import dhd_step_edges

        out = dhd_step_edges(heat, a, b, w, q, n, alpha=alpha, gamma=gamma, beta=beta)
        _obs_dispatch("dhd_step", "tail_edges", t0)
        return out
    if use_kernel is False:
        if heat.device.type != "cpu":
            raise ValueError("dhd_step on the card runs the ELL kernels only")
        out = ref.dhd_ell_ref(heat, cols, vals, q, alpha=alpha, gamma=gamma, beta=beta)
        _obs_dispatch("dhd_step", "ref", t0)
        return out
    out = dhd_ell_step(heat, cols, vals, q, alpha=alpha, gamma=gamma, beta=beta)
    _obs_dispatch("dhd_step", "ell", t0)
    return out


def dhd_step_batch(
    heat: torch.Tensor,  # [B, n]
    cols: torch.Tensor,  # [n, kmax]
    vals: torch.Tensor,  # [n, kmax] shared or [B, n, kmax] per-batch
    q: torch.Tensor,  # [B, n]
    tail_src: Optional[torch.Tensor] = None,
    tail_dst: Optional[torch.Tensor] = None,
    tail_val: Optional[torch.Tensor] = None,
    alpha: float = 0.5,
    gamma: float = 0.1,
    beta: float = 0.3,
) -> torch.Tensor:
    """DHD update for B heat fields over ELL (+ optional COO tail).

    Without a tail, :func:`dhd_ell_step_batch` (the CUDA ELL kernels on the
    card, their plain version on the CPU).  With a COO tail, the exact
    batched edge form on the CPU (shared ``vals`` only — tail edges change
    ``|N_u^out|`` globally, so the ELL pass cannot be patched additively);
    the edge form has no kernel, so a tail on the card raises."""
    t0 = _obs_t0()
    if tail_src is not None and tail_src.numel() > 0:
        _tail_raise_on_card(heat)
        if vals.dim() == 3:
            raise ValueError("COO-tail batching requires shared [n, kmax] vals")
        n = heat.shape[1]
        a, b, w = _tail_edges(n, cols, vals, tail_src, tail_dst, tail_val)
        from ..core.dhd import dhd_step_edges_batch

        out = dhd_step_edges_batch(
            heat, a, b, w, q, n, alpha=alpha, gamma=gamma, beta=beta
        )
        _obs_dispatch("dhd_step_batch", "tail_edges", t0)
        return out
    out = dhd_ell_step_batch(heat, cols, vals, q, alpha=alpha, gamma=gamma, beta=beta)
    _obs_dispatch("dhd_step_batch", "ell", t0)
    return out


# --------------------------------------------------- batched diffusion loop
def _ell_pack_batch(
    n: int, src: np.ndarray, dst: np.ndarray, weight: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack an undirected edge list into tail-free symmetric ELL, vectorized.

    ``weight`` may be [m] (shared) or [B, m] (per-seed); the column structure
    is shared so per-seed variants differ only in ``vals``.  ``kmax`` is the
    maximum degree, so a power-law graph's hubs blow the table up: callers
    confine this to bounded-degree graphs (region graphs, clusters)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    uu = np.concatenate([src, dst])
    vv = np.concatenate([dst, src])
    w = np.asarray(weight, np.float32)
    wb = np.concatenate([w, w], axis=-1)  # [..., 2m]
    order = np.argsort(uu, kind="stable")
    uu, vv, wb = uu[order], vv[order], wb[..., order]
    counts = np.bincount(uu, minlength=n)
    kmax = max(int(counts.max(initial=1)), 1)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(uu)) - starts[uu]
    cols = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, kmax)).copy()
    cols[uu, pos] = vv.astype(np.int32)
    if w.ndim == 2:
        vals = np.zeros((w.shape[0], n, kmax), np.float32)
        vals[:, uu, pos] = wb
    else:
        vals = np.zeros((n, kmax), np.float32)
        vals[uu, pos] = wb
    return cols, vals


def diffuse_batch(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray,  # [m] shared or [B, m] per-seed
    seeds: np.ndarray,  # [B, n]
    base_heat: Optional[np.ndarray] = None,
    params=None,
    n_steps: int = 32,
    use_kernel: Optional[bool] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Backend for :func:`repro_torch.core.dhd.diffuse_affinity_batch`.

    Runs the decaying-source loop as a host loop of device steps: on the
    card, the CUDA ELL kernels (edge list packed tail-free once per call);
    on the CPU, the batched edge form with ``index_add_``, or with
    ``use_kernel=True`` the ELL kernels' plain version.  ``use_kernel=False``
    on the card raises: the edge form has no kernel."""
    from ..core.dhd import DHDParams, dhd_step_edges_batch, source_heat

    p = params or DHDParams()
    dev = resolve_device(device)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    elif not use_kernel and dev.type != "cpu":
        raise ValueError("diffuse_batch on the card runs the ELL kernels only")
    seeds_t = torch.as_tensor(np.asarray(seeds, np.float32), device=dev)
    if base_heat is None:
        h = seeds_t
    else:
        base = np.atleast_2d(np.asarray(base_heat, np.float32))
        h = seeds_t + torch.as_tensor(base, device=dev)
    half_life = max(n_steps / 4.0, 1.0)
    t0 = _obs_t0()
    if use_kernel:
        cols, vals = _ell_pack_batch(n_nodes, src, dst, weight)
        cols_t = torch.as_tensor(cols, device=dev)
        vals_t = torch.as_tensor(vals, device=dev)
        for k in range(n_steps):
            q = source_heat(seeds_t, k, half_life=half_life)
            h = dhd_ell_step_batch(
                h, cols_t, vals_t, q, alpha=p.alpha, gamma=p.gamma, beta=p.beta
            )
        _obs_dispatch("diffuse_batch", "kernel", t0)
    else:
        src_t = torch.as_tensor(np.asarray(src, np.int64), device=dev)
        dst_t = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
        w_t = torch.as_tensor(np.asarray(weight, np.float32), device=dev)
        for k in range(n_steps):
            q = source_heat(seeds_t, k, half_life=half_life)
            h = dhd_step_edges_batch(
                h, src_t, dst_t, w_t, q, n_nodes,
                alpha=p.alpha, gamma=p.gamma, beta=p.beta,
            )
        _obs_dispatch("diffuse_batch", "ref", t0)
    return h.cpu().numpy()


# ------------------------------------------------------ fused route expansion
# precomputed tag keys: the route dispatch sits inside the 5% serving
# telemetry budget, so it books two plain counters (count + cumulative
# seconds) instead of the P² histogram _obs_dispatch feeds
_ROUTE_OBS_KEYS = {
    path: ((("op", "route_expand"), ("path", path)),)
    for path in ("kernel", "ref")
}


def _route_obs(path: str, t0: Optional[float]) -> None:
    if t0 is None:
        return
    reg = get_registry()
    # handle pair memoized per registry (dropped with the instruments by
    # MetricsRegistry.clear()): two dict gets instead of two keyed lookups
    cache_key = "kernels.route:" + path
    pair = reg._handle_cache.get(cache_key)
    if pair is None:
        (key,) = _ROUTE_OBS_KEYS[path]
        pair = (
            reg.counter_keyed("kernels.dispatch", key),
            reg.counter_keyed("kernels.route_expand_time_s", key),
        )
        reg._handle_cache[cache_key] = pair
    pair[0].inc()
    pair[1].inc(time.perf_counter() - t0)


def _as_device(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dtype)


def route_expand_flat_ids(
    ids: np.ndarray,  # [N] item ids, the flat item stream
    bounds: np.ndarray,  # [R + 1] request offsets into the flat stream
    origin: np.ndarray,  # [R] origin DC per request
    tables,  # ([I] i32 bitmask, [I] f32 bytes, ...) on device
    comp,  # [hier + 1, D] layer component ids (numpy or a device tensor)
    device: DeviceLike = None,
    shift: int = 0,  # a size's units: size * 2**shift
) -> Tuple[np.ndarray, ...]:
    """Fused stepwise layered expansion of a flat stream of item ids over
    the tables a store keeps on ``device`` (each item's replica bitmask and
    f32 bytes, keyed by item id): the ragged CUDA kernel on the card, its
    plain version on the CPU; both produce the oracle's exact greedy picks
    and each read's bytes per DC as int64 units of ``2**-shift`` bytes.
    On the card the kernel reads each slot's entries by id, so the ids,
    offsets, origins and block order go up in one copy from pinned memory
    (``N + 3R + 1`` words) and all outputs come back in one.  Returns numpy
    ``(served [N] i8, layers_used [R] i32, miss_after [R, L+1] i32, units
    [R, D] i64, served_dcs [R] i32, n_miss [R] i32)``; the sums are exact
    where ``shift`` is the tables' (``core.route_tables.fold_shift``)."""
    dev = resolve_device(device)
    t0 = _obs_t0()
    N, R = len(ids), len(origin)
    D = comp.shape[1]
    L = comp.shape[0] - 1
    table_bits, table_sizes = tables[0], tables[1]
    origin = np.asarray(origin)
    if R and not (0 <= origin.min() and origin.max() < D):
        raise ValueError(f"origin DCs must lie in [0, {D})")
    if N and not (0 <= ids.min() and ids.max() < table_bits.shape[0]):
        raise ValueError(f"item ids must lie in [0, {table_bits.shape[0]})")
    on = table_bits.device
    if on.type != dev.type or (dev.index is not None and on != dev) or table_sizes.device != on:
        raise ValueError(f"the tables are on {on} and {table_sizes.device}, the call on {dev}")
    dev = on  # "cuda" names the card the tables are on
    if dev.type == "cpu":
        # the plain version makes a few hundred small ops a call: intra-op
        # threads gain little on them, and where other processes share the
        # host each op's barrier waits on descheduled threads (on 8 cores
        # shared by 6 processes, 20 ms a call on this thread, 2 s on 8)
        n_threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            outs = _route_expand_ragged_kernel(
                _as_device(ids, torch.int32, dev), table_bits, table_sizes,
                _as_device(bounds, torch.int32, dev), _as_device(origin, torch.int32, dev),
                _as_device(comp, torch.int32, dev), shift,
            )
        finally:
            torch.set_num_threads(n_threads)
        _route_obs("ref", t0)
    else:
        host = torch.empty(N + 3 * R + 1, dtype=torch.int32, pin_memory=True)
        _, n_long = pack_ragged(ids, bounds, origin, out=host.numpy())
        i, offsets, org, order = unpack_ragged(host.to(dev, non_blocking=True), N, R)
        out = ragged_buffers(N, R, D, L, dev)
        _route_expand_ragged_kernel(
            i, table_bits, table_sizes, offsets, org, _as_device(comp, torch.int32, dev), shift,
            order=order, n_long=n_long, out=out,
        )
        outs = ragged_int_views(out[0].cpu(), N, R, D, L)
        _route_obs("kernel", t0)
    served, units, layers_used, miss_after, served_dcs, n_miss = (o.numpy() for o in outs)
    return served, layers_used, miss_after, units, served_dcs, n_miss
