"""Directed Heat Diffusion (DHD) model — paper §V Eqs. (7)-(12), Theorem 1.

Vertices are thermal masses; access frequency is heat.  Per step, heat flows
along each undirected edge from the hotter to the colder endpoint:

    dH_uv = alpha * A_uv / |N_u^out| * ReLU(H_u - H_v)          (Eq. 7)
    H_v'  = (1-gamma) * [H_v + sum_in dH - sum_out dH] + beta*Q (Eqs. 8/10)

``|N_u^out|`` is the number of *lower-heat* neighbors of the hotter endpoint
(data-dependent).  Sources (Eq. 9) inject exponentially-decaying external
heat.  The steady state solves  gamma*H - alpha*(1-gamma)*L_dir*H = beta*Q
(Eq. 12); Theorem 1 gives the contraction bound
``alpha < gamma / ((1-gamma) * ||L_dir||_inf)``.

Two plain implementations on tensors (any device):
  * edge-list (``index_add_`` scatters) — used for arbitrary graphs;
  * dense Laplacian — used for small per-cluster solves and for validating
    the steady state against a direct linear solve (Theorem 1).
The hot path on the card is the ELL kernel pair of
:mod:`repro_torch.kernels.dhd_spmv`, dispatched by
:func:`repro_torch.kernels.ops.diffuse_batch`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = [
    "DHDParams",
    "dhd_step_edges",
    "dhd_step_edges_batch",
    "dhd_step_dense",
    "build_l_dir",
    "steady_state",
    "linear_steady_state",
    "convergence_alpha_bound",
    "source_heat",
    "diffuse_affinity",
    "diffuse_affinity_batch",
]


class DHDParams(NamedTuple):
    """Paper defaults: alpha=0.5, gamma=0.1, beta=0.3 (§V-B)."""

    alpha: float = 0.5
    gamma: float = 0.1
    beta: float = 0.3


# ----------------------------------------------------------------- edge form
def dhd_step_edges(
    heat: torch.Tensor,  # [n]
    src: torch.Tensor,  # [m] undirected edge endpoints
    dst: torch.Tensor,  # [m]
    weight: torch.Tensor,  # [m] A_uv  (edge initial heat / frequency)
    q: torch.Tensor,  # [n] external source heat this step
    n_nodes: int,
    alpha: float = 0.5,
    gamma: float = 0.1,
    beta: float = 0.3,
) -> torch.Tensor:
    """One DHD update (Eqs. 7-8) over an undirected edge list."""
    return dhd_step_edges_batch(
        heat[None], src, dst, weight, q[None], n_nodes,
        alpha=alpha, gamma=gamma, beta=beta,
    )[0]


def dhd_step_edges_batch(
    heat: torch.Tensor,  # [B, n]
    src: torch.Tensor,  # [m] shared undirected edge endpoints
    dst: torch.Tensor,  # [m]
    weight: torch.Tensor,  # [m] shared or [B, m] per-seed A_uv
    q: torch.Tensor,  # [B, n]
    n_nodes: int,
    alpha: float = 0.5,
    gamma: float = 0.1,
    beta: float = 0.3,
) -> torch.Tensor:
    """Batched DHD update: B independent heat fields over one edge list.

    With 2-D ``weight`` each row carries its own edge weights.  A zero weight
    means the edge is *absent*: it moves no heat and does not enter
    ``|N_u^out|`` (the ELL form's ``vals > 0`` gate), which lets batched
    callers share one edge list and switch edges off per row.  The B fields
    scatter into one flat ``[B * n]`` buffer per ``index_add_``."""
    B = heat.shape[0]
    src = src.long()
    dst = dst.long()
    hs = heat[:, src]  # [B, m]
    hd = heat[:, dst]
    hot_is_src = hs > hd
    hot = torch.where(hot_is_src, src, dst)  # [B, m]
    cold = torch.where(hot_is_src, dst, src)
    w = weight if weight.dim() == 2 else weight[None]
    active = (hs != hd) & (w > 0)
    zero = heat.new_zeros(())
    ones = torch.where(active, heat.new_ones(()), zero)
    row0 = (torch.arange(B, device=heat.device) * n_nodes)[:, None]
    hot_f = (hot + row0).reshape(-1)
    cold_f = (cold + row0).reshape(-1)

    def segsum(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return heat.new_zeros(B * n_nodes).index_add_(0, idx, vals.reshape(-1))

    # |N_u^out| = number of strictly-lower-heat neighbors of the hot endpoint
    n_out = segsum(ones, hot_f).clamp_min(1.0)
    flat = heat.reshape(-1)
    dh = alpha * w / n_out[hot_f].reshape(B, -1) * (
        flat[hot_f].reshape(B, -1) - flat[cold_f].reshape(B, -1)
    )
    dh = torch.where(active, dh, zero)
    delta = (segsum(dh, cold_f) - segsum(dh, hot_f)).reshape(B, n_nodes)
    return (1.0 - gamma) * (heat + delta) + beta * q


# ---------------------------------------------------------------- dense form
def build_l_dir(heat: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Directional Laplacian (Eq. 11) for the current heat field.

    ``(L)_vw = -A_vw/|N_v^out|`` if H_v > H_w (out-flow from v),
    ``(L)_vw = +A_wv/|N_w^out|`` if H_w > H_v (in-flow to v), else 0.
    Kept for Theorem-1 style analysis (fixed L at equilibrium); the dense
    update itself is :func:`dhd_step_dense`.
    """
    h = heat[:, None]
    hotter = h > h.T  # [v, w] True if H_v > H_w
    active = adj > 0
    out_mask = hotter & active  # v -> w flow (v loses)
    zero = adj.new_zeros(())
    n_out = out_mask.sum(dim=1, keepdim=True).clamp_min(1).to(adj.dtype)
    out_part = torch.where(out_mask, -adj / n_out, zero)
    in_mask = (~hotter) & (h.T > h) & active  # w -> v flow (v gains)
    n_out_w = out_mask.sum(dim=1).clamp_min(1).to(adj.dtype)  # |N_w^out| per row w
    in_part = torch.where(in_mask, adj / n_out_w[None, :], zero)
    return out_part + in_part


def dhd_step_dense(
    heat: torch.Tensor,  # [n]
    adj: torch.Tensor,  # [n, n] symmetric nonneg weights (A_uv)
    q: torch.Tensor,  # [n]
    alpha: float = 0.5,
    gamma: float = 0.1,
    beta: float = 0.3,
) -> torch.Tensor:
    """One DHD update in dense form — mathematically equal to the edge form."""
    h = heat
    diff = h[:, None] - h[None, :]  # diff[u,v] = H_u - H_v
    flow_mask = (diff > 0) & (adj > 0)  # u hotter than v
    n_out = flow_mask.sum(dim=1).clamp_min(1).to(h.dtype)  # |N_u^out|
    dh = alpha * adj / n_out[:, None] * torch.where(flow_mask, diff, h.new_zeros(()))
    # dh[u, v]: heat leaving u toward v
    delta = dh.sum(dim=0) - dh.sum(dim=1)  # gains - losses per vertex
    return (1.0 - gamma) * (h + delta) + beta * q


# ------------------------------------------------------------- steady state
_CHECK_EVERY = 8  # steps between convergence reads in steady_state


def steady_state(
    heat0: torch.Tensor,
    step_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    q_fn: Callable[[int], torch.Tensor],
    max_iters: int = 200,
    tol: float = 1e-6,
) -> Tuple[torch.Tensor, int]:
    """Iterate ``heat <- step_fn(heat, q_fn(k))`` to a fixed point.

    Returns (H*, iterations-used): the first ``k`` whose step moved the
    field by less than ``tol`` in sup-norm, as the JAX package's
    ``while_loop`` stops.  A host loop; the per-step residuals stay on the
    device and are read back every ``_CHECK_EVERY`` steps, so the loop syncs
    with the device once per ``_CHECK_EVERY`` steps instead of every step
    (the few steps run past convergence are discarded)."""
    h = heat0
    hist = [h]
    res = []
    k = 0
    while k < max_iters:
        nh = step_fn(h, q_fn(k))
        res.append((nh - h).abs().max())
        h = nh
        hist.append(h)
        k += 1
        if len(res) == _CHECK_EVERY or k == max_iters:
            done = (torch.stack(res) < tol).nonzero()
            if len(done):
                first = int(done[0, 0])
                stop = k - len(res) + first + 1
                return hist[first + 1], stop
            res.clear()
            hist = [h]
    return h, k


def linear_steady_state(
    l_dir: torch.Tensor,
    q: torch.Tensor,
    alpha: float = 0.5,
    gamma: float = 0.1,
    beta: float = 0.3,
) -> torch.Tensor:
    """Direct solve of Eq. (12): H* = beta (gamma*I - alpha(1-gamma)L)^-1 Q*.

    Valid (unique, nonneg for M-matrix L) under the Theorem-1 bound."""
    n = l_dir.shape[0]
    eye = torch.eye(n, dtype=l_dir.dtype, device=l_dir.device)
    a = gamma * eye - alpha * (1.0 - gamma) * l_dir
    return beta * torch.linalg.solve(a, q)


def convergence_alpha_bound(l_dir: torch.Tensor, gamma: float = 0.1) -> float:
    """Theorem 1: alpha < gamma / ((1-gamma) ||L||_inf) guarantees contraction."""
    norm = float(l_dir.abs().sum(dim=1).max())
    if norm == 0.0:
        return float("inf")
    return gamma / ((1.0 - gamma) * norm)


# ------------------------------------------------------------------- sources
def source_heat(
    q0: torch.Tensor,  # [n] initial source heat (1/|O| on sources, else 0)
    k: int,  # step index
    half_life: float = 8.0,
    extra: Optional[torch.Tensor] = None,  # dQ * sum(sigma_v) access term
) -> torch.Tensor:
    """Source dynamics (Eq. 9): q0 * exp(-pi*k) + extra, pi = ln2/T_hl.

    The decay factor is computed in f32 as the JAX package does with 64-bit
    mode off."""
    pi = np.float32(np.log(2.0) / half_life)
    q = q0 * float(np.exp(np.float32(-pi) * np.float32(k), dtype=np.float32))
    if extra is not None:
        q = q + extra
    return q


# --------------------------------------------------- placement-affinity runs
def diffuse_affinity(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray,
    seed_heat: np.ndarray,  # [n] heat injected at the BS's held regions
    base_heat: Optional[np.ndarray] = None,
    params: DHDParams = DHDParams(),
    n_steps: int = 32,
    device: DeviceLike = None,
) -> np.ndarray:
    """Heat reaching each node when ``seed_heat`` diffuses over the region
    graph (paper Fig. 4 competition).  Sources decay with half-life
    ``n_steps/4`` so the run terminates with a stable field.  Always the
    edge form, as in the JAX package; it has no kernel, so it runs on the
    CPU only (the card takes :func:`diffuse_affinity_batch`).  Returns np.
    """
    dev = resolve_device(device)
    if dev.type != "cpu":
        raise ValueError(
            "diffuse_affinity is the edge form, which has no kernel: use "
            "diffuse_affinity_batch (PlacementConfig.dhd_batch=True) on the card"
        )
    if len(src) == 0:
        return np.asarray(seed_heat, dtype=np.float32)
    src_t = torch.as_tensor(np.asarray(src, np.int64), device=dev)
    dst_t = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
    w_t = torch.as_tensor(np.asarray(weight, np.float32), device=dev)
    h0 = seed_heat if base_heat is None else seed_heat + base_heat
    h = torch.as_tensor(np.asarray(h0, np.float32), device=dev)
    q0 = torch.as_tensor(np.asarray(seed_heat, np.float32), device=dev)
    half_life = max(n_steps / 4.0, 1.0)
    for k in range(n_steps):
        q = source_heat(q0, k, half_life=half_life)
        h = dhd_step_edges(
            h, src_t, dst_t, w_t, q, n_nodes,
            alpha=params.alpha, gamma=params.gamma, beta=params.beta,
        )
    return h.cpu().numpy()


def diffuse_affinity_batch(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray,  # [m] shared or [B, m] per-seed weights
    seeds: np.ndarray,  # [B, n] heat injected per seed vector
    base_heat: Optional[np.ndarray] = None,  # [n] or [B, n]
    params: DHDParams = DHDParams(),
    n_steps: int = 32,
    use_kernel: Optional[bool] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Batched :func:`diffuse_affinity`: B seed vectors, ONE diffusion run.

    Row ``b`` equals ``diffuse_affinity(n_nodes, src, dst, weight[b], ...,
    seeds[b])`` — per-seed weights let callers share an edge-list union and
    deactivate edges per seed with zero weight (the placement arena's
    per-candidate super-node topologies).  Dispatch lives in
    :func:`repro_torch.kernels.ops.diffuse_batch`: the CUDA ELL kernels on
    the card, the batched edge form on the CPU.
    """
    seeds = np.atleast_2d(np.asarray(seeds, dtype=np.float32))
    if len(src) == 0:
        return seeds.copy()
    from ..kernels import ops  # local: kernels.ops imports this module lazily

    return ops.diffuse_batch(
        n_nodes, src, dst, weight, seeds, base_heat=base_heat,
        params=params, n_steps=n_steps, use_kernel=use_kernel, device=device,
    )
