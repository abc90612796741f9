"""Warm-started DHD steady state for streaming updates.

The store keeps the previous equilibrium heat field; a mutation batch only
perturbs the field near the touched vertices, so the new equilibrium is
reached in far fewer sweeps than a cold solve:

  1. *frontier pre-solve* — extract the touched frontier plus a one-ring halo,
     clamp the halo to its current (globally-correct) heat, and relax the
     frontier on the small sub-ELL;
  2. *global sweeps* — run full-graph DHD steps from the pre-solved field
     until the residual drops below tolerance.

Both phases go through :func:`repro_torch.kernels.ops.dhd_step`: the
single-field CUDA kernels on the card, their plain version on the CPU.  The
host mirror (``cols``, ``vals``, ``heat``, ``q``) is numpy, as in the JAX
package; the adjacency lives on ``device`` as tensors and is patched
row-wise per batch (only touched rows are recomputed) rather than rebuilt.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.dhd import DHDParams, steady_state
from ..device import DeviceLike, resolve_device
from ..kernels import ops

__all__ = ["StreamingHeat", "WarmStats", "STREAMING_DHD_PARAMS"]

# Constant-source fixed-point iteration needs the Theorem-1 contraction
# regime; the paper's alpha=0.5 placement default is tuned for the *decaying*
# source runs and overshoots ||L_dir||_inf here.  alpha below is only an
# upper cap — ``StreamingHeat._effective_alpha`` clamps it per graph so the
# update map is a contraction with a unique equilibrium.
STREAMING_DHD_PARAMS = DHDParams(alpha=0.05, gamma=0.1, beta=0.3)


@dataclasses.dataclass
class WarmStats:
    frontier_size: int
    halo_size: int
    local_iters: int
    global_iters: int
    residual: float  # sup-norm step size at exit: carried-over staleness


def _round8(k: int) -> int:
    return max(8, int(np.ceil(k / 8.0)) * 8)


# Rows are padded to a multiple of this, as in the JAX package, so the
# arrays stay index-for-index equal to its own.  Pad rows are isolated
# self-loops with zero weight and zero source, so they hold heat 0 forever.
_ROW_PAD = 256


def _padded(n: int) -> int:
    return max(_ROW_PAD, int(np.ceil(n / _ROW_PAD)) * _ROW_PAD)


def _sym_halves(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each undirected edge as two directed halves (u->v and v->u)."""
    uu = np.concatenate([src, dst]).astype(np.int64)
    vv = np.concatenate([dst, src]).astype(np.int64)
    ww = np.concatenate([w, w]).astype(np.float32)
    return uu, vv, ww


def _fill_rows(
    cols: np.ndarray,
    vals: np.ndarray,
    rows: np.ndarray,
    uu: np.ndarray,
    vv: np.ndarray,
    ww: np.ndarray,
) -> bool:
    """Recompute the ELL rows in ``rows`` from directed halves (uu -> vv).

    Returns False when some row overflows kmax (caller must rebuild)."""
    kmax = cols.shape[1]
    sel = np.isin(uu, rows)
    uu, vv, ww = uu[sel], vv[sel], ww[sel]
    order = np.argsort(uu, kind="stable")
    uu, vv, ww = uu[order], vv[order], ww[order]
    counts = np.bincount(uu, minlength=cols.shape[0])
    if counts[rows].max(initial=0) > kmax:
        return False
    # reset to self-pad, then scatter each row's neighbor run
    cols[rows] = rows[:, None]
    vals[rows] = 0.0
    starts = np.zeros(cols.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for u in rows.tolist():
        lo, hi = int(starts[u]), int(starts[u + 1])
        k = hi - lo
        if k:
            cols[u, :k] = vv[lo:hi]
            vals[u, :k] = ww[lo:hi]
    return True


class StreamingHeat:
    """Persistent DHD equilibrium over the alive graph, warm-updated per batch.

    ``rebuild`` performs the cold construction (and is the overflow fallback);
    ``update`` patches the touched ELL rows and re-solves warm.  The sweeps
    run on ``device`` (``None`` = the card).
    """

    def __init__(
        self,
        params: DHDParams = STREAMING_DHD_PARAMS,
        max_iters: int = 300,
        tol: float = 1e-6,
        device: DeviceLike = None,
    ) -> None:
        self.params = params
        self.alpha = params.alpha  # clamped per-graph by _effective_alpha
        self.max_iters = max_iters
        self.tol = tol
        self.device = resolve_device(device)
        self.n_nodes = 0
        self.cols: Optional[np.ndarray] = None  # [n, kmax] int32
        self.vals: Optional[np.ndarray] = None  # [n, kmax] float32
        self.heat: Optional[np.ndarray] = None  # [n] float32
        self.q: Optional[np.ndarray] = None  # [n] float32
        # staleness metric: sup-norm change of one more sweep from the field
        # the last solve() exited with (0 at equilibrium, >0 when the sweep
        # budget ran out first).  Surfaced via WarmStats / UpdateReport.
        self.residual: float = 0.0
        # device-resident adjacency; refreshed by row scatter on warm updates
        self._cols_j: Optional[torch.Tensor] = None
        self._vals_j: Optional[torch.Tensor] = None

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _sync_device(self, rows: Optional[np.ndarray] = None) -> None:
        """Mirror cols/vals to the device — full upload, or a row scatter
        when only ``rows`` changed (saves the [n, kmax] host->device copy
        that otherwise dominates small warm updates).  The scatter writes
        in place: nothing but this object holds the two tensors."""
        if (
            rows is None
            or self._cols_j is None
            or tuple(self._cols_j.shape) != self.cols.shape
        ):
            self._cols_j = self._to_device(self.cols)
            self._vals_j = self._to_device(self.vals)
        elif len(rows):
            idx = self._to_device(np.asarray(rows, np.int64))
            self._cols_j.index_copy_(0, idx, self._to_device(self.cols[rows]))
            self._vals_j.index_copy_(0, idx, self._to_device(self.vals[rows]))

    @property
    def vertex_heat(self) -> Optional[np.ndarray]:
        """Equilibrium heat for the real vertices (pad rows stripped)."""
        return None if self.heat is None else self.heat[: self.n_nodes]

    def _effective_alpha(self) -> float:
        """Clamp alpha into the Theorem-1 contraction regime.

        ||L_dir||_inf <= max_e A_e + max_v weighted_deg(v) for any heat
        ordering (out-flows average over |N^out|, in-flows are bounded by the
        incident weight sum), so alpha <= 0.5 * gamma / ((1-gamma) * bound)
        makes the update map a contraction.  That is what guarantees a
        *unique* steady state — without it the ReLU-gated flow has multiple
        equilibria and warm vs cold solves can land on different ones.
        Recomputed after every topology patch so warm updates and cold
        rebuilds of the same graph always iterate the same map.
        """
        p = self.params
        wdeg = float(self.vals.sum(axis=1).max(initial=0.0))
        wmax = float(self.vals.max(initial=0.0))
        bound = wmax + wdeg
        if bound <= 0.0:
            return p.alpha
        safe = 0.5 * p.gamma / ((1.0 - p.gamma) * bound)
        return min(p.alpha, safe)

    def adopt(
        self,
        cols: np.ndarray,
        vals: np.ndarray,
        heat: np.ndarray,
        q: np.ndarray,
        alpha: float,
        n_nodes: int,
    ) -> None:
        """Take over a built field (padded ELL, heat, sources, clamped
        alpha) without solving, e.g. one carried across from the JAX
        package by :func:`repro_torch.convert.streaming_heat_from_numpy`."""
        self.cols = np.array(cols, dtype=np.int32)
        self.vals = np.array(vals, dtype=np.float32)
        self.heat = np.array(heat, dtype=np.float32)
        self.q = np.array(q, dtype=np.float32)
        self.alpha = float(alpha)
        self.n_nodes = int(n_nodes)
        self._sync_device()

    # ----------------------------------------------------------- cold path
    def rebuild(
        self,
        n_nodes: int,
        src: np.ndarray,
        dst: np.ndarray,
        weights: np.ndarray,
        q: np.ndarray,
        heat0: Optional[np.ndarray] = None,
    ) -> int:
        """Cold build of the symmetric ELL + full solve.  Returns iterations.

        ``heat0`` warm-seeds the solve from a prior field of length
        ``n_nodes`` — the compaction re-key path, where the topology arrays
        are renumbered but the equilibrium is (row-permuted) unchanged."""
        uu, vv, ww = _sym_halves(src, dst, weights)
        deg = np.bincount(uu, minlength=n_nodes) if len(uu) else np.zeros(n_nodes, np.int64)
        # one extra octet of headroom so streaming edge growth rarely
        # overflows a row (overflow forces a cold rebuild)
        kmax = _round8(int(deg.max(initial=1)) + 8)
        n_pad = _padded(n_nodes)
        self.n_nodes = n_nodes
        self.cols = np.repeat(np.arange(n_pad, dtype=np.int32)[:, None], kmax, axis=1)
        self.vals = np.zeros((n_pad, kmax), np.float32)
        if len(uu):
            _fill_rows(self.cols, self.vals, np.arange(n_nodes), uu, vv, ww)
        self.q = np.zeros(n_pad, np.float32)
        self.q[:n_nodes] = np.asarray(q, np.float32)
        self.heat = self.q.copy()
        if heat0 is not None:
            self.heat[:n_nodes] = np.asarray(heat0, np.float32)
        self.alpha = self._effective_alpha()
        self._sync_device()
        return self.solve()

    # --------------------------------------------------------------- solve
    def _sweep(
        self, heat: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, q: torch.Tensor
    ) -> torch.Tensor:
        p = self.params
        return ops.dhd_step(
            heat, cols, vals, q, alpha=self.alpha, gamma=p.gamma, beta=p.beta
        )

    def solve(self, max_iters: Optional[int] = None, tol: Optional[float] = None) -> int:
        """Full-graph sweeps from the current field until the residual < tol.

        Runs through :func:`repro_torch.core.dhd.steady_state`, which reads
        the residual back every few sweeps and returns the JAX package's
        exact iteration count."""
        max_iters = max_iters or self.max_iters
        tol = tol or self.tol
        if self._cols_j is None:
            self._sync_device()
        cols = self._cols_j
        vals = self._vals_j
        q = self._to_device(self.q)
        h, it = steady_state(
            self._to_device(self.heat),
            lambda hh, qq: self._sweep(hh, cols, vals, qq),
            lambda k: q,
            max_iters=max_iters,
            tol=tol,
        )
        self.heat = h.cpu().numpy().copy()  # a host copy the warm path writes into
        # one probe sweep prices the carried-over staleness: how far one more
        # iteration would still move the field (0 when converged within tol)
        self.residual = float((self._sweep(h, cols, vals, q) - h).abs().max())
        return int(it)

    # ---------------------------------------------------------- warm path
    def _neighbors_of(self, mask: np.ndarray) -> np.ndarray:
        """Vertices adjacent to the masked set (via the current ELL rows)."""
        rows = np.where(mask)[0]
        if len(rows) == 0:
            return np.zeros(0, np.int64)
        nb = self.cols[rows][self.vals[rows] > 0]
        return np.unique(nb.astype(np.int64))

    def update(
        self,
        n_nodes: int,
        src: np.ndarray,
        dst: np.ndarray,
        weights: np.ndarray,
        q: np.ndarray,
        touched: np.ndarray,
        halo_hops: int = 1,
        local_iters: int = 16,
        max_frontier_frac: float = 0.2,
    ) -> WarmStats:
        """Absorb a topology/source delta and re-solve warm.

        ``src/dst/weights`` describe the *alive* undirected edges of the new
        graph; ``touched`` are the vertices whose incident edges or sources
        changed (new vertices included, ids at the end of the range).
        """
        if self.cols is None:
            it = self.rebuild(n_nodes, src, dst, weights, q)
            return WarmStats(n_nodes, 0, 0, it, self.residual)
        n_pad_old = self.cols.shape[0]
        if n_nodes > n_pad_old:
            n_pad = _padded(n_nodes)
            kmax = self.cols.shape[1]
            extra = n_pad - n_pad_old
            pad_cols = np.repeat(
                np.arange(n_pad_old, n_pad, dtype=np.int32)[:, None], kmax, axis=1
            )
            self.cols = np.concatenate([self.cols, pad_cols])
            self.vals = np.concatenate([self.vals, np.zeros((extra, kmax), np.float32)])
            self.heat = np.concatenate([self.heat, np.zeros(extra, np.float32)])
        self.n_nodes = n_nodes
        self.q = np.zeros(self.cols.shape[0], np.float32)
        self.q[:n_nodes] = np.asarray(q, np.float32)

        touched = np.unique(np.asarray(touched, np.int64))
        uu, vv, ww = _sym_halves(src, dst, weights)
        if not _fill_rows(self.cols, self.vals, touched, uu, vv, ww):
            # a touched row outgrew kmax — cold rebuild fallback
            it = self.rebuild(n_nodes, src, dst, weights, q)
            return WarmStats(len(touched), 0, 0, it, self.residual)
        self.alpha = self._effective_alpha()
        self._sync_device(rows=touched)

        # --- frontier pre-solve over F + clamped halo ---------------------
        # Only worth it when the frontier stays a small fraction of the
        # graph; at high churn the expansion covers nearly every vertex and
        # the local phase would just duplicate the global sweeps.
        n_pad = self.cols.shape[0]
        local_done = 0
        frontier = touched
        bmask = cmask = None
        if len(touched) and len(touched) <= max_frontier_frac * n_nodes:
            fmask = np.zeros(n_pad, dtype=bool)
            fmask[touched] = True
            for _ in range(halo_hops):
                fmask[self._neighbors_of(fmask)] = True
            frontier = np.where(fmask)[0]
            bmask = np.zeros(n_pad, dtype=bool)
            bmask[self._neighbors_of(fmask)] = True
            bmask &= ~fmask
            # ghost ring: halo rows are kept complete so their |N^out| is
            # exact, which needs their out-of-halo neighbors present too
            cmask = np.zeros(n_pad, dtype=bool)
            cmask[self._neighbors_of(bmask)] = True
            cmask &= ~(fmask | bmask)
        if (
            bmask is not None
            and len(frontier) <= max_frontier_frac * n_nodes
            and len(frontier)
        ):
            sub = np.concatenate([frontier, np.where(bmask)[0], np.where(cmask)[0]])
            # pad the subproblem coarsely (1024-row quantum), as the JAX
            # package does (pad rows = isolated, clamped to 0)
            n_sub = max(1024, int(np.ceil(len(sub) / 1024.0)) * 1024)
            nf = len(frontier)
            lmap = np.full(n_pad, -1, dtype=np.int64)
            lmap[sub] = np.arange(len(sub))
            rows_fb = sub[: nf + int(bmask.sum())]
            cols_l = np.repeat(
                np.arange(n_sub, dtype=np.int32)[:, None], self.cols.shape[1], axis=1
            )
            vals_l = np.zeros((n_sub, self.cols.shape[1]), np.float32)
            cols_l[: len(rows_fb)] = lmap[self.cols[rows_fb]].astype(np.int32)
            vals_l[: len(rows_fb)] = self.vals[rows_fb]
            # everything past the frontier (halo, ghost ring, pad rows) is
            # clamped: a contiguous tail, reset by slice after each sweep
            clamp_np = np.zeros(n_sub - nf, np.float32)
            clamp_np[: len(sub) - nf] = self.heat[sub[nf:]]
            clamp_vals = self._to_device(clamp_np)
            q_np = np.zeros(n_sub, np.float32)
            q_np[: len(sub)] = self.q[sub]
            q_sub = self._to_device(q_np)
            h_np = np.zeros(n_sub, np.float32)
            h_np[: len(sub)] = self.heat[sub]
            cols_j, vals_j = self._to_device(cols_l), self._to_device(vals_l)

            def clamped_sweep(hh: torch.Tensor, qq: torch.Tensor) -> torch.Tensor:
                out = self._sweep(hh, cols_j, vals_j, qq)  # a fresh tensor
                out[nf:] = clamp_vals
                return out

            h_sub, k_local = steady_state(
                self._to_device(h_np),
                clamped_sweep,
                lambda k: q_sub,
                max_iters=local_iters,
                tol=self.tol,
            )
            local_done = int(k_local)
            self.heat[frontier] = h_sub[:nf].cpu().numpy()

        # --- global mop-up sweeps ----------------------------------------
        it = self.solve()
        return WarmStats(
            frontier_size=len(frontier),
            halo_size=0 if bmask is None else int(bmask.sum() + cmask.sum()),
            local_iters=local_done,
            global_iters=it,
            residual=self.residual,
        )
