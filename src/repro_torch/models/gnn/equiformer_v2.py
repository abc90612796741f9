"""EquiformerV2 — equivariant graph attention via eSCN SO(2) convolutions
(arXiv:2306.12059; eSCN trick arXiv:2302.03655).

Port of ``repro/models/gnn/equiformer_v2.py``.  Per attention layer, for
each edge (src -> dst):
  1. rotate source-node irreps [dim(l_max), C] into the edge frame with the
     real Wigner-D transpose (``wigner.py``, validated to l_max=6);
  2. truncate to |m| <= m_max coefficients (the eSCN O(L^3) reduction);
  3. SO(2) linear maps per |m| — joint (l, channel) mixing; for m>0 the
     (+m, -m) pair mixes with the rotation-structured (W1, W2) pair;
     radially-conditioned channel gates (RBF -> MLP) modulate the message;
  4. per-head attention logits from the invariant (m=0) block,
     segment-softmax over each destination's incoming edges;
  5. rotate messages back to the global frame and aggregate.
FFN is the gated equivariant MLP (l=0 scalars gate all l).  The per-layer
params are stacked on a leading ``[n_layers, ...]`` axis as in the JAX
package (which scans over them); the forward unbinds the stack once and
runs the layers as a Python loop.  The JAX package's ``.at[].set`` scatters
are indexed writes into fresh zero tensors here, which autograd
differentiates.

Deviation noted (DESIGN §9): radial conditioning multiplies per-channel
gates rather than modulating the full SO(2) weight matrices (memory-lean,
same dataflow class).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...distributed.constraints import is_dtensor
from ..layers import Params, mlp, mlp_init, normal, stack, take_rows, unstack
from .common import masked_segment_max, masked_segment_sum, shard_ragged
from .schnet import gaussian_rbf
from .wigner import dir_to_angles, irreps_dim, rotate_irreps, wigner_d_blocks

__all__ = ["EqV2Spec", "eqv2_init", "eqv2_forward", "layer_apply", "layer_apply_chunked",
           "prepare_geometry"]


@dataclasses.dataclass(frozen=True)
class EqV2Spec:
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 32
    cutoff: float = 8.0
    n_species: int = 32

    @property
    def dim(self) -> int:
        return irreps_dim(self.l_max)

    def m_indices(self) -> Dict[int, Dict[str, np.ndarray]]:
        """Static index maps: for each |m| <= m_max the irreps positions of
        the +m and -m components across l (edge-frame truncated set)."""
        out = {}
        for m in range(self.m_max + 1):
            plus, minus = [], []
            for l in range(m, self.l_max + 1):
                base = l * l  # start of degree-l block
                plus.append(base + l + m)
                minus.append(base + l - m)
            out[m] = {
                "plus": np.asarray(plus, np.int32),
                "minus": np.asarray(minus, np.int32),
            }
        return out


def _so2_init(generator: torch.Generator, spec: EqV2Spec, device: torch.device) -> Params:
    p: Params = {}
    c = spec.channels
    for m in range(spec.m_max + 1):
        n_l = spec.l_max + 1 - m
        dim = n_l * c
        s = 1.0 / math.sqrt(dim)
        p[f"w1_{m}"] = normal(generator, (dim, dim), s, device)
        if m > 0:
            p[f"w2_{m}"] = normal(generator, (dim, dim), s, device)
    return p


def _layer_init(generator: torch.Generator, spec: EqV2Spec, device: torch.device) -> Params:
    c = spec.channels
    return {
        "so2": _so2_init(generator, spec, device),
        "radial": mlp_init(generator, (spec.n_rbf, c, c), device),
        "attn": mlp_init(generator, (c, c, spec.n_heads), device),
        "out": normal(generator, (spec.l_max + 1, c, c), 1.0 / math.sqrt(c), device),
        "ffn_gate": mlp_init(generator, (c, 2 * c, (spec.l_max + 1) * c), device),
        "ffn_mix": normal(generator, (spec.l_max + 1, c, c), 1.0 / math.sqrt(c), device),
        "ln_scale": torch.ones((spec.l_max + 1, c), dtype=torch.float32, device=device),
    }


def eqv2_init(generator: torch.Generator, spec: EqV2Spec, d_out: int = 1,
              device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    return {
        "embed": normal(generator, (spec.n_species, spec.channels), 0.1, dev),
        "layers": stack([_layer_init(generator, spec, dev) for _ in range(spec.n_layers)]),
        "dec": mlp_init(generator, (spec.channels, spec.channels, d_out), dev),
    }


def _equiv_layernorm(x: torch.Tensor, scale: torch.Tensor, spec: EqV2Spec) -> torch.Tensor:
    """Norm over each degree-l block (rotation-invariant RMS), per-channel scale."""
    out = []
    for l, s in enumerate(scale.unbind(0)):
        seg = x[:, l * l : (l + 1) * (l + 1), :]
        rms = torch.sqrt(torch.mean(seg * seg, dim=(1, 2), keepdim=True) + 1e-6)
        out.append(seg / rms * s[None, None, :])
    return torch.cat(out, dim=1)


@functools.lru_cache(maxsize=None)
def _truncation(spec: EqV2Spec) -> Tuple[np.ndarray, Dict[int, Dict[str, np.ndarray]]]:
    """Truncated-index bookkeeping: the irreps positions kept in the edge
    frame (``tr_list``, in order of first use) and the position of each
    (l, +-m) in that truncated vector."""
    m_idx = spec.m_indices()
    tr_list: List[int] = []
    tr_pos: Dict[int, Dict[str, np.ndarray]] = {}
    for m in range(spec.m_max + 1):
        d_ = {}
        for sgn in ("plus", "minus"):
            posn = []
            for i in m_idx[m][sgn]:
                if int(i) not in tr_list:
                    tr_list.append(int(i))
                posn.append(tr_list.index(int(i)))
            d_[sgn] = np.asarray(posn, np.int32)
        tr_pos[m] = d_
    return np.asarray(tr_list, np.int32), tr_pos


@functools.lru_cache(maxsize=None)
def _truncation_on(spec: EqV2Spec, device: torch.device):
    """:func:`_truncation`'s index arrays as int64 tensors on ``device``."""
    tr_arr, tr_pos = _truncation(spec)
    on = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)  # noqa: E731
    return on(tr_arr), {m: {k: on(v) for k, v in d.items()} for m, d in tr_pos.items()}


def _so2_conv(
    msg_tr: torch.Tensor,  # [E, dim_tr, C] edge-frame truncated features
    so2: Params,
    spec: EqV2Spec,
    tr_pos: Dict[int, Dict[str, torch.Tensor]],
) -> torch.Tensor:
    """Per-|m| SO(2) linear maps in the edge frame (joint l-channel mixing)."""
    e = msg_tr.shape[0]
    c = spec.channels
    out = msg_tr.new_zeros(msg_tr.shape)
    for m in range(spec.m_max + 1):
        pp = tr_pos[m]["plus"]
        mm = tr_pos[m]["minus"]
        n_l = len(pp)
        xp = _take_columns(msg_tr, pp).reshape(e, n_l * c)
        w1 = so2[f"w1_{m}"]
        if m == 0:
            yp = xp @ w1
            out = _put_columns(out, pp, yp.reshape(e, n_l, c))
        else:
            xm = _take_columns(msg_tr, mm).reshape(e, n_l * c)
            w2 = so2[f"w2_{m}"]
            yp = xp @ w1 - xm @ w2
            ym = xp @ w2 + xm @ w1
            out = _put_columns(out, pp, yp.reshape(e, n_l, c))
            out = _put_columns(out, mm, ym.reshape(e, n_l, c))
    return out


def _row_region(fn, *tensors: torch.Tensor) -> torch.Tensor:
    """``fn`` over DTensors as a ``local_map`` region on the first one's
    row split (its other dims whole): an indexed read or write of inner
    columns has no DTensor rule in every PyTorch version."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in tensors[0].placements)
    return local_map(fn, out_placements=(rows,), in_placements=(rows,) * len(tensors),
                     device_mesh=tensors[0].device_mesh, redistribute_inputs=True)(*tensors)


def _zeros_rows(like: torch.Tensor, *tail: int) -> torch.Tensor:
    """Zeros ``[like.shape[0], *tail]`` of ``like``'s dtype, its rows split
    as ``like``'s are (DTensor's ``new_zeros`` of another shape would
    replicate them)."""
    if not is_dtensor(like):
        return like.new_zeros((like.shape[0],) + tail)
    return _row_region(lambda t: t.new_zeros((t.shape[0],) + tail), like)


def _take_columns(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[:, idx, :]``."""
    if not is_dtensor(x):
        return x[:, idx, :]
    return _row_region(lambda x_: x_[:, idx, :], x)


def _put_columns(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst[:, idx, :] = src``, returning ``dst`` (on a DTensor written out
    of place, by ``index_copy``)."""
    if not is_dtensor(dst):
        dst[:, idx, :] = src
        return dst
    return _row_region(lambda d, s: torch.index_copy(d, 1, idx, s), dst, src)


def _edge_frames(pos, src, dst, emask, spec: EqV2Spec, pin=lambda v: v):
    """Each edge's mask (zero-length edges dropped), Wigner-D blocks and
    radial features; ``pin`` is applied to the edge vectors."""
    vec = pin(take_rows(pos, dst) - take_rows(pos, src))
    d2 = (vec * vec).sum(-1)
    dist = torch.sqrt(d2 + 1e-9)
    # zero-length edges (self-loops, padding) have no direction -> no frame;
    # they MUST be masked or equivariance breaks (frame fixed, features rotate).
    # Mask on the raw squared distance (the eps floor in `dist` would leak).
    directed = d2 > 1e-8
    emask = directed if emask is None else (emask.bool() & directed)
    theta, phi = dir_to_angles(vec)
    blocks = wigner_d_blocks(spec.l_max, theta, phi)  # per-l [E, 2l+1, 2l+1]
    rbf = gaussian_rbf(dist, spec.n_rbf, spec.cutoff)
    return emask, blocks, rbf


def prepare_geometry(batch: Dict[str, torch.Tensor], spec: EqV2Spec,
                     dtype: torch.dtype = torch.float32):
    """Edge frames, radial features, truncation index maps (static per graph)."""
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    pos = batch["pos"].to(dtype)
    emask, blocks, rbf = _edge_frames(pos, src, dst, batch.get("edge_mask"), spec)
    tr_arr, tr_pos = _truncation_on(spec, pos.device)
    return dict(src=src, dst=dst, emask=emask, blocks=blocks, rbf=rbf, tr_pos=tr_pos,
                tr_arr=tr_arr)


def _edge_messages(h, lp, src, dst, blocks, rbf, tr_arr, tr_pos, spec, dtype):
    """Steps 1-3 and the logits of step 4 for a set of edges: the rotated-back
    messages [E, dim, C] and the per-head logits [E, H] (unmasked)."""
    feat_e = shard_ragged(take_rows(h, src) + take_rows(h, dst))  # [E, dim, C]
    # edge frame, truncated to |m| <= m_max
    feat_tr = shard_ragged(_take_columns(rotate_irreps(feat_e, blocks, transpose=True), tr_arr))
    msg = shard_ragged(_so2_conv(feat_tr, lp["so2"], spec, tr_pos))
    gate = mlp(lp["radial"], rbf, dtype=dtype)  # [E, C]
    msg = msg * torch.sigmoid(gate)[:, None, :]
    # attention logits from invariant (l=0) block
    inv = msg[:, int(_truncation(spec)[1][0]["plus"][0]), :]  # [E, C] (l=0, m=0)
    logits = mlp(lp["attn"], inv, dtype=dtype)  # [E, H]
    # back to full irreps + global frame
    full = _put_columns(_zeros_rows(msg, spec.dim, spec.channels), tr_arr, msg)
    return shard_ragged(rotate_irreps(full, blocks)), logits


def _project_and_ffn(x, agg, lp, spec: EqV2Spec, dtype):
    """The per-l output projection of the aggregated messages, the residual,
    and the gated equivariant FFN with its residual."""
    n, c = x.shape[0], spec.channels
    outs = []
    for l, w in enumerate(lp["out"].unbind(0)):
        seg = agg[:, l * l : (l + 1) * (l + 1), :]
        outs.append(torch.einsum("nmc,cd->nmd", seg, w))
    x = x + torch.cat(outs, dim=1)
    # --- gated equivariant FFN ---
    h = _equiv_layernorm(x, lp["ln_scale"], spec)
    scal = h[:, 0, :]
    gates = mlp(lp["ffn_gate"], scal, dtype=dtype).reshape(n, spec.l_max + 1, c)
    outs = []
    for l, w in enumerate(lp["ffn_mix"].unbind(0)):
        seg = h[:, l * l : (l + 1) * (l + 1), :]
        mixed = torch.einsum("nmc,cd->nmd", seg, w)
        g = torch.sigmoid(gates[:, l])[:, None, :]
        outs.append(mixed * g)
    return x + torch.cat(outs, dim=1)


def layer_apply(
    x: torch.Tensor,  # [N, dim, C]
    lp: Params,
    geom: Dict,
    spec: EqV2Spec,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One EquiformerV2 block (eSCN attention + gated FFN)."""
    src, dst, emask = geom["src"], geom["dst"], geom["emask"]
    n, _, c = x.shape
    h = _equiv_layernorm(x, lp["ln_scale"], spec)
    # --- eSCN attention ---
    full, logits = _edge_messages(h, lp, src, dst, geom["blocks"], geom["rbf"],
                                  geom["tr_arr"], geom["tr_pos"], spec, dtype)
    logits = torch.where(emask[:, None], logits, logits.new_full((), -1e30))
    lmax_ = masked_segment_max(logits, dst, n, neg=-1e29)
    expd = torch.exp(logits - take_rows(lmax_, dst))
    expd = torch.where(emask[:, None], expd, expd.new_zeros(()))
    denom = masked_segment_sum(expd, dst, n)
    alpha = expd / take_rows(denom, dst).clamp_min(1e-9)  # [E, H]
    # heads act on channel groups
    hc = c // spec.n_heads
    full = full.reshape(-1, spec.dim, spec.n_heads, hc)
    weighted = full * alpha[:, None, :, None]
    weighted = weighted.reshape(-1, spec.dim, c)
    agg = masked_segment_sum(weighted, dst, n, emask)  # [N, dim, C]
    return _project_and_ffn(x, agg, lp, spec, dtype)


def layer_apply_chunked(
    x: torch.Tensor,
    lp: Params,
    batch: Dict[str, torch.Tensor],
    spec: EqV2Spec,
    n_chunks: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Edge-chunked eSCN attention: a loop over edge chunks with an online
    softmax per (node, head) — flash-attention over segments.  Peak
    memory of the forward is O(E/n_chunks * dim * C) instead of
    O(E * dim * C) (a backward pass keeps every chunk's activations)."""
    src_all, dst_all = batch["edge_src"].long(), batch["edge_dst"].long()
    emask_all = batch.get("edge_mask")
    pos = batch["pos"].to(dtype)
    n, _, c = x.shape
    e_total = src_all.shape[0]
    ec = e_total // n_chunks
    if e_total % n_chunks:
        raise ValueError(f"{e_total} edges do not split into {n_chunks} chunks")
    tr_arr, tr_pos = _truncation_on(spec, x.device)
    h_in = _equiv_layernorm(x, lp["ln_scale"], spec)
    hc = c // spec.n_heads

    m_run = x.new_full((n, spec.n_heads), -1e30)
    d_run = x.new_zeros((n, spec.n_heads))
    acc = x.new_zeros((n, spec.dim, c))
    for ic in range(n_chunks):
        sl = slice(ic * ec, (ic + 1) * ec)
        src, dst = shard_ragged(src_all[sl]), shard_ragged(dst_all[sl])
        emask = shard_ragged(emask_all[sl]) if emask_all is not None else None
        emask, blocks, rbf = _edge_frames(pos, src, dst, emask, spec, pin=shard_ragged)
        full, logits = _edge_messages(h_in, lp, src, dst, blocks, rbf, tr_arr, tr_pos,
                                      spec, dtype)
        logits = torch.where(emask[:, None], logits, logits.new_full((), -1e30))
        # online softmax update per (dst node, head)
        m_chunk = masked_segment_max(logits, dst, n, neg=-1e30)
        m_new = torch.maximum(m_run, m_chunk)
        corr = torch.exp(torch.clamp(m_run - m_new, -60.0, 0.0))  # [N,H]
        w = torch.exp(torch.clamp(logits - take_rows(m_new, dst), -60.0, 0.0))
        w = torch.where(emask[:, None], w, w.new_zeros(()))
        d_run = d_run * corr + masked_segment_sum(w, dst, n)
        fullh = full.reshape(ec, spec.dim, spec.n_heads, hc)
        contrib = masked_segment_sum(fullh * w[:, None, :, None], dst, n)
        acc = (
            acc.reshape(n, spec.dim, spec.n_heads, hc) * corr[:, None, :, None]
            + contrib
        ).reshape(n, spec.dim, c)
        m_run = m_new
    denom = d_run.clamp_min(1e-9)[:, None, :, None]
    agg = (acc.reshape(n, spec.dim, spec.n_heads, hc) / denom).reshape(n, spec.dim, c)
    return _project_and_ffn(x, agg, lp, spec, dtype)


def eqv2_forward(
    p: Params,
    batch: Dict[str, torch.Tensor],
    spec: EqV2Spec,
    dtype: torch.dtype = torch.float32,
    edge_chunks: int = 1,
    unroll_layers: bool = False,
) -> torch.Tensor:
    """Returns per-node invariant outputs [N, d_out].

    ``unroll_layers`` keeps the JAX package's signature, where it picks an
    unrolled loop over ``lax.scan``: the port's layers always run as a
    Python loop, so both values compute the same thing."""
    z = batch["x"]
    if z.dim() == 2:
        s0 = z.to(dtype) @ p["embed"].to(dtype)
    else:
        s0 = take_rows(p["embed"].to(dtype), z.long())
    n = s0.shape[0]
    x = _put_columns(_zeros_rows(s0, spec.dim, spec.channels),
                     torch.zeros(1, dtype=torch.int64, device=s0.device), s0[:, None, :])
    layers = unstack(p["layers"], spec.n_layers)
    if edge_chunks > 1:
        for lp in layers:
            x = layer_apply_chunked(x, lp, batch, spec, edge_chunks, dtype)
    else:
        geom = prepare_geometry(batch, spec, dtype)
        for lp in layers:
            x = layer_apply(x, lp, geom, spec, dtype)
    return mlp(p["dec"], x[:, 0, :], dtype=dtype)
