"""The port's GNNs keep their symmetries, without JAX: the port's own
versions of ``tests/test_models_gnn.py``'s EGNN equivariance, SchNet and
EquiformerV2 (l_max 6) invariance and MeshGraphNet masking, and of
``tests/test_wigner.py``'s rotation, orthogonality, edge-frame and
angle checks, at those tests' bounds.  Params come from the port's own
init (a seeded ``torch.Generator``)."""
import numpy as np
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic fallback, see tests/_hypothesis_stub.py
    from _hypothesis_stub import given, settings, st

from repro_torch.models.gnn.egnn import egnn_forward, egnn_init
from repro_torch.models.gnn.equiformer_v2 import EqV2Spec, eqv2_forward, eqv2_init
from repro_torch.models.gnn.meshgraphnet import mgn_forward, mgn_init
from repro_torch.models.gnn.schnet import schnet_forward, schnet_init
from repro_torch.models.gnn.wigner import dir_to_angles, rotate_irreps, sh_real, wigner_d_blocks


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _batch(seed=0, n=24, e=64, d=8):
    rng = np.random.default_rng(seed)
    return dict(
        x=torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32),
        pos=torch.as_tensor(rng.standard_normal((n, 3)), dtype=torch.float32),
        edge_src=torch.as_tensor(rng.integers(0, n, e)),
        edge_dst=torch.as_tensor(rng.integers(0, n, e)),
        edge_mask=torch.ones((e,), dtype=torch.bool),
        edge_attr=torch.as_tensor(rng.standard_normal((e, 4)), dtype=torch.float32),
    )


def _rot(seed=1):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def _rotated(b, r):
    return dict(b, pos=torch.as_tensor(b["pos"].numpy() @ r.T, dtype=torch.float32))


def _egnn_atol(out: np.ndarray) -> float:
    """The reference's atol 5e-3, set for outputs of magnitude about 1e3
    (its JAX init gives |h| 286, |x| 1,236), per 1e3 of ``out``'s largest
    magnitude: three random EGNN layers grow the outputs by orders of
    magnitude from one init to another (to 1.4e6 from this test's), and
    f32 rounding grows with them."""
    return 5e-3 * max(1.0, float(np.abs(out).max()) / 1e3)


def test_egnn_equivariance():
    b = _batch()
    p = egnn_init(_gen(), 8, 16, 3, d_edge=4, device="cpu")
    h1, x1 = egnn_forward(p, b, 3)
    r = _rot()
    h2, x2 = egnn_forward(p, _rotated(b, r), 3)
    h1, x1, h2, x2 = (t.numpy() for t in (h1, x1, h2, x2))
    np.testing.assert_allclose(h1, h2, atol=_egnn_atol(h1))
    np.testing.assert_allclose(x1 @ r.T, x2, atol=_egnn_atol(x1))


def test_schnet_invariance():
    b = _batch()
    b["x"] = torch.as_tensor(np.random.default_rng(0).integers(0, 8, 24))
    p = schnet_init(_gen(), 8, 16, 2, 16, device="cpu")
    o1 = schnet_forward(p, b, 2, 16, 5.0)
    o2 = schnet_forward(p, _rotated(b, _rot()), 2, 16, 5.0)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-5)


def test_eqv2_invariance_lmax6():
    rng = np.random.default_rng(0)
    spec = EqV2Spec(n_layers=2, channels=16, l_max=6, m_max=2, n_heads=4,
                    n_rbf=8, n_species=10)
    p = eqv2_init(_gen(), spec, device="cpu")
    n, e = 16, 48
    b = dict(
        x=torch.as_tensor(rng.integers(0, 10, n)),
        pos=torch.as_tensor(rng.standard_normal((n, 3)), dtype=torch.float32),
        edge_src=torch.as_tensor(rng.integers(0, n, e)),
        edge_dst=torch.as_tensor(rng.integers(0, n, e)),
        edge_mask=torch.ones((e,), dtype=torch.bool),
    )
    o1 = eqv2_forward(p, b, spec)
    o2 = eqv2_forward(p, _rotated(b, _rot(3)), spec)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=2e-5)


def test_mgn_masking():
    """Masked edges contribute nothing."""
    b = _batch()
    p = mgn_init(_gen(), 8, 4, 16, 3, 2, device="cpu")

    def fwd(batch):
        pos = batch["pos"]
        rel = pos[batch["edge_dst"]] - pos[batch["edge_src"]]
        nrm = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
        return mgn_forward(p, dict(batch, edge_attr=torch.cat([rel, nrm], -1))).numpy()

    o1 = fwd(b)
    # zero out half the edges via mask vs physically removing them
    e = b["edge_src"].shape[0]
    o2 = fwd(dict(b, edge_mask=torch.arange(e) < e // 2))
    o3 = fwd(dict(b, edge_src=b["edge_src"][: e // 2], edge_dst=b["edge_dst"][: e // 2],
                  edge_mask=torch.ones((e // 2,), dtype=torch.bool)))
    np.testing.assert_allclose(o2, o3, atol=1e-4)
    assert not np.allclose(o1, o2)


def rotmat(theta, phi):
    cz, sz = np.cos(phi), np.sin(phi)
    cy, sy = np.cos(theta), np.sin(theta)
    return np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]) @ np.array(
        [[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]
    )


def _f32(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


@settings(max_examples=25, deadline=None)
@given(
    st.floats(0.05, 3.09), st.floats(-3.1, 3.1),
    st.integers(0, 10_000),
)
def test_wigner_rotation_property(theta, phi, seed):
    """Defining property: sh(R v) == D(R) sh(v) for all l <= 6."""
    l_max = 6
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(3)
    v /= np.linalg.norm(v)
    r = rotmat(theta, phi)
    sh_v = sh_real(l_max, _f32(v))
    sh_rv = sh_real(l_max, _f32(r @ v))
    blocks = wigner_d_blocks(l_max, _f32(theta), _f32(phi))
    pred = rotate_irreps(sh_v[:, None], blocks)[:, 0]
    np.testing.assert_allclose(pred.numpy(), sh_rv.numpy(), atol=5e-5)


def test_orthogonality():
    blocks = wigner_d_blocks(6, _f32(1.234), _f32(-0.77))
    for l, b in enumerate(blocks):
        b = b.numpy()
        np.testing.assert_allclose(b @ b.T, np.eye(2 * l + 1), atol=2e-5)


def test_edge_frame_alignment():
    """D(R)^T sh(r_hat) == sh(z_hat): rotating into the edge frame."""
    theta, phi = 0.8, -1.3
    d = np.array([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)])
    blocks = wigner_d_blocks(6, _f32(theta), _f32(phi))
    aligned = rotate_irreps(sh_real(6, _f32(d))[:, None], blocks, transpose=True)[:, 0]
    zref = sh_real(6, _f32([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(aligned.numpy(), zref.numpy(), atol=5e-5)


def test_dir_to_angles_roundtrip():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((10, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    theta, phi = (t.numpy() for t in dir_to_angles(torch.as_tensor(v)))
    rec = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], 1
    )
    np.testing.assert_allclose(rec, v, atol=2e-3)
