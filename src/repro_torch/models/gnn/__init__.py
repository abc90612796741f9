"""GNN model zoo of the port: SchNet, EGNN, MeshGraphNet and EquiformerV2
(with its Wigner-D rotations), over the shared segment ops of
:mod:`.common`.  Port of ``repro/models/gnn``."""
from . import common, egnn, equiformer_v2, meshgraphnet, schnet, wigner  # noqa: F401
