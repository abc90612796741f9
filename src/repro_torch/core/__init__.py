"""GeoLayer core (paper §III-§VI): layered graph, DHD placement, routing.

Submodules are imported on use (``from repro_torch.core.store import
GeoGraphStore``), so importing this package costs nothing."""
