"""The sharded data plane: :class:`ShardedGeoGraphStore` over the devices,
its device-to-device payload transfers (optionally int8), straggler
detection, and the mesh-as-geo planners.

The JAX package's parameter and activation sharding, the GNN halo exchange
and the collectives of training are not part of this package."""
from . import (  # noqa: F401
    collectives,
    compression,
    fault,
    geo_sharding,
    sharded_store,
)
from .fault import StragglerDetector, StragglerMitigator  # noqa: F401
from .sharded_store import (  # noqa: F401
    ShardedGeoGraphStore,
    StoreShard,
    payload_for_uids,
)
