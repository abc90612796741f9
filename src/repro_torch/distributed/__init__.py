"""The sharded data plane: :class:`ShardedGeoGraphStore` over the devices,
its device-to-device payload transfers (optionally int8), straggler
detection, and the mesh-as-geo planners; the production mesh's parameter
and activation sharding (:mod:`.sharding`, :mod:`.constraints`) and the
collectives of training over a ``DeviceMesh`` axis."""
from . import (  # noqa: F401
    collectives,
    compression,
    constraints,
    fault,
    geo_sharding,
    sharded_store,
    sharding,
)
from .fault import StragglerDetector, StragglerMitigator  # noqa: F401
from .sharded_store import (  # noqa: F401
    ShardedGeoGraphStore,
    StoreShard,
    payload_for_uids,
)
