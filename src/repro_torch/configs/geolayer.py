"""The paper's own system config: GeoLayer store defaults (§VII setup).

Not an arch of the registry (``configs.get_arch``) — this is the
configuration surface for the geo-distributed graph store itself."""
import dataclasses

from ..core.dhd import DHDParams
from ..core.placement import PlacementConfig


@dataclasses.dataclass(frozen=True)
class GeoLayerSystemConfig:
    n_dcs: int = 5  # Table I environment
    latency_interval_s: float = 0.100  # paper: 100 ms layer buckets
    gamma_max_s: float = 0.5  # fraud-detection SLO (500 ms)
    lambda1: float = 0.5
    lambda2: float = 0.5
    dhd: DHDParams = DHDParams(alpha=0.5, gamma=0.1, beta=0.3)
    theta_quantile: float = 0.55  # pre-cache threshold (Fig. 12 optimum)
    n_history_patterns: int = 1000
    n_test_patterns: int = 100
    write_fraction: float = 0.3

    def placement_config(self) -> PlacementConfig:
        return PlacementConfig(
            gamma_max_s=self.gamma_max_s,
            lambda1=self.lambda1,
            lambda2=self.lambda2,
            dhd=self.dhd,
            theta_quantile=self.theta_quantile,
        )


CONFIG = GeoLayerSystemConfig()
