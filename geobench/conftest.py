"""Small cells for the CPU tests: the cells of ``BENCHMARK.json`` with a
graph of 800 persons, 24 patterns and a few hundred reads a second, run on
the CPU through the port's plain paths.  ``flat=True`` serves the same
inputs from one ``GeoGraphStore``, the other store kind a configuration
file may name."""
import pytest

CELL = "snb3s-read-over"


def small_cell(name: str = CELL, rate: float = 400.0, flat: bool = False):
    from geobench.harness import resolve_cell

    cell = resolve_cell(name)
    cell.config["graph"].update(n_nodes=800, n_communities=8, mean_degree=12.0,
                                max_degree=100)
    cell.config["patterns"].update(n_patterns=24, n_hot_sources=8)
    if flat:
        cell.config["store"] = {"kind": "flat", "routing": "stepwise", "device": "cuda",
                                "placement_device": "cpu"}
    cell.mix["reads"]["rate_rps"] = rate
    cell.mix["warmup_drains"] = [64, 8, 1]
    cell.mix["max_outstanding"] = 64
    return cell


@pytest.fixture
def cell_of():
    return small_cell
