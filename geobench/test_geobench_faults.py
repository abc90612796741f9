"""The check fails a run whose timed path or build is broken underneath,
once for each fault a cell can have, and fails the control."""
import numpy as np
import pytest

from geobench.control import control_run
from geobench.harness import run_cell


def _fails(out, number):
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_altered_answer_fails(cell_of, monkeypatch):
    from repro_torch.core import routing

    real = routing._materialize_results

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        r = out[-1]
        r.served_by = r.served_by.copy()
        r.served_by[0] = (r.served_by[0] + 1) % 5
        return out

    monkeypatch.setattr(routing, "_materialize_results", altered)
    _fails(run_cell(cell_of(), 21, 1.0, False, device="cpu"), "served_by_mismatches")


def test_half_the_batch_left_out_fails(cell_of, monkeypatch):
    from repro_torch.distributed.sharded_store import ShardedGeoGraphStore

    real = ShardedGeoGraphStore.serve_batch

    def half(self, requests, observe=True):
        return real(self, requests, observe)[: max(1, len(requests) // 2)]

    monkeypatch.setattr(ShardedGeoGraphStore, "serve_batch", half)
    _fails(run_cell(cell_of(), 22, 1.0, False, device="cpu"), "unanswered")


def test_wrong_payload_row_fails(cell_of, monkeypatch):
    from repro_torch.distributed import sharded_store

    real = sharded_store.payload_for_uids

    def corrupt(uids, width=sharded_store.PAYLOAD_WIDTH):
        rows = real(uids, width)
        rows[len(rows) // 2] += np.float32(0.5)
        return rows

    monkeypatch.setattr(sharded_store, "payload_for_uids", corrupt)
    _fails(run_cell(cell_of(), 24, 1.0, False, device="cpu"), "payload_rows_differing")


def _gain_flipped(placement, monkeypatch):
    real = placement.replication_gain
    monkeypatch.setattr(placement, "replication_gain", lambda *a, **k: -real(*a, **k))


def _no_precache(placement, monkeypatch):
    monkeypatch.setattr(placement, "precache_hot_regions", lambda *a, **k: None)


def _precache_one_short(placement, monkeypatch):
    real = placement.precache_hot_regions
    monkeypatch.setattr(placement, "precache_hot_regions",
                        lambda *a, **k: real(*a, **dict(k, max_per_dc=k["max_per_dc"] - 1)))


@pytest.mark.parametrize("fault", [None, _gain_flipped, _no_precache, _precache_one_short])
def test_placement_fault_fails(cell_of, monkeypatch, fault):
    from repro_torch.core import placement

    cell = cell_of()
    cell.config["placement"] = {"precache_max_per_dc": 40}
    if fault is None:  # the same cell, sound, is correct
        assert run_cell(cell, 27, 0.5, False, device="cpu")["correct"]
        return
    fault(placement, monkeypatch)
    _fails(run_cell(cell, 27, 0.5, False, device="cpu"), "replica_rows_differing")


@pytest.mark.parametrize("flat", [False, True])
def test_control_fails(cell_of, flat):
    correct, checks = control_run(cell_of(flat=flat), 25, 1.0)
    assert not correct, checks
