"""Writes in the window, on the CPU: a small cell of ``snb3s-nbr-sat``'s
whole-neighbourhood reads with a block of IU1/IU8 inserts added to its mix.
A sound run is correct; each fault planted in the store's write path fails
a check, and so does the control; the catalog moves to the new ids as the
store's ``grow_item_rows`` does and agrees with the reference's replay; a
mix without writes draws and checks what it did before writes existed."""
import dataclasses
import hashlib

import numpy as np
import pytest

from geobench.catalog import Catalog
from geobench.control import control_run
from geobench.harness import run_cell
from geobench.inputs import make_inputs
from geobench.reference.replay import Replay
from geobench.traffic import Batch, make_writes

CELL = "snb3s-nbr-sat"
SEED = 2**31 + 41
# a write block: IU1 add person and IU8 add friendship, a batch sealed a
# second, two of them before the window
WRITES = {"rate_ops": 60.0, "arrivals": "poisson", "kind_shares": {"IU1": 1, "IU8": 20},
          "seal_s": 1.0, "warmup_batches": 2}


@pytest.fixture
def rw_cell(cell_of):
    def make(rate_ops: float = WRITES["rate_ops"]):
        cell = cell_of(CELL, rate=300.0)
        cell.mix["writes"] = dict(WRITES, kind_shares=dict(WRITES["kind_shares"]),
                                  rate_ops=rate_ops)
        return cell
    return make


WARM = 2  # the small cell's warm-up batches, applied soundly before a fault


def _fails(out):
    assert not out["correct"]
    return sorted(n for n, c in out["checks"].items() if c["value"] > c["limit"])


def _in_window(fn):
    """``fn`` for the window's batches, the sound method for the warm-up's."""
    calls = []

    def wrapped(real, self, *args, **kwargs):
        calls.append(1)
        return (real if len(calls) <= WARM else fn)(self, *args, **kwargs)
    return wrapped


def _dropped(monkeypatch):
    from repro_torch.core.store import GeoGraphStore

    real = GeoGraphStore.apply_updates

    def drop_one(self, batch):
        batch = dataclasses.replace(batch, add_edge_src=batch.add_edge_src[:-1],
                                    add_edge_dst=batch.add_edge_dst[:-1],
                                    add_edge_size=batch.add_edge_size[:-1])
        return real(self, batch)

    fault = _in_window(drop_one)
    monkeypatch.setattr(GeoGraphStore, "apply_updates", lambda s, b: fault(real, s, b))
    return "graph_rows_differing"


def _at_destination(monkeypatch):
    from repro_torch.core.store import GeoGraphStore

    real = GeoGraphStore.apply_updates

    def at_dst(self, batch):
        report = real(self, batch)
        ne = len(batch.add_edge_src)
        g = self.g
        e = np.arange(g.n_edges - ne, g.n_edges)
        rows = g.n_nodes + e
        self.state.delta[rows] = False
        self.state.delta[rows, g.partition[g.dst[e]]] = True
        self.route_index.patch_rows(self.state.delta, rows)
        return report

    fault = _in_window(at_dst)
    monkeypatch.setattr(GeoGraphStore, "apply_updates", lambda s, b: fault(real, s, b))
    return "replica_rows_differing"


def _stale_index(monkeypatch):
    from repro_torch.core import routing
    from repro_torch.core.route_index import RouteIndex

    real = RouteIndex.apply_batch
    fault = _in_window(lambda self, *a: None)
    monkeypatch.setattr(RouteIndex, "apply_batch", lambda s, *a: fault(real, s, *a))
    monkeypatch.setattr(routing, "FUSED_MIN_ITEMS", 1)  # reads over the index's tables
    return None


def _payload_row_missing(monkeypatch):
    from repro_torch.distributed.sharded_store import ShardedGeoGraphStore

    real = ShardedGeoGraphStore._sync_payloads

    def missing(self):
        real(self)
        for shard in self.shards:  # the newest knows edge's row
            shard.payload[-1] = 0.0

    fault = _in_window(missing)
    monkeypatch.setattr(ShardedGeoGraphStore, "_sync_payloads", lambda s: fault(real, s))
    return "payload_rows_differing"


def _not_applied(monkeypatch):
    from repro_torch.core.store import GeoGraphStore

    real = GeoGraphStore.apply_updates
    fault = _in_window(lambda self, batch: real(self, type(batch).empty()))
    monkeypatch.setattr(GeoGraphStore, "apply_updates", lambda s, b: fault(real, s, b))
    return None


@pytest.mark.parametrize("fault", [None, _dropped, _at_destination, _stale_index,
                                   _payload_row_missing, _not_applied],
                         ids=["sound", "mutation dropped", "edge at its destination's DC",
                              "route index stale", "payload row missing",
                              "state unchanged"])
def test_write_faults_fail_the_check(rw_cell, monkeypatch, fault):
    cell = rw_cell()
    if fault is None:
        out = run_cell(cell, SEED, 2.5, trace=False, device="cpu")
        assert out["correct"], out["checks"]
        assert set(out["checks"]) >= {"graph_rows_differing", "replica_rows_differing",
                                      "served_by_mismatches", "payload_rows_differing"}
        return
    number = fault(monkeypatch)
    failing = _fails(run_cell(cell, SEED, 2.5, trace=False, device="cpu"))
    assert failing
    if number is not None:
        assert number in failing, failing


def test_control_of_the_write_mix_fails(rw_cell):
    correct, checks = control_run(rw_cell(), SEED, 2.0)
    assert not correct, checks


def _small(rw_cell, seed=SEED):
    cell = rw_cell()
    inputs = make_inputs(cell.config, seed)
    batches = make_writes(cell.mix["writes"], cell.config["graph"], inputs.g, inputs.wiring,
                          inputs.env.n_dcs, seed, 3.0)
    return cell, inputs, batches


def test_catalog_moves_as_the_store_grows_its_rows(rw_cell):
    from repro_torch.core.graph import grow_item_rows

    _, inputs, _ = _small(rw_cell)
    cat = Catalog(inputs.g, inputs.patterns)
    n, m = inputs.g.n_nodes, inputs.g.n_edges
    before = [it.copy() for it in cat.items]
    iu1 = Batch(due=1.0, vertex_size=np.float32([300.0, 200.0, 250.0]),
                vertex_partition=np.int32([0, 3, 1]), edge_src=np.zeros(0, np.int64),
                edge_dst=np.zeros(0, np.int64), edge_size=np.zeros(0, np.float32))
    assert cat.apply(iu1) == 0  # no person gained a friend
    for old, new in zip(before, cat.items):
        held = np.zeros(n + m, bool)
        held[old] = True
        np.testing.assert_array_equal(np.flatnonzero(grow_item_rows(held, n, 3, 0, False)), new)
    assert any(it.max() >= n + 3 for it in cat.items)  # edge items moved


def test_catalog_agrees_with_the_replay_and_the_build(rw_cell):
    _, inputs, batches = _small(rw_cell)
    g = inputs.g
    cat = Catalog(g, inputs.patterns)
    replay = Replay(g, np.zeros((g.n_items, inputs.env.n_dcs), bool), inputs.patterns,
                    inputs.env.rtt_s)
    # with every friend taken the build's patterns are whole neighbourhoods
    for p in inputs.patterns:
        np.testing.assert_array_equal(replay.neighbourhood(p.start, p.hops), p.items)
    redone = 0
    for b in batches:
        redone += cat.apply(b)
        replay.apply(b)
        for p, items in enumerate(cat.items):
            np.testing.assert_array_equal(replay.items_at(p, replay.epoch), items)
    assert redone > 0 and len(batches) >= 4


def test_write_stream_repeats_by_seed_and_keeps_its_shares(rw_cell):
    cell, inputs, a = _small(rw_cell)
    _, _, b = _small(rw_cell)
    assert [x.due for x in a] == [-1.0, 0.0, 1.0, 2.0]
    for x, y in zip(a, b):
        for f in ("vertex_size", "vertex_partition", "edge_src", "edge_dst", "edge_size"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    g = inputs.g
    n_new = sum(len(x.vertex_size) for x in a)
    src = np.concatenate([x.edge_src for x in a])
    dst = np.concatenate([x.edge_dst for x in a])
    assert len(src) > 10 * max(n_new, 1) / 2  # about 20 IU8 to an IU1
    assert (src != dst).all() and max(src.max(), dst.max()) < g.n_nodes + n_new
    pairs = set(zip(np.minimum(g.src, g.dst).tolist(), np.maximum(g.src, g.dst).tolist()))
    new = list(zip(np.minimum(src, dst).tolist(), np.maximum(src, dst).tolist()))
    assert len(set(new)) == len(new) and not set(new) & pairs


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


# What the harness drew, drained and checked before writes existed, on the
# small cell at seed 2**31 + 43 over a 1-s window: the inputs, every read's
# pattern, origin and due time, and the warm-up's drains.  The window's
# drains follow the wall clock, so only their cover is checked.
OLD_PATH = {
    "snb3s-read-over": dict(attempted=396, graph="271910973876fc04",
                            patterns="d38c895f61e431dc", reads="843c100b2ffae865",
                            warmup_drains="30ce0d570327529c"),
    "snb3s-nbr-sat": dict(attempted=396, graph="271910973876fc04",
                          patterns="696404f3ee1fa48f", reads="5476264cb4fd69be",
                          warmup_drains="751818b958e4f676"),
}


@pytest.mark.parametrize("name", sorted(OLD_PATH))
def test_a_mix_without_writes_takes_the_old_path(cell_of, monkeypatch, name):
    from geobench import harness
    from geobench.reference import check
    from geobench.traffic import make_reads

    def no_writes(*a, **k):
        raise AssertionError("a mix without writes drew a write stream")

    logs = []
    real = check.check_run

    def keep(config, inputs, log):
        logs.append(log)
        return real(config, inputs, log)

    monkeypatch.setattr(harness, "make_writes", no_writes)
    monkeypatch.setattr(check, "check_run", keep)
    cell = cell_of(name)
    seed = 2**31 + 43
    out = run_cell(cell, seed, 1.0, trace=False, device="cpu")
    assert out["correct"], out["checks"]
    assert {k: c["value"] for k, c in out["checks"].items()} == {
        "replica_rows_differing": 0, "served_by_mismatches": 0, "latency_rel_gap": 0.0,
        "payload_rows_differing": 0, "unanswered": 0}
    inputs = make_inputs(cell.config, seed)
    g, pats = inputs.g, inputs.patterns
    eligible = np.array([i for i, p in enumerate(pats) if len(p.items)], np.int64)
    home = np.array([int(np.argmax(p.r_py)) for p in pats], np.int64)
    stream = make_reads(cell.mix["reads"], eligible, home, inputs.env.n_dcs, seed, 1.0)
    (log,) = logs
    n_warm = sum(cell.mix["warmup_drains"])
    n_warm_drains = next(k for k, d in enumerate(log.drains) if d.max() >= n_warm)
    got = dict(
        attempted=out["attempted"],
        graph=_digest(g.src, g.dst, g.node_size, g.edge_size, g.partition),
        patterns=_digest(*[a for p in pats for a in (p.items, p.r_py, p.w_py,
                                                      np.float64(p.eta))]),
        reads=_digest(log.pattern, log.origin, stream.due),
        warmup_drains=_digest(*log.drains[:n_warm_drains]),
    )
    assert got == OLD_PATH[name]
    np.testing.assert_array_equal(np.sort(np.concatenate(log.drains)),
                                  np.arange(n_warm + len(stream.due)))
    assert log.batches == [] and log.version is None and log.drain_epoch is None
    assert log.graph is None


def test_traced_write_run_is_correct(rw_cell):
    out = run_cell(rw_cell(), SEED + 1, 2.5, trace=True, device="cpu")
    assert out["correct"], out["checks"]
    assert "graph_rows_differing" in out["checks"]
