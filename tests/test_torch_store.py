"""The port's disk-backed client store (``repro_torch.store``: layout,
store, faults, paging, prefetch) against the JAX reference's, on the CPU.

The store modules are numpy and file IO in both packages, so the files
must be the same bytes: the same rows written by either package give the
same chunk files, checksums and manifest, and a store written by one opens
in the other with equal rows.  The reference's ``tests/test_store.py``
cases that need no training round run here against the port's modules;
the closure planner and its compact operator are checked per family on
the reference's own active sets and picks.
"""
import json
import os

import jax
import numpy as np
import pytest

from repro.store import ClientStore as RefStore
from repro.store import FieldSpec as RefField
from repro.store import make_plan as ref_make_plan
from repro.core import TopologyConfig as RefTopo
from repro.core import topology as ref_topology
from repro_torch.core import FLTrainer, TopologyConfig, make_algo
from repro_torch.core import topology
from repro_torch.models.small import tiny_mlp
from repro_torch.store import (
    CHECKSUM_ALGO,
    ClientStore,
    FaultInjector,
    FieldSpec,
    InjectedCrash,
    Prefetcher,
    RowCache,
    StoreCorruptionError,
    StoreIOError,
    Writeback,
    build_plan,
    closure_bound,
    dense_partial_operator,
    make_plan,
)
from repro_torch.store import layout
from _torch_threads import one_thread  # noqa: F401,E402  (an autouse fixture)


def _toy_fields(F=FieldSpec):
    return {
        "params": F("params", (6,), "float32"),
        "w": F("w", (), "float32", default=1.0),
    }


def _fault_store(tmp_path, name="s", faults=None, n=128):
    tpl = np.arange(6, dtype=np.float32)
    s = ClientStore.create(str(tmp_path / name), n, _toy_fields(),
                           rows_per_chunk=16, templates={"params": tpl},
                           faults=faults)
    return s, tpl


def _flip(path, offset=30):
    """Flip one bit at ``offset`` (from the end when negative)."""
    whence = 2 if offset < 0 else 0
    with open(path, "r+b") as f:
        f.seek(offset, whence)
        b = f.read(1)
        f.seek(offset, whence)
        f.write(bytes([b[0] ^ 0x10]))


# -- the same bytes in both packages -------------------------------------------

def test_checksum_choice_matches_the_reference():
    from repro.store import layout as ref_layout

    assert CHECKSUM_ALGO == ref_layout.CHECKSUM_ALGO
    data = os.urandom(4096)
    assert layout.checksum(data) == ref_layout.checksum(data)
    assert layout.STORE_FORMAT == ref_layout.STORE_FORMAT


def test_both_packages_write_the_same_store(tmp_path, monkeypatch):
    """Byte for byte: chunk files, blobs, templates and the manifest.  A
    chunk file is an npz archive whose zip headers carry the write time,
    so the clock is held still for both writers."""
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    rng = np.random.default_rng(0)
    tpl = rng.standard_normal(6).astype(np.float32)
    ids = np.array([3, 17, 40, 41, 99])
    rows = {"params": rng.standard_normal((5, 6)).astype(np.float32),
            "w": rng.random(5).astype(np.float32)}
    stores = {}
    for name, cls, F in (("ref", RefStore, RefField),
                         ("port", ClientStore, FieldSpec)):
        s = cls.create(str(tmp_path / name), 100, _toy_fields(F),
                       rows_per_chunk=16, templates={"params": tpl},
                       meta={"round": 0})
        s.write_rows(ids, rows)
        s.write_blob("churn_live", np.array([1, 0, -1], np.int8))
        s.update_meta(round=3)
        stores[name] = s
    files = {name: sorted(os.listdir(s.path)) for name, s in stores.items()}
    assert files["ref"] == files["port"]
    for f in files["ref"]:
        a = open(os.path.join(stores["ref"].path, f), "rb").read()
        b = open(os.path.join(stores["port"].path, f), "rb").read()
        assert a == b, f
    m = json.load(open(os.path.join(stores["port"].path, "manifest.json")))
    assert m["checksum_algo"] == CHECKSUM_ALGO and m["meta"]["round"] == 3


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_store_opens_in_the_other_package(tmp_path, writer):
    rng = np.random.default_rng(1)
    ids = np.arange(20, 40)
    rows = {"params": rng.standard_normal((20, 6)).astype(np.float32),
            "w": rng.random(20).astype(np.float32)}
    create = RefStore if writer == "reference" else ClientStore
    opener = ClientStore if writer == "reference" else RefStore
    F = RefField if writer == "reference" else FieldSpec
    s = create.create(str(tmp_path / "s"), 64, _toy_fields(F),
                      rows_per_chunk=16,
                      templates={"params": np.ones(6, np.float32)})
    s.write_rows(ids, rows)
    s.update_meta(round=5)
    o = opener.open(s.path)
    assert o.meta["round"] == 5 and o.n == 64
    got = o.read_rows(np.arange(64))
    want = s.read_rows(np.arange(64))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert o.verify_chunks()["verified"] == s.verify_chunks()["verified"]
    assert float(o.field_sum("w")) == float(s.field_sum("w"))


# -- the reference's store cases, on the port's modules ------------------------

def test_store_creation_is_lazy_and_roundtrips(tmp_path):
    tpl = np.arange(6, dtype=np.float32)
    s = ClientStore.create(str(tmp_path / "s"), 1000, _toy_fields(),
                           rows_per_chunk=64, templates={"params": tpl})
    assert s.bytes_written == 0
    assert not [f for f in os.listdir(s.path) if f.startswith("rows_")]
    got = s.read_rows(np.array([0, 999, 500]))
    np.testing.assert_array_equal(got["params"], np.broadcast_to(tpl, (3, 6)))
    np.testing.assert_array_equal(got["w"], np.ones(3, np.float32))
    ids = np.array([5, 700, 6])
    vals = {"params": np.full((3, 6), 2.0, np.float32),
            "w": np.array([0.5, 0.25, 0.125], np.float32)}
    s.write_rows(ids, vals)
    s.update_meta(round=1)
    assert 0 < s.bytes_written <= 2 * 64 * (6 + 1) * 4
    s2 = ClientStore.open(s.path)
    got = s2.read_rows(ids)
    np.testing.assert_array_equal(got["params"], vals["params"])
    np.testing.assert_array_equal(got["w"], vals["w"])
    np.testing.assert_array_equal(s2.read_rows(np.array([4]))["params"][0],
                                  tpl)


def test_store_validation_and_clobber_guard(tmp_path):
    s, _ = _fault_store(tmp_path)
    with pytest.raises(FileExistsError):
        ClientStore.create(s.path, 8, _toy_fields())
    with pytest.raises(ValueError, match="ids must be unique"):
        s.write_rows(np.array([1, 1]),
                     {"w": np.ones(2, np.float32)})
    with pytest.raises(KeyError):
        s.write_rows(np.array([1]), {"nope": np.ones(1, np.float32)})
    with pytest.raises(IndexError):
        s.read_rows(np.array([128]))
    with pytest.raises(ValueError):
        ClientStore.create(str(tmp_path / "z"), 0, _toy_fields())


def test_store_streaming_reductions_and_meta_commit(tmp_path):
    s, tpl = _fault_store(tmp_path, n=40)
    s.write_rows(np.array([0, 39]), {"w": np.array([2.0, 3.0], np.float32)})
    assert float(s.field_sum("w")) == 38.0 + 5.0
    np.testing.assert_allclose(s.field_sum("params"), 40 * tpl)
    s.update_meta(round=4, key=[1, 2])
    assert ClientStore.open(s.path).meta == {"round": 4, "key": [1, 2]}
    starts = [start for start, _ in s.iter_chunks(fields=["w"])]
    assert starts == [0, 16, 32]


def test_row_cache_consistency_rules():
    c = RowCache(capacity=2)
    c.put_clean(1, {"v": 1})
    c.put_pending(1, {"v": 2})
    assert c.get(1) == {"v": 2}
    c.put_clean(1, {"v": 3})  # a dirtier copy is already queued
    assert c.get(1) == {"v": 2}
    c.settle(1)
    assert c.pending_count == 0 and c.get(1) == {"v": 2}
    c.put_clean(2, {"v": 4})
    c.put_clean(3, {"v": 5})  # evicts the least recently used: 1
    assert c.get(1) is None and len(c) == 2


def test_store_open_removes_stale_tmp(tmp_path):
    s, _ = _fault_store(tmp_path)
    ids = np.arange(8)
    s.write_rows(ids, {"params": np.ones((8, 6), np.float32)})
    s.update_meta()
    committed = s._chunks[0]["file"]
    for junk in ("manifest.json.tmp", committed + ".crashed.tmp",
                 "rows_00000016.g000099.npz.tmp"):
        with open(os.path.join(s.path, junk), "wb") as f:
            f.write(b"partial")
    s2 = ClientStore.open(s.path)
    names = os.listdir(s2.path)
    assert not [x for x in names if x.endswith(".tmp")]
    assert committed in names
    np.testing.assert_array_equal(
        s2.read_rows(ids)["params"], np.ones((8, 6), np.float32))


def test_open_rolls_back_uncommitted_generations(tmp_path):
    s, _ = _fault_store(tmp_path)
    ids = np.arange(4)
    s.write_rows(ids, {"params": np.full((4, 6), 1.0, np.float32)})
    s.update_meta(round=1)
    s.write_rows(ids, {"params": np.full((4, 6), 9.0, np.float32)})
    s2 = ClientStore.open(s.path)
    assert s2.meta["round"] == 1
    np.testing.assert_array_equal(
        s2.read_rows(ids)["params"], np.full((4, 6), 1.0, np.float32))


def test_corrupt_dirty_chunk_quarantines_and_raises(tmp_path):
    s, _ = _fault_store(tmp_path)
    ids = np.arange(16, 24)
    s.write_rows(ids, {"params": np.ones((8, 6), np.float32)})
    s.update_meta(round=7)
    fname = s._chunks[16]["file"]
    _flip(os.path.join(s.path, fname))
    with pytest.raises(StoreCorruptionError) as ei:
        s.read_rows(ids)
    e = ei.value
    assert e.chunk_start == 16 and e.round_no == 7
    assert set(e.dirty_rows) == set(range(16, 24))
    assert "quarantine" in e.path and os.path.exists(e.path)
    assert not os.path.exists(os.path.join(s.path, fname))
    assert s.corrupt_chunks == 1


def test_corrupt_clean_chunk_rebuilds_from_template(tmp_path):
    s, tpl = _fault_store(tmp_path)
    ids = np.arange(16)
    s.write_rows(ids, {"params": np.ones((16, 6), np.float32)})
    s._chunks[0]["dirty"].clear()
    s.update_meta()
    _flip(os.path.join(s.path, s._chunks[0]["file"]))
    got = s.read_rows(ids)
    np.testing.assert_array_equal(got["params"], np.broadcast_to(tpl, (16, 6)))
    np.testing.assert_array_equal(got["w"], np.ones(16, np.float32))
    assert s.rebuilt_rows == 16 and s.corrupt_chunks == 1


def test_transient_eio_is_retried_and_accounted(tmp_path):
    fi = FaultInjector(seed=3, eio_prob=1.0, eio_max_per_path=2)
    s, _ = _fault_store(tmp_path, faults=fi)
    ids = np.arange(8)
    s.write_rows(ids, {"params": np.ones((8, 6), np.float32)})
    s.update_meta()
    got = s.read_rows(ids)
    np.testing.assert_array_equal(got["params"], np.ones((8, 6), np.float32))
    assert s.io_retries >= 2 and s.backoff_seconds > 0.0


def test_torn_write_is_retried_to_durability(tmp_path):
    fi = FaultInjector(seed=5, torn_write_prob=1.0, torn_max_per_path=1)
    s, _ = _fault_store(tmp_path, faults=fi)
    ids = np.arange(8)
    s.write_rows(ids, {"params": np.full((8, 6), 2.0, np.float32)})
    s.update_meta()
    assert fi.faults_injected >= 1
    assert s.verify_chunks()["verified"] >= 1
    np.testing.assert_array_equal(
        ClientStore.open(s.path).read_rows(ids)["params"],
        np.full((8, 6), 2.0, np.float32))


@pytest.mark.parametrize("crash_on", ["chunk-write", "manifest-commit"])
def test_crash_points_reopen_bit_identical(tmp_path, crash_on):
    s, _ = _fault_store(tmp_path)
    ids = np.arange(8)
    s.write_rows(ids, {"params": np.full((8, 6), 1.0, np.float32)})
    s.update_meta(round=1)
    committed = {
        ent["file"]: open(os.path.join(s.path, ent["file"]), "rb").read()
        for ent in s._chunks.values()
    }
    s.faults = FaultInjector(seed=0, crash_on=crash_on)
    with pytest.raises(InjectedCrash):
        s.write_rows(ids, {"params": np.full((8, 6), 5.0, np.float32)})
        s.update_meta(round=2)
    s2 = ClientStore.open(s.path)
    assert s2.meta["round"] == 1
    np.testing.assert_array_equal(
        s2.read_rows(ids)["params"], np.full((8, 6), 1.0, np.float32))
    for fname, data in committed.items():
        assert open(os.path.join(s2.path, fname), "rb").read() == data
    assert not [x for x in os.listdir(s2.path) if x.endswith(".tmp")]


def test_manifest_self_checksum_detects_corruption(tmp_path):
    s, _ = _fault_store(tmp_path)
    s.write_rows(np.arange(4), {"params": np.ones((4, 6), np.float32)})
    s.update_meta(round=3)
    assert s.verify_chunks()["verified"] >= 2
    mpath = os.path.join(s.path, "manifest.json")
    m = json.load(open(mpath))
    m["meta"]["round"] = 999
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(StoreCorruptionError, match="self-checksum"):
        ClientStore.open(s.path)
    with pytest.raises(StoreCorruptionError):
        s.verify_chunks()


def test_blob_roundtrip_and_corruption_raises(tmp_path):
    s, _ = _fault_store(tmp_path)
    live = np.array([1, 0, -1, 1], dtype=np.int8)
    s.write_blob("churn_live", live)
    s.update_meta()
    np.testing.assert_array_equal(s.read_blob("churn_live"), live)
    assert s.read_blob("never_written") is None
    _flip(os.path.join(s.path, s._blobs["churn_live"]["file"]), offset=-1)
    with pytest.raises(StoreCorruptionError, match="churn_live"):
        s.read_blob("churn_live")


def test_prefetch_error_carries_round_and_path_context(tmp_path):
    s, _ = _fault_store(tmp_path)
    ids = np.arange(16, 24)
    s.write_rows(ids, {"params": np.ones((8, 6), np.float32)})
    s.update_meta()
    os.remove(os.path.join(s.path, s._chunks[16]["file"]))
    p = Prefetcher(s, RowCache(32))
    try:
        with pytest.raises(StoreIOError) as ei:
            p.submit(ids, round_no=11).wait()
    finally:
        p.close()
    e = ei.value
    assert e.op == "prefetch" and e.round_no == 11
    assert e.path and "rows_" in e.path
    assert isinstance(e.__cause__, FileNotFoundError)
    assert "round 11" in str(e)


def test_writeback_error_carries_context(tmp_path):
    fi = FaultInjector(seed=9, torn_write_prob=1.0, torn_max_per_path=100)
    s, _ = _fault_store(tmp_path, faults=fi)
    wb = Writeback(s, RowCache(32))
    try:
        ids = np.arange(4)
        rows = {"params": np.ones((4, 6), np.float32)}
        for gid in ids:
            wb.cache.put_pending(int(gid),
                                 {k: v[gid] for k, v in rows.items()})
        wb.enqueue(ids, rows, round_no=5)
        with pytest.raises(StoreIOError) as ei:
            wb.flush()
        assert ei.value.op == "write-back" and ei.value.round_no == 5
        assert isinstance(ei.value.__cause__, OSError)
    finally:
        wb.close()


def test_fault_injector_validation():
    with pytest.raises(ValueError, match="probability in \\[0, 1\\]"):
        FaultInjector(eio_prob=1.5)
    with pytest.raises(ValueError, match="crash_on"):
        FaultInjector(crash_on="power-loss")
    m = tiny_mlp(in_dim=16, n_classes=4)
    data = {"x": np.zeros((8, 4, 16), np.float32),
            "y": np.zeros((8, 4), np.int64)}
    with pytest.raises(ValueError, match="faults.*paged"):
        FLTrainer(m.loss, m.init, data,
                  make_algo("dfedsgpsm", local_steps=1, batch_size=2),
                  TopologyConfig(kind="kout", n_clients=8, k_out=2),
                  faults=FaultInjector(eio_prob=0.1), device="cpu")


# -- the fault-in closure and its compact operator, per family -----------------

_KINDS = ("ring", "exponential", "kout")


def _cfgs(kind, n=24):
    k_out = 1 if kind in ("ring", "exponential") else 2
    tv = kind == "exponential"
    return (RefTopo(kind=kind, n_clients=n, k_out=k_out, time_varying=tv),
            TopologyConfig(kind=kind, n_clients=n, k_out=k_out,
                           time_varying=tv))


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("seed,t", [(0, 0), (1, 3), (7, 5)])
def test_compact_plan_equals_the_references(kind, seed, t):
    """On the reference's active set and picks, the port's plan is the
    reference's bit for bit; it holds exactly active ∪ in-neighbors, its
    pads are inert, and its compact operator embeds into the dense
    column-stochastic one."""
    ref_cfg, cfg = _cfgs(kind)
    n, k_active = cfg.n_clients, 5
    k_in = topology.active_k_in(cfg)
    assert k_in == ref_topology.active_k_in(ref_cfg)
    c_max = closure_bound(n, k_active, k_in)
    want = ref_make_plan(ref_cfg, k_active, c_max, jax.random.PRNGKey(seed), t)
    got = build_plan(t, None, None, None, want.active, want.picks, c_max)
    for f in ("active", "picks", "closure", "ids", "idx", "wgt"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.c == want.c
    assert set(got.closure.tolist()) == (set(got.active.tolist())
                                         | set(got.picks.ravel().tolist()))
    np.testing.assert_array_equal(got.closure[:k_active], got.active)
    np.testing.assert_array_equal(got.wgt[got.c:, 0], 1.0)
    np.testing.assert_array_equal(got.wgt[got.c:, 1:], 0.0)
    M = np.zeros((n, n), np.float64)
    noncl = np.setdiff1d(np.arange(n), got.closure)
    M[noncl, noncl] = 1.0
    for s in range(got.c):
        for slot in range(got.idx.shape[1]):
            M[got.ids[s], got.ids[got.idx[s, slot]]] += got.wgt[s, slot]
    dense = dense_partial_operator(got.active, got.picks, n)
    np.testing.assert_allclose(M, dense, atol=1e-7)
    np.testing.assert_allclose(
        dense, np.asarray(ref_make_plan.__globals__["paging"]
                          .dense_partial_operator(want.active, want.picks, n)),
        atol=0)
    np.testing.assert_allclose(M.sum(axis=0), 1.0, atol=1e-6)


@pytest.mark.parametrize("kind", _KINDS)
def test_port_plans_hold_the_closure(kind):
    """The port's own draws: the same closure and operator properties."""
    import torch

    _, cfg = _cfgs(kind)
    n, k_active = cfg.n_clients, 5
    c_max = closure_bound(n, k_active, topology.active_k_in(cfg))
    for seed, t in ((0, 0), (3, 2)):
        plan = make_plan(cfg, k_active, c_max,
                         torch.Generator().manual_seed(seed), t)
        assert set(plan.closure.tolist()) == (
            set(plan.active.tolist()) | set(plan.picks.ravel().tolist()))
        assert plan.c <= c_max and len(set(plan.active.tolist())) == k_active
        assert not np.any(plan.picks == plan.active[:, None])


def test_closure_bound_is_tight_and_population_capped():
    assert closure_bound(1000, 8, 3) == 32
    assert closure_bound(16, 8, 3) == 16
