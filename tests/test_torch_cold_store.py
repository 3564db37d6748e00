"""The port's cold tier (``elasticdl_tpu_torch/storage/cold_store.py``)
on the CPU: the JAX package's ``tests/test_tiered_store.py::
TestColdRowStore`` cases run against the port, and the two packages'
stores held to each other: the same puts, drops and compactions leave
byte-equal segment files and manifests, and a store written by either
package opens in the other with the same rows."""

import os

import numpy as np
import pytest

from elasticdl_tpu.storage import cold_store as jcold
from elasticdl_tpu_torch.storage import ColdRowStore
from elasticdl_tpu_torch.storage import cold_store as pcold
from elasticdl_tpu_torch.storage.cold_store import record_bytes
from elasticdl_tpu_torch.tools.check_store import check_store

DIM = 8


def _rows(rng, n):
    return rng.rand(n, DIM).astype(np.float32)


def test_roundtrip_overwrite_and_membership(tmp_path):
    store = ColdRowStore(str(tmp_path / "c"), dim=DIM,
                         background_compact=False)
    rng = np.random.RandomState(0)
    ids = np.arange(10, dtype=np.int64)
    rows = _rows(rng, 10)
    store.put_rows(ids, rows)
    np.testing.assert_array_equal(store.get_rows(ids), rows)
    assert store.num_rows == 10
    # Overwrite: the later record wins; the old one becomes garbage.
    newer = _rows(rng, 3)
    store.put_rows(ids[:3], newer)
    np.testing.assert_array_equal(store.get_rows(ids[:3]), newer)
    assert store.num_rows == 10
    assert store.stats()["garbage_records"] == 3
    mask = store.contains(np.array([0, 99], np.int64))
    np.testing.assert_array_equal(mask, [True, False])
    with pytest.raises(KeyError):
        store.get_rows([99])
    store.close()


def test_segment_rotation_bounded_files(tmp_path):
    # The segment bound fits 4 records: 32 rows roll across >= 8 files.
    store = ColdRowStore(
        str(tmp_path / "c"), dim=DIM,
        segment_max_bytes=4 * record_bytes(DIM),
        background_compact=False,
    )
    rng = np.random.RandomState(1)
    ids = np.arange(32, dtype=np.int64)
    rows = _rows(rng, 32)
    store.put_rows(ids, rows)
    assert len(ColdRowStore.list_segments(str(tmp_path / "c"))) >= 8
    np.testing.assert_array_equal(store.get_rows(ids), rows)
    store.close()


def test_compaction_reclaims_low_live_segments(tmp_path):
    store = ColdRowStore(
        str(tmp_path / "c"), dim=DIM,
        segment_max_bytes=4 * record_bytes(DIM),
        compact_live_fraction=0.6, background_compact=False,
    )
    rng = np.random.RandomState(2)
    ids = np.arange(16, dtype=np.int64)
    store.put_rows(ids, _rows(rng, 16))
    # Overwriting every row turns the first segments into garbage; the
    # inline compactor runs from put_rows itself.
    rows2 = _rows(rng, 16)
    store.put_rows(ids, rows2)
    stats = store.stats()
    assert all(s["live"] > 0 for s in stats["segments"].values())
    np.testing.assert_array_equal(store.get_rows(ids), rows2)
    on_disk = ColdRowStore.list_segments(str(tmp_path / "c"))
    assert set(on_disk) == set(stats["segments"])
    store.close()


def test_reopen_rebuilds_index_later_record_wins(tmp_path):
    path = str(tmp_path / "c")
    store = ColdRowStore(path, dim=DIM,
                         segment_max_bytes=4 * record_bytes(DIM),
                         background_compact=False,
                         compact_live_fraction=0.0)
    rng = np.random.RandomState(3)
    ids = np.arange(12, dtype=np.int64)
    store.put_rows(ids, _rows(rng, 12))
    newest = _rows(rng, 12)
    store.put_rows(ids, newest)
    # A crash leaves no index snapshot.
    store.close(write_index=False)
    reopened = ColdRowStore(path, fresh=False, background_compact=False)
    np.testing.assert_array_equal(reopened.get_rows(ids), newest)
    assert reopened.num_rows == 12
    reopened.close()


def test_torn_tail_truncates_on_reopen(tmp_path):
    path = str(tmp_path / "c")
    store = ColdRowStore(path, dim=DIM, background_compact=False)
    rng = np.random.RandomState(4)
    ids = np.arange(6, dtype=np.int64)
    rows = _rows(rng, 6)
    store.put_rows(ids, rows)
    store.close(write_index=False)
    seg = os.path.join(path, "segment-000000.seg")
    with open(seg, "rb+") as f:
        f.truncate(os.path.getsize(seg) - record_bytes(DIM) // 2)
    reopened = ColdRowStore(path, fresh=False, background_compact=False)
    # The torn record (id 5) is gone; everything before it is intact.
    assert reopened.num_rows == 5
    np.testing.assert_array_equal(reopened.get_rows(ids[:5]), rows[:5])
    reopened.close()


def test_drop_survives_clean_close(tmp_path):
    """drop_rows writes no tombstone: the clean close's index snapshot
    keeps a dropped row dead, and fsck counts its record as garbage."""
    path = str(tmp_path / "c")
    store = ColdRowStore(path, dim=DIM, background_compact=False,
                         compact_live_fraction=0.0)
    rng = np.random.RandomState(21)
    ids = np.arange(6, dtype=np.int64)
    store.put_rows(ids, _rows(rng, 6))
    assert store.drop_rows(np.array([2, 3], np.int64)) == 2
    store.close()
    errors, report = check_store(str(tmp_path))
    assert errors == []
    assert report["live_rows"] == 4
    assert report["stores"][0]["garbage_records"] == 2
    reopened = ColdRowStore(path, fresh=False, background_compact=False)
    assert reopened.num_rows == 4
    present = reopened.contains(ids)
    assert not present[2] and not present[3]
    assert present[[0, 1, 4, 5]].all()
    reopened.close()


def test_fresh_wipes_previous_contents(tmp_path):
    path = str(tmp_path / "c")
    store = ColdRowStore(path, dim=DIM, background_compact=False)
    store.put_rows(np.array([1], np.int64), np.ones((1, DIM), np.float32))
    store.close()
    wiped = ColdRowStore(path, dim=DIM, background_compact=False)
    assert wiped.num_rows == 0
    wiped.close()


def test_background_compactor_reclaims(tmp_path):
    """The compactor thread (the default) reaches the same end as the
    inline one: fully dead segments go, every row reads back."""
    import time

    store = ColdRowStore(
        str(tmp_path / "c"), dim=DIM,
        segment_max_bytes=4 * record_bytes(DIM),
        compact_live_fraction=0.6,
    )
    rng = np.random.RandomState(5)
    ids = np.arange(16, dtype=np.int64)
    store.put_rows(ids, _rows(rng, 16))
    rows2 = _rows(rng, 16)
    store.put_rows(ids, rows2)
    deadline = time.monotonic() + 30
    while store._compact_victim() is not None:
        assert time.monotonic() < deadline, store.stats()
        time.sleep(0.01)
    assert all(s["live"] > 0 for s in store.stats()["segments"].values())
    np.testing.assert_array_equal(store.get_rows(ids), rows2)
    store.close()


def test_mid_compact_hook_sees_the_victim(tmp_path):
    """The chaos seam runs after the victim's rows were re-appended and
    before its file goes: a raise there leaves both copies on disk, and
    a reopen reads the later (re-appended) records."""
    seen = []

    def hook(seg):
        seen.append(seg)
        raise RuntimeError("killed mid-compaction")

    path = str(tmp_path / "c")
    store = ColdRowStore(path, dim=DIM,
                         segment_max_bytes=4 * record_bytes(DIM),
                         compact_live_fraction=0.6,
                         background_compact=False)
    rng = np.random.RandomState(6)
    ids = np.arange(8, dtype=np.int64)
    store.put_rows(ids, _rows(rng, 8))
    pcold.set_chaos_hooks(mid_compact=hook)
    try:
        with pytest.raises(RuntimeError, match="mid-compaction"):
            store.drop_rows(ids[:3])
    finally:
        pcold.set_chaos_hooks()
    assert seen == [0]
    assert 0 in ColdRowStore.list_segments(path)
    want = store.get_rows(ids[3:])
    store.close(write_index=False)
    reopened = ColdRowStore(path, fresh=False, background_compact=False)
    np.testing.assert_array_equal(reopened.get_rows(ids[3:]), want)
    reopened.close()


# ---- the two packages' stores ---------------------------------------------


def _script(module, path):
    """The same puts, overwrites, drops and a compaction through one
    package's store, closed cleanly; returns its live rows."""
    store = module.ColdRowStore(
        path, dim=DIM, segment_max_bytes=4 * record_bytes(DIM),
        compact_live_fraction=0.6, background_compact=False,
    )
    rng = np.random.RandomState(7)
    store.put_rows(np.arange(12, dtype=np.int64), _rows(rng, 12))
    store.put_rows(np.array([9, 0, 5], np.int64), _rows(rng, 3))
    store.drop_rows(np.array([1, 2, 3], np.int64))
    store.put_rows(np.arange(20, 26, dtype=np.int64), _rows(rng, 6))
    compacted = store.compact_once()
    ids = store.live_ids()
    rows = store.get_rows(ids)
    stats = store.stats()
    store.close()
    return ids, rows, stats, compacted


def _files(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as fh:
            out[name] = fh.read()
    return out


def test_segments_and_manifest_byte_equal_to_jax(tmp_path):
    jids, jrows, jstats, _ = _script(jcold, str(tmp_path / "jax"))
    pids, prows, pstats, _ = _script(pcold, str(tmp_path / "port"))
    np.testing.assert_array_equal(pids, jids)
    np.testing.assert_array_equal(prows, jrows)
    assert pstats == jstats
    # The script compacted: segment 0 (3 dead of 4) was re-appended.
    assert 0 not in pstats["segments"]
    jfiles, pfiles = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(pfiles) == sorted(jfiles)
    assert "MANIFEST.json" in pfiles and "index.json" in pfiles
    for name in jfiles:
        assert pfiles[name] == jfiles[name], name
    assert pcold.record_bytes(DIM) == jcold.record_bytes(DIM)
    assert pcold.MANIFEST_FILE == jcold.MANIFEST_FILE
    assert pcold.INDEX_SNAPSHOT_FILE == jcold.INDEX_SNAPSHOT_FILE


@pytest.mark.parametrize("writer,reader", [(jcold, pcold), (pcold, jcold)])
@pytest.mark.parametrize("clean", [True, False])
def test_each_package_opens_the_others_store(tmp_path, writer, reader,
                                             clean):
    """A store written by one package (cleanly closed, or torn by a
    crash) opens in the other with the same rows and membership."""
    path = str(tmp_path / "c")
    store = writer.ColdRowStore(
        path, dim=DIM, segment_max_bytes=4 * record_bytes(DIM),
        compact_live_fraction=0.0, background_compact=False,
    )
    rng = np.random.RandomState(8)
    first = _rows(rng, 10)
    store.put_rows(np.arange(10, dtype=np.int64), first)
    store.put_rows(np.array([4, 7], np.int64), _rows(rng, 2))
    store.drop_rows(np.array([6], np.int64))
    ids = store.live_ids()
    rows = store.get_rows(ids)
    store.close(write_index=clean)
    if not clean:
        # Without the snapshot a drop is forgotten (the spill-cache
        # contract: the checkpoint restore owns durability), and a torn
        # tail truncates.
        seg = os.path.join(path, "segment-000002.seg")
        with open(seg, "ab") as fh:
            fh.write(b"\x01\x02torn")
    reopened = reader.ColdRowStore(path, fresh=False,
                                   background_compact=False)
    want_ids = ids if clean else np.arange(10, dtype=np.int64)
    np.testing.assert_array_equal(reopened.live_ids(), want_ids)
    got = reopened.get_rows(want_ids)
    np.testing.assert_array_equal(got[want_ids != 6], rows)
    if not clean:
        np.testing.assert_array_equal(got[6], first[6])
    reopened.close()
