"""The port's data path (elasticdl_tpu_torch/data/) against
elasticdl_tpu/data/: shards and batches of the same files, and the
prefetch thread's error and close behaviour."""

import numpy as np
import pytest

from elasticdl_tpu.data import batcher as jbatcher
from elasticdl_tpu.data import factory as jfactory
from elasticdl_tpu.testing import data as jdata
from elasticdl_tpu_torch.common.task import Task
from elasticdl_tpu_torch.data import batcher, factory
from elasticdl_tpu_torch.data.prefetch import prefetch
from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm


def _records(reader, shards):
    out = []
    for name, (start, count) in sorted(shards.items()):
        out += list(reader.read_records(
            Task(shard_name=name, start=start, end=start + count)))
    return out


@pytest.mark.parametrize("kind", ["record_file", "csv"])
def test_readers_shard_and_read_like_jax(tmp_path, kind):
    if kind == "csv":
        origin = jdata.create_iris_csv(str(tmp_path / "iris.csv"), 20)
    else:
        for i in range(2):
            jdata.create_lm_record_file(str(tmp_path / f"p{i}.rec"), 5 + i,
                                        seed=i)
        origin = str(tmp_path)
    port = factory.create_data_reader(origin)
    ref = jfactory.create_data_reader(origin)
    shards = port.create_shards()
    assert shards == ref.create_shards()
    assert _records(port, shards) == _records(ref, shards)
    assert port.records_output_type == ref.records_output_type


def test_stream_and_table_origins_are_not_ported(tmp_path):
    """Stream and table origins dispatch as JAX's factory does: stream
    origins to ``data/stream.py`` (held to JAX in
    tests/test_torch_stream.py), table origins and ``reader_type=Table``
    to ``data/table_reader.TableDataReader`` (held to JAX in
    tests/test_torch_table_reader.py), ``odps://`` refused alike without
    pyodps."""
    import sqlite3

    from elasticdl_tpu_torch.common.constants import ReaderType
    from elasticdl_tpu_torch.data.stream import StreamDataReader
    from elasticdl_tpu_torch.data.table_reader import TableDataReader

    assert isinstance(factory.create_data_reader("stream:///tmp/x"),
                      StreamDataReader)
    db = str(tmp_path / "t.db")
    with sqlite3.connect(db) as conn:
        conn.execute("CREATE TABLE data (a INTEGER, b TEXT)")
        conn.executemany("INSERT INTO data VALUES (?, ?)",
                         [(i, f"r{i}") for i in range(5)])
    csv = str(tmp_path / "t.csv")
    with open(csv, "w") as f:
        f.write("a,b\n" + "".join(f"{i},r{i}\n" for i in range(5)))
    for origin, kwargs in ((f"table+sqlite://{db}", {}),
                           (f"table+csv://{csv}", {}),
                           (f"table+sqlite://{db}",
                            {"reader_type": ReaderType.TABLE})):
        port = factory.create_data_reader(origin, **dict(kwargs))
        ref = jfactory.create_data_reader(origin, **dict(kwargs))
        assert isinstance(port, TableDataReader)
        shards = port.create_shards()
        assert shards == ref.create_shards() == {origin: (0, 5)}
        assert _records(port, shards) == _records(ref, shards)
    assert isinstance(
        factory.create_data_reader("table+rpc://localhost:1"),
        TableDataReader)
    for mod in (factory, jfactory):
        with pytest.raises(ImportError, match="pyodps"):
            mod.create_data_reader("odps://p/tables/t")


@pytest.mark.parametrize("n", [16, 21])
def test_batches_match_jax(tmp_path, n):
    path = jdata.create_lm_record_file(str(tmp_path / "lm.rec"), n,
                                       seed=3, seq_len=8)
    reader = factory.create_data_reader(path)
    records = _records(reader, reader.create_shards())
    got = list(batcher.batch_records(iter(records), 8,
                                     transformer_lm.dataset_fn, "training",
                                     None))
    want = list(jbatcher.batch_records(iter(records), 8,
                                       transformer_lm.dataset_fn,
                                       "training", None))
    assert len(got) == len(want) == -(-n // 8)
    for g, w in zip(got, want):
        for key in ("features", "labels", "mask"):
            np.testing.assert_array_equal(g[key], w[key])


def test_prefetch_reraises_and_closes():
    def failing():
        yield 1
        raise KeyError("bad record")

    with prefetch(failing(), 2) as items:
        assert next(items) == 1
        with pytest.raises(KeyError, match="bad record"):
            next(items)
    blocked = prefetch(iter(range(100)), 1)
    assert next(blocked) == 0
    blocked.close()
    assert not blocked._thread.is_alive()
