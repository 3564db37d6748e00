"""The port's table readers (``elasticdl_tpu_torch/data/table_reader.py``,
``table_service.py``) held to the JAX package's on the CPU.

Both readers over one sqlite file and one CSV give byte-equal records
(each row a msgpack dict from either package's codec) and equal shards,
with and without the ordered thread-pool prefetch; a flaky source's
retries resume at the same offsets and split transient from fatal
errors alike; the table service crossed both ways (a JAX server read by
a port client, a port server read by a JAX client) gives equal rows;
the factory's schemes and the ``odps://`` gate behave alike; and
census_sqlflow trains through the port's ``MiniCluster`` over
``table+sqlite://`` as many batches as the JAX test
(tests/test_table_reader_and_tools.py:292). Backoffs are 0 s: no test
sleeps.
"""

import csv
import os
import socket
import sqlite3
import subprocess
import sys

import numpy as np
import pytest

from elasticdl_tpu.comm import rpc as jrpc
from elasticdl_tpu.common.task import Task as JTask
from elasticdl_tpu.data import factory as jfactory
from elasticdl_tpu.data import table_reader as jtr
from elasticdl_tpu.data import table_service as jts
from elasticdl_tpu_torch.comm import rpc as prpc
from elasticdl_tpu_torch.common.task import Task
from elasticdl_tpu_torch.data import factory as pfactory
from elasticdl_tpu_torch.data import table_reader as ptr
from elasticdl_tpu_torch.data import table_service as pts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 100


@pytest.fixture()
def tables(tmp_path):
    """One sqlite table and one CSV of the same 100 mixed-type rows."""
    rng = np.random.RandomState(7)
    rows = [(float(rng.rand()), int(rng.randint(-50, 50)),
             f"s{int(rng.randint(1000))}", i % 3) for i in range(ROWS)]
    db = str(tmp_path / "data.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (a REAL, b INTEGER, c TEXT, label "
                 "INTEGER)")
    conn.executemany("INSERT INTO t VALUES (?,?,?,?)", rows)
    conn.commit()
    conn.close()
    path = str(tmp_path / "data.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["a", "b", "c", "label"])
        w.writerows(rows)
    return {"sqlite": f"table+sqlite://{db}?table=t",
            "csv": f"table+csv://{path}"}


def _read(reader, task_cls, start, end):
    return list(reader.read_records(
        task_cls(shard_name="t", start=start, end=end)))


@pytest.mark.parametrize("threads", [0, 3])
@pytest.mark.parametrize("kind", ["sqlite", "csv"])
def test_readers_give_byte_equal_records_and_shards(tables, kind,
                                                    threads):
    origin = tables[kind]
    kwargs = dict(num_prefetch_threads=threads, prefetch_chunk=7)
    port = pfactory.create_data_reader(origin, **kwargs)
    ref = jfactory.create_data_reader(origin, **kwargs)
    assert isinstance(port, ptr.TableDataReader)
    assert port.create_shards() == ref.create_shards() == {
        origin: (0, ROWS)}
    assert port.metadata.column_names == ref.metadata.column_names
    for start, end in ((0, ROWS), (13, 58), (97, ROWS)):
        got = _read(port, Task, start, end)
        assert got == _read(ref, JTask, start, end)
        assert len(got) == end - start


class _Flaky:
    """Yields rows, dying with ``exc`` after ``die_after`` rows of each
    read, ``failures`` times; ``count`` fails ``count_fails`` times."""

    def __init__(self, is_transient, n=20, die_after=7, failures=2,
                 exc=ConnectionError, count_fails=0):
        self._is_transient = is_transient
        self.n, self.die_after, self.failures = n, die_after, failures
        self.exc, self.count_fails = exc, count_fails
        self.read_calls = []

    def count(self):
        if self.count_fails:
            self.count_fails -= 1
            raise TimeoutError("slow")
        return self.n

    def column_names(self):
        return ["v"]

    def is_transient_error(self, exc):
        return self._is_transient(exc)

    def read(self, start, end):
        self.read_calls.append(start)
        for i in range(start, end):
            if self.failures and i - start >= self.die_after:
                self.failures -= 1
                raise self.exc("mid-stream failure")
            yield {"v": i}

    def close(self):
        pass


def _envelope_run(mod, case):
    kwargs, max_retries = case
    src = _Flaky(mod.is_transient_error, **kwargs)
    wrapped = mod.RetryingSource(src, max_retries=max_retries,
                                 backoff_secs=0.0)
    out = {"count": None, "rows": None, "error": None}
    try:
        out["count"] = wrapped.count()
        out["rows"] = [r["v"] for r in wrapped.read(0, src.n)]
    except Exception as exc:
        out["error"] = type(exc).__name__
    out["calls"] = src.read_calls
    return out


@pytest.mark.parametrize("case", [
    ({"die_after": 7, "failures": 2}, 5),          # resume, no dupes
    ({"die_after": 3, "failures": 99, "exc": ValueError}, 5),  # fatal
    ({"die_after": 0, "failures": 99}, 2),         # budget exhausted
    ({"die_after": 5, "failures": 4}, 1),          # budget per failure
    ({"count_fails": 1, "failures": 0}, 2),        # count retried
    ({"count_fails": 3, "failures": 0}, 2),        # count exhausted
], ids=["resume", "fatal", "exhausted", "reset", "count", "count-out"])
def test_flaky_source_retries_match(case):
    got, want = _envelope_run(ptr, case), _envelope_run(jtr, case)
    assert got == want


def test_transient_fatal_split_matches():
    errors = [
        sqlite3.OperationalError("database is locked"),
        sqlite3.OperationalError("no such table: t"),
        sqlite3.OperationalError("near x: syntax error"),
        sqlite3.OperationalError("disk I/O error"),
        sqlite3.IntegrityError("constraint"),
        FileNotFoundError("gone"), ConnectionError("reset"),
        TimeoutError("slow"), OSError("eio"), ValueError("schema"),
        KeyError("col"), RuntimeError("bug"),
    ]
    assert [ptr.is_transient_error(e) for e in errors] == \
        [jtr.is_transient_error(e) for e in errors]
    assert ptr.OdpsTableSource._TRANSIENT_ERROR_NAMES == \
        jtr.OdpsTableSource._TRANSIENT_ERROR_NAMES
    codes = ["UNAVAILABLE", "DEADLINE_EXCEEDED", "CANCELLED",
             "INVALID_ARGUMENT", "INTERNAL", "UNKNOWN"]
    port = pts.RemoteTableSource("localhost:1")
    ref = jts.RemoteTableSource("localhost:1")
    assert [port.is_transient_error(prpc.RpcError("x", c))
            for c in codes] == \
        [ref.is_transient_error(jrpc.RpcError("x", c)) for c in codes]
    assert port.is_transient_error(OSError()) \
        == ref.is_transient_error(OSError())


def test_ordered_prefetch_over_three_threads(tables):
    db = tables["sqlite"][len("table+sqlite://"):].split("?")[0]

    class FailingAt50:
        def __init__(self, base):
            self.base = base

        def __getattr__(self, name):
            return getattr(self.base, name)

        def read(self, start, end):
            if start >= 50:
                raise RuntimeError("range read failed")
            return self.base.read(start, end)

    for mod, task_cls in ((ptr, Task), (jtr, JTask)):
        reader = mod.TableDataReader("x", source=mod.SqliteTableSource(
            db, "t"), num_prefetch_threads=3, prefetch_chunk=9)
        plain = mod.TableDataReader("x", source=mod.SqliteTableSource(
            db, "t"))
        assert _read(reader, task_cls, 0, ROWS) == \
            _read(plain, task_cls, 0, ROWS)
        failing = mod.TableDataReader(
            "x", source=FailingAt50(mod.SqliteTableSource(db, "t")),
            num_prefetch_threads=3, prefetch_chunk=9)
        with pytest.raises(RuntimeError, match="range read failed"):
            _read(failing, task_cls, 0, ROWS)


@pytest.mark.parametrize("server", ["jax", "port"])
def test_table_service_crossed(tables, server):
    """A JAX ``TableService`` read by the port's ``RemoteTableSource``
    and reader, and the reverse: the same rows and record bytes as the
    local source."""
    db = tables["sqlite"][len("table+sqlite://"):].split("?")[0]
    srv_mod, src_mod = (jts, jtr) if server == "jax" else (pts, ptr)
    cli_ts, cli_tr, task_cls = (pts, ptr, Task) if server == "jax" \
        else (jts, jtr, JTask)
    svc = srv_mod.TableService(src_mod.SqliteTableSource(db, "t")).start(
        "localhost:0")
    try:
        remote = cli_ts.RemoteTableSource(f"localhost:{svc.port}",
                                          chunk=16)
        local = cli_tr.SqliteTableSource(db, "t")
        assert remote.count() == ROWS
        assert remote.column_names() == local.column_names()
        assert list(remote.read(5, 61)) == list(local.read(5, 61))
        origin = f"table+rpc://localhost:{svc.port}"
        reader = cli_tr.TableDataReader(origin)
        assert reader.create_shards() == {origin: (0, ROWS)}
        want = cli_tr.TableDataReader("x", source=local)
        assert _read(reader, task_cls, 3, 90) == \
            _read(want, task_cls, 3, 90)
    finally:
        svc.stop(0)


def test_table_service_main_serves_a_jax_client(tables):
    """``python -m elasticdl_tpu_torch.data.table_service`` serves the
    origin it is given; a JAX client reads it."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.data.table_service",
         "--data_origin", tables["csv"], "--addr", f"localhost:{port}"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        # Connect once it listens: a channel refused at its start backs
        # off for seconds.
        for line in proc.stderr:
            if "Table service on port" in line:
                break
        else:
            pytest.fail(f"table service exited {proc.wait()}")
        src = jts.RemoteTableSource(f"localhost:{port}")
        want = jtr.CsvTableSource(tables["csv"][len("table+csv://"):])
        assert src.count() == ROWS
        assert list(src.read(0, ROWS)) == list(want.read(0, ROWS))
    finally:
        proc.terminate()
        proc.communicate(timeout=30)


def test_factory_schemes_and_odps_gate(tables, monkeypatch):
    for kind, cls in (("sqlite", "SqliteTableSource"),
                      ("csv", "CsvTableSource")):
        assert type(ptr.open_table_source(tables[kind])).__name__ == \
            type(jtr.open_table_source(tables[kind])).__name__ == cls
    assert type(ptr.open_table_source("table+rpc://h:1")).__name__ == \
        type(jtr.open_table_source("table+rpc://h:1")).__name__
    monkeypatch.setitem(sys.modules, "odps", None)
    for mod in (ptr, jtr):
        with pytest.raises(ImportError, match="pyodps"):
            mod.open_table_source("odps://proj/tables/foo")
        with pytest.raises(ValueError, match="Unrecognized"):
            mod.open_table_source("table+nope://x")
    for mod in (pfactory, jfactory):
        with pytest.raises(ImportError, match="pyodps"):
            mod.create_data_reader("odps://proj/tables/foo")


def test_census_sqlflow_trains_from_sqlite_table(tmp_path):
    """tests/test_table_reader_and_tools.py:258's job through the port's
    ``MiniCluster`` on the CPU: 96 rows, B 16, 2 epochs = 12 batches."""
    from elasticdl_tpu_torch.testing.cluster import MiniCluster
    from elasticdl_tpu_torch.testing.data import model_zoo_dir

    path = str(tmp_path / "census.db")
    conn = sqlite3.connect(path)
    conn.execute(
        "CREATE TABLE census (education TEXT, workclass TEXT, "
        "age REAL, hours_per_week REAL, label INTEGER)"
    )
    rng = np.random.RandomState(0)
    education = ["Bachelors", "HS-grad", "Masters", "Doctorate"]
    workclass = ["Private", "Self-emp", "Federal-gov", "Local-gov"]
    rows = []
    for _ in range(96):
        edu = int(rng.randint(len(education)))
        work = int(rng.randint(len(workclass)))
        age = float(20 + rng.rand() * 50)
        hours = float(10 + rng.rand() * 60)
        rows.append((education[edu], workclass[work], age, hours,
                     int(age + 10 * edu > 55)))
    conn.executemany("INSERT INTO census VALUES (?,?,?,?,?)", rows)
    conn.commit()
    conn.close()
    cluster = MiniCluster(
        model_zoo=model_zoo_dir(),
        model_def="census.census_sqlflow.custom_model",
        training_data=f"table+sqlite://{path}?table=census",
        minibatch_size=16, num_epochs=2, device="cpu",
    )
    results = cluster.run()
    assert cluster.finished
    assert results[0]["trained_batches"] == 12
    assert np.isfinite(results[0]["final_loss"])
