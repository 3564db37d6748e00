"""Table data reader — the ODPS/MaxCompute plane (port of
elasticdl_tpu/data/table_reader.py).

Reference parity targets: ``data/reader/odps_reader.py:12-60`` (shard =
table row-range), ``data/odps_io.py`` (retrying range reads) and
``data/parallel_odps_table_reader.py`` (thread-pool prefetch of ranges).

Design: the reader is generic over a ``TableSource`` (count + range read
of rows); concrete sources:

- ``SqliteTableSource`` — stdlib sqlite3, rowid-range addressable; the
  in-repo stand-in for a cloud table service, fully testable.
- ``CsvTableSource`` — header CSV as a table.
- ``OdpsTableSource`` — real MaxCompute via pyodps, import-gated: this
  image has no pyodps (and no egress), so constructing it without the
  package raises with instructions, mirroring how the reference gates
  ODPS tests behind env vars.

Rows are serialized to msgpack dicts (column name → value) so the user
``dataset_fn`` sees the same payloads as any other reader.
"""

import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.reader import AbstractDataReader, Metadata

logger = get_logger("table_reader")


class TableSource:
    """count() + read(start, end) over ordered rows."""

    def count(self) -> int:
        raise NotImplementedError

    def column_names(self) -> List[str]:
        raise NotImplementedError

    def read(self, start: int, end: int) -> Iterator[dict]:
        """Yield rows [start, end) as column dicts."""
        raise NotImplementedError

    def is_transient_error(self, exc: BaseException) -> bool:
        """Whether a read/count failure is worth retrying. Sources with
        richer error models (RPC status codes) override this."""
        return is_transient_error(exc)

    def close(self):
        pass


def is_transient_error(exc: BaseException) -> bool:
    """Default transient/permanent classification for table IO.

    Transient (retry): network/file-system hiccups (OSError family incl.
    ConnectionError/TimeoutError) and sqlite busy/locked
    (sqlite3.OperationalError). Permanent (surface immediately): schema
    and programming errors — ValueError/KeyError/TypeError, missing
    tables — where a retry would just repeat the failure. The reference
    retried *every* exception (odps_io.py:243-265 catches Exception);
    classifying keeps genuine bugs loud, which its own tests relied on.
    """
    import sqlite3

    if isinstance(exc, sqlite3.OperationalError):
        # sqlite uses OperationalError for BOTH contention (locked/busy
        # — transient) and misconfiguration (no such table/column, SQL
        # syntax — permanent). Classify by message; unknown operational
        # errors default to transient (IO-flavored in practice).
        msg = str(exc).lower()
        permanent = ("no such table", "no such column", "syntax error",
                     "unable to open database")
        return not any(p in msg for p in permanent)
    if isinstance(exc, sqlite3.Error):
        return False
    if isinstance(exc, FileNotFoundError):
        return False  # a missing file won't appear by retrying
    return isinstance(exc, OSError)


class RetryingSource(TableSource):
    """Fault envelope around any TableSource (reference ``odps_io.py``
    ``record_generator_with_retry`` / ``read_batch`` retry loops).

    Improvements over the reference envelope:

    - **Resume, don't restart**: the reference re-runs the generator
      from ``start`` after a mid-stream failure, re-yielding rows the
      consumer already saw (duplicated training records). Here the
      retry resumes at ``start + rows_already_yielded``.
    - **Error classification**: only transient errors retry
      (``is_transient_error`` — the wrapped source can override);
      permanent ones surface immediately.
    - Exponential backoff with a cap, vs the reference's fixed 5 s.
    """

    def __init__(self, source: TableSource, max_retries: int = 5,
                 backoff_secs: float = 0.5, backoff_cap: float = 30.0):
        self._source = source
        self._max_retries = int(max_retries)
        self._backoff = float(backoff_secs)
        self._cap = float(backoff_cap)

    def _retry_loop(self, what: str, fn):
        delay = self._backoff
        for attempt in range(self._max_retries + 1):
            try:
                return fn()
            except Exception as exc:
                if (
                    not self._source.is_transient_error(exc)
                    or attempt == self._max_retries
                ):
                    raise
                logger.warning(
                    "table %s failed (%s: %s); retry %d/%d in %.1fs",
                    what, type(exc).__name__, exc, attempt + 1,
                    self._max_retries, delay,
                )
                time.sleep(delay)
                delay = min(delay * 2, self._cap)

    def count(self) -> int:
        return self._retry_loop("count", self._source.count)

    def column_names(self) -> List[str]:
        return self._retry_loop("column_names", self._source.column_names)

    def read(self, start: int, end: int) -> Iterator[dict]:
        yielded = 0
        delay = self._backoff
        attempt = 0
        progressed = False
        while True:
            try:
                for row in self._source.read(start + yielded, end):
                    yield row
                    yielded += 1
                    progressed = True
                return
            except Exception as exc:
                if progressed:
                    # A recovered-and-resumed stretch means the service
                    # is healthy between failures: fresh budget per
                    # failure, not cumulative over a minutes-long shard
                    # (6 individually-recovered restarts must not kill
                    # the task on the 6th).
                    attempt = 0
                    delay = self._backoff
                    progressed = False
                if (
                    not self._source.is_transient_error(exc)
                    or attempt >= self._max_retries
                ):
                    raise
                attempt += 1
                logger.warning(
                    "table read [%d, %d) failed at +%d rows (%s: %s); "
                    "retry %d/%d in %.1fs", start, end, yielded,
                    type(exc).__name__, exc, attempt, self._max_retries,
                    delay,
                )
                time.sleep(delay)
                delay = min(delay * 2, self._cap)

    def is_transient_error(self, exc: BaseException) -> bool:
        return self._source.is_transient_error(exc)

    def close(self):
        self._source.close()


class SqliteTableSource(TableSource):
    def __init__(self, path: str, table: str):
        import sqlite3

        self._path = path
        self._table = table
        # One connection per thread (sqlite objects are thread-bound and
        # the parallel reader fans ranges out over a pool).
        self._local = threading.local()
        cols = self._conn().execute(
            f"PRAGMA table_info({self._quoted})"
        ).fetchall()
        if not cols:
            raise ValueError(f"No such table {table!r} in {path}")
        self._columns = [c[1] for c in cols]

    @property
    def _quoted(self) -> str:
        return '"' + self._table.replace('"', '""') + '"'

    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            import sqlite3

            conn = sqlite3.connect(self._path)
            self._local.conn = conn
        return conn

    def count(self) -> int:
        row = self._conn().execute(
            f"SELECT COUNT(*) FROM {self._quoted}"
        ).fetchone()
        return int(row[0])

    def column_names(self) -> List[str]:
        return list(self._columns)

    def read(self, start: int, end: int) -> Iterator[dict]:
        # Index the range via rowid (the PK btree) instead of
        # LIMIT/OFFSET, which walks all `start` rows per call — O(n^2)
        # over a chunked shard scan. Rowids are 1-based and contiguous
        # for append-only tables (our ingest pattern; a table with
        # deletions should be compacted/VACUUMed first).
        cursor = self._conn().execute(
            f"SELECT * FROM {self._quoted} "
            f"WHERE rowid > ? AND rowid <= ? ORDER BY rowid",
            (start, end),
        )
        for row in cursor:
            yield dict(zip(self._columns, row))


class CsvTableSource(TableSource):
    def __init__(self, path: str):
        import csv

        self._path = path
        with open(path, newline="") as f:
            reader = csv.reader(f)
            self._columns = next(reader)
            self._num_rows = sum(1 for _ in reader)

    def count(self) -> int:
        return self._num_rows

    def column_names(self) -> List[str]:
        return list(self._columns)

    def read(self, start: int, end: int) -> Iterator[dict]:
        import csv

        with open(self._path, newline="") as f:
            reader = csv.reader(f)
            next(reader)  # header
            for i, row in enumerate(reader):
                if i >= end:
                    return
                if i >= start:
                    yield dict(zip(self._columns, row))


class OdpsTableSource(TableSource):
    """MaxCompute table via pyodps (import-gated; reference
    ``odps_io.py:61-142`` ODPSReader: project/endpoint/table[,partition]
    range reads over ``open_reader``).

    The class body is exercised against a faked pyodps API in
    tests/test_table_reader_and_tools.py (this image has no pyodps and
    no egress); only the import itself is environment-gated.
    """

    # pyodps exception class names worth retrying (reference
    # odps_io.py:243-265 retried everything; we classify — server-side
    # and connection flakes retry, schema/auth errors surface).
    _TRANSIENT_ERROR_NAMES = frozenset({
        "ConnectTimeout", "ReadTimeout", "Timeout",
        "InternalServerError", "ServiceUnavailable",
        "RequestTimeTooSkewed", "StreamError",
    })

    def __init__(self, project: str, table: str, access_id: str = "",
                 access_key: str = "", endpoint: str = "",
                 partition: str = ""):
        try:
            import odps  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "OdpsTableSource requires the 'pyodps' package, which is "
                "not available in this environment; use a sqlite:// or "
                "csv table origin, or install pyodps where egress exists."
            ) from e
        from odps import ODPS

        self._odps = ODPS(access_id, access_key, project,
                          endpoint=endpoint)
        self._table = self._odps.get_table(table)
        self._partition = partition or None
        self._columns = [c.name for c in self._table.schema.columns]

    def _open_reader(self):
        if self._partition:
            return self._table.open_reader(partition=self._partition)
        return self._table.open_reader()

    def count(self) -> int:
        with self._open_reader() as reader:
            return reader.count

    def column_names(self) -> List[str]:
        return list(self._columns)

    def read(self, start: int, end: int) -> Iterator[dict]:
        with self._open_reader() as reader:
            for record in reader.read(start=start, count=end - start):
                yield dict(zip(self._columns, record.values))

    def is_transient_error(self, exc: BaseException) -> bool:
        for klass in type(exc).__mro__:
            if klass.__name__ in self._TRANSIENT_ERROR_NAMES:
                return True
        return is_transient_error(exc)


def open_table_source(data_origin: str) -> TableSource:
    """Parse a table origin URL:

    - ``table+sqlite:///path/to.db?table=name``
    - ``table+csv:///path/to.csv``
    - ``table+rpc://host:port`` (a running data.table_service)
    - ``odps://project/tables/name``
    """
    parsed = urlparse(data_origin)
    scheme = parsed.scheme
    if scheme == "table+sqlite":
        q = parse_qs(parsed.query)
        table = q.get("table", ["data"])[0]
        return SqliteTableSource(parsed.path, table)
    if scheme == "table+csv":
        return CsvTableSource(parsed.path)
    if scheme == "table+rpc":
        from elasticdl_tpu_torch.data.table_service import RemoteTableSource

        return RemoteTableSource(parsed.netloc)
    if scheme == "odps":
        import os

        parts = parsed.path.strip("/").split("/")
        table = parts[-1] if parts else ""
        q = parse_qs(parsed.query)
        # Credentials come from the reference's MaxCompute env contract
        # (common/constants.py:15-18: MAXCOMPUTE_AK/SK/ENDPOINT), never
        # from the URL.
        return OdpsTableSource(
            project=parsed.netloc, table=table,
            access_id=os.environ.get("MAXCOMPUTE_AK", ""),
            access_key=os.environ.get("MAXCOMPUTE_SK", ""),
            endpoint=os.environ.get("MAXCOMPUTE_ENDPOINT", ""),
            partition=q.get("partition", [""])[0],
        )
    raise ValueError(f"Unrecognized table origin {data_origin!r}")


class TableDataReader(AbstractDataReader):
    """Row-range sharded reader over a TableSource (reference
    odps_reader.py: one shard table, shards = row ranges; the dispatcher
    splits the range into tasks)."""

    def __init__(self, data_origin: str, source: Optional[TableSource] =
                 None, num_prefetch_threads: int = 0,
                 prefetch_chunk: int = 256, max_retries: int = 5,
                 backoff_secs: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self._data_origin = data_origin
        source = source or open_table_source(data_origin)
        # Every source rides the fault envelope (reference readers
        # retried inside odps_io; a transient error must not kill the
        # task — the dispatcher's 3-retry budget is for real failures).
        if not isinstance(source, RetryingSource):
            source = RetryingSource(
                source, max_retries=max_retries, backoff_secs=backoff_secs
            )
        self._source = source
        self._num_prefetch_threads = int(num_prefetch_threads)
        self._prefetch_chunk = int(prefetch_chunk)

    def create_shards(self) -> Dict[str, Tuple[int, int]]:
        return {self._data_origin: (0, self._source.count())}

    def read_records(self, task) -> Iterator[bytes]:
        rows = (
            self._parallel_rows(task.start, task.end)
            if self._num_prefetch_threads > 1
            else self._source.read(task.start, task.end)
        )
        for row in rows:
            yield tensor_utils.dumps(row)

    def _parallel_rows(self, start: int, end: int) -> Iterator[dict]:
        """Thread-pool range prefetch preserving row order (reference
        parallel_odps_table_reader.py). ``executor.map`` keeps order and
        re-raises worker exceptions in the consumer, so a failing range
        read fails the task instead of hanging it."""
        from concurrent.futures import ThreadPoolExecutor

        chunk = self._prefetch_chunk
        ranges = [
            (s, min(s + chunk, end)) for s in range(start, end, chunk)
        ]
        with ThreadPoolExecutor(self._num_prefetch_threads) as pool:
            for rows in pool.map(
                lambda r: list(self._source.read(*r)), ranges
            ):
                yield from rows

    @property
    def metadata(self) -> Metadata:
        return Metadata(column_names=self._source.column_names())
