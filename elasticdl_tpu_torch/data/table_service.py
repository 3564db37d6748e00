"""Networked table plane: any TableSource served over the framework RPC
(port of elasticdl_tpu/data/table_service.py, over the port's
``comm/rpc.py``; the wire is the JAX package's).

The reference's remote-table story is ODPS/MaxCompute — workers range-read
a cloud table service over the network with retries
(``data/odps_io.py:61+``, ``data/reader/odps_reader.py:12-60``). This
module is the same architecture with the cloud service made first-class
and testable in-repo:

- ``TableService`` — serves ``count / column_names / read_range`` for a
  local TableSource (sqlite, CSV, ...) over ``comm/rpc.py`` msgpack RPC.
- ``RemoteTableSource`` — a TableSource whose reads go over the wire in
  row-range chunks. Transport errors (UNAVAILABLE / DEADLINE_EXCEEDED /
  CANCELLED) classify as transient, so the ``RetryingSource`` envelope
  in ``table_reader.py`` rides out a service relaunch mid-read — the
  kill-the-table-service-mid-task path is integration-tested like the
  embedding row service is.

Process entry: ``python -m elasticdl_tpu_torch.data.table_service
--data_origin table+sqlite:///path.db?table=t [--addr :6200]``.
"""

from typing import Iterator, List, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.comm.rpc import RpcError, RpcServer, RpcStub

logger = get_logger("table_service")

SERVICE_NAME = "TableService"
_TRANSIENT_CODES = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "CANCELLED")


class TableService:
    """Server: range-read endpoint over a local TableSource."""

    def __init__(self, source):
        self._source = source
        self._server: Optional[RpcServer] = None

    def handlers(self):
        return {
            "table_info": self._table_info,
            "read_range": self._read_range,
        }

    def _table_info(self, request: dict) -> dict:
        return {
            "count": int(self._source.count()),
            "columns": list(self._source.column_names()),
        }

    def _read_range(self, request: dict) -> dict:
        start, end = int(request["start"]), int(request["end"])
        return {"rows": list(self._source.read(start, end))}

    def start(self, addr: str = "localhost:0") -> "TableService":
        self._server = RpcServer(
            addr, {SERVICE_NAME: self.handlers()}
        ).start()
        logger.info("Table service on port %d", self._server.port)
        return self

    @property
    def port(self) -> int:
        return self._server.port

    def stop(self, grace: Optional[float] = None):
        if self._server is not None:
            self._server.stop(grace)

    def wait(self):
        self._server.wait()


class RemoteTableSource:
    """Client: a TableSource reading row ranges from a TableService.

    No internal retry loop — transient-vs-permanent classification here,
    retry policy in the shared ``RetryingSource`` envelope (which every
    ``TableDataReader`` applies). Chunked range reads mean a mid-task
    service death loses at most one chunk of progress; the envelope
    resumes at the exact row offset after the relaunch.
    """

    def __init__(self, addr: str, chunk: int = 512):
        self._stub = RpcStub(addr, SERVICE_NAME)
        self._chunk = int(chunk)
        self._info = None

    # TableSource interface -------------------------------------------

    def _table_info(self) -> dict:
        if self._info is None:
            self._info = self._stub.call("table_info")
        return self._info

    def count(self) -> int:
        return int(self._table_info()["count"])

    def column_names(self) -> List[str]:
        return list(self._table_info()["columns"])

    def read(self, start: int, end: int) -> Iterator[dict]:
        for lo in range(start, end, self._chunk):
            hi = min(lo + self._chunk, end)
            for row in self._stub.call(
                "read_range", start=lo, end=hi
            )["rows"]:
                yield row

    def is_transient_error(self, exc: BaseException) -> bool:
        if isinstance(exc, RpcError):
            return exc.code in _TRANSIENT_CODES
        return isinstance(exc, (OSError, IOError))

    def close(self):
        pass


def main(argv=None):
    import argparse

    from elasticdl_tpu_torch.data.table_reader import open_table_source

    parser = argparse.ArgumentParser("elasticdl_tpu_torch-table-service")
    parser.add_argument("--data_origin", required=True,
                        help="Local table origin to serve, e.g. "
                             "table+sqlite:///path.db?table=t")
    parser.add_argument("--addr", default="[::]:6200")
    args = parser.parse_args(argv)

    service = TableService(open_table_source(args.data_origin))
    service.start(args.addr)
    logger.info("Table service serving %s on %s",
                args.data_origin, args.addr)
    service.wait()


if __name__ == "__main__":
    main()
