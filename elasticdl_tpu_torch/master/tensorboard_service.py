"""Master-side TensorBoard service with a dependency-free tfevents writer
(copy of elasticdl_tpu/master/tensorboard_service.py; the Local
executor writes through it).

The reference's ``TensorboardService`` wraps a ``tf.summary`` writer and
spawns a ``tensorboard`` subprocess on the master
(reference master/tensorboard_service.py:8-50). This framework has no
TensorFlow, so the event-file format is implemented directly:

- TFRecord framing: ``uint64 length, masked_crc32c(length), payload,
  masked_crc32c(payload)``,
- payload: a hand-encoded ``tensorflow.Event`` protobuf
  (wall_time=1:double, step=2:int64, summary=5 → repeated
  ``Summary.Value`` with tag=1:string, simple_value=2:float),

which standard TensorBoard reads natively. Scalars are also mirrored to
``scalars.jsonl`` for toolless inspection.
"""

import json
import os
import socket
import struct
import subprocess
import time
from typing import Dict, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("tensorboard")

# crc32c (Castagnoli), table-driven, reflected polynomial 0x82F63B78.
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 & -(_c & 1))
    _CRC_TABLE.append(_c & 0xFFFFFFFF)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _encode_scalar_event(step: int, wall_time: float,
                         scalars: Dict[str, float]) -> bytes:
    values = b""
    for tag, val in scalars.items():
        tag_b = tag.encode()
        v = (
            _field(1, 2) + _varint(len(tag_b)) + tag_b
            + _field(2, 5) + struct.pack("<f", float(val))
        )
        values += _field(1, 2) + _varint(len(v)) + v
    event = (
        _field(1, 1) + struct.pack("<d", wall_time)
        + _field(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
        + _field(5, 2) + _varint(len(values)) + values
    )
    return event


def _frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class SummaryWriter:
    """Append-only tfevents writer for scalar summaries.

    A context manager (``with SummaryWriter(d) as w:``) that flushes on
    every write — a crashed master must leave readable event files, not
    a buffered tail."""

    def __init__(self, logdir: str):
        # exist_ok + recursive: the logdir (and any missing parents —
        # jobs point this at per-run subdirs that don't exist yet) is
        # created on first use.
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%d.%s" % (
            int(time.time()), socket.gethostname(),
        )
        self._path = os.path.join(logdir, fname)
        self._jsonl = os.path.join(logdir, "scalars.jsonl")
        self._f = open(self._path, "ab")
        # File-version event TensorBoard expects first.
        ver = b"brain.Event:2"
        first = (
            _field(1, 1) + struct.pack("<d", time.time())
            + _field(3, 2) + _varint(len(ver)) + ver
        )
        self._f.write(_frame(first))
        self._f.flush()

    def add_scalars(self, scalars: Dict[str, float], step: int):
        if self._f.closed:
            raise ValueError("SummaryWriter is closed")
        now = time.time()
        self._f.write(_frame(_encode_scalar_event(step, now, scalars)))
        self._f.flush()
        with open(self._jsonl, "a") as jf:
            jf.write(json.dumps(
                {"step": int(step), "wall_time": now, **{
                    k: float(v) for k, v in scalars.items()
                }}
            ) + "\n")

    def flush(self):
        if not self._f.closed:
            self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


class TensorboardService:
    """Scalar sink for train loss + eval metrics, with an optional
    ``tensorboard`` subprocess like the reference master
    (reference tensorboard_service.py:23-50)."""

    def __init__(self, tensorboard_log_dir: str, master_ip: str = ""):
        self._logdir = tensorboard_log_dir
        self._writer = SummaryWriter(tensorboard_log_dir)
        self._master_ip = master_ip
        self._tb_process: Optional[subprocess.Popen] = None

    def write_dict_to_summary(self, scalars: Dict[str, float], version: int):
        self._writer.add_scalars(scalars, version)

    def write_eval_metrics(self, version: int, results: Dict[str, float]):
        """EvaluationService summary-writer hook
        (reference evaluation_service.py:196-222 writes eval summaries)."""
        if results:
            self._writer.add_scalars(
                {f"eval/{k}": v for k, v in results.items()}, version
            )

    def start(self):
        """Best-effort launch of a tensorboard subprocess on the master."""
        try:
            self._tb_process = subprocess.Popen(
                ["tensorboard", "--logdir", self._logdir,
                 "--host", self._master_ip or "0.0.0.0"],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
        except FileNotFoundError:
            logger.warning(
                "tensorboard binary not found; event files still written "
                "to %s", self._logdir,
            )

    def keep_running(self) -> bool:
        return self._tb_process is not None and (
            self._tb_process.poll() is None
        )

    def close(self):
        self._writer.close()
        if self._tb_process is not None:
            self._tb_process.terminate()
