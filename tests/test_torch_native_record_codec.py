"""The port's native RecordFile range reader (``native/record_ext.c``
through ``native/record_codec.py``) and the reader's native path
(``data/reader.py``), against the port's Python scanner and the JAX
package's extension.

The cases of ``tests/test_native_record_codec.py`` run against the port.
Also: the three readers give equal records on one file; the mean-record
gate (1024 bytes) sends large records to the scanner; a task range past
the file's end clamps on both paths; a corrupt file and an out-of-range
read raise ValueError; ``ELASTICDL_TPU_TORCH_NO_NATIVE=1`` switches the
extension off; the extension builds into ``native/_build/`` under a name
keyed on the interpreter's ABI, and the reader counts its native range
reads.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import elasticdl_tpu_torch.native as native
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.task import Task
from elasticdl_tpu_torch.data import reader as reader_mod
from elasticdl_tpu_torch.data.reader import RecordFileDataReader
from elasticdl_tpu_torch.data.record_file import (
    RecordFileScanner,
    RecordFileWriter,
)
from elasticdl_tpu_torch.native.record_codec import (
    native_record_reader_available,
    num_records,
    read_range,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_native = pytest.mark.skipif(
    not native_record_reader_available(),
    reason="native record codec unavailable (no gcc or Python.h)",
)


def _write(path, payloads):
    with RecordFileWriter(path) as writer:
        for p in payloads:
            writer.write(p)
    return path


@pytest.fixture()
def record_file(tmp_path):
    rng = np.random.RandomState(0)
    payloads = [
        tensor_utils.dumps({"x": rng.randn(rng.randint(1, 8)).tolist(),
                            "i": i})
        for i in range(50)
    ]
    return _write(str(tmp_path / "data.rec"), payloads), payloads


def _scan(path, start, count):
    with RecordFileScanner(path, start, count) as scanner:
        return list(scanner)


@needs_native
def test_matches_python_scanner(record_file):
    path, payloads = record_file
    assert num_records(path) == 50
    got = read_range(path, 7, 20)
    assert got == _scan(path, 7, 20) == payloads[7:27]


@needs_native
def test_port_and_jax_extensions_and_the_scanner_agree(record_file):
    from elasticdl_tpu.native.record_codec import (
        native_record_reader_available as jax_available,
    )
    from elasticdl_tpu.native.record_codec import read_range as jax_read

    path, payloads = record_file
    if not jax_available():
        pytest.skip("the JAX package's extension did not build")
    for start, count in ((0, 50), (3, 11), (49, 1), (20, 0)):
        want = payloads[start:start + count]
        assert read_range(path, start, count) == want
        assert jax_read(path, start, count) == want
        assert _scan(path, start, count) == want


@needs_native
def test_full_and_empty_ranges(record_file):
    path, payloads = record_file
    assert read_range(path, 0, 50) == payloads
    assert read_range(path, 10, 0) == []


@needs_native
@pytest.mark.parametrize("start,count", [(40, 20), (-1, 2), (0, -1),
                                         (51, 0)])
def test_out_of_bounds_raises(record_file, start, count):
    path, _ = record_file
    with pytest.raises(ValueError, match="out of bounds"):
        read_range(path, start, count)


@needs_native
@pytest.mark.parametrize("damage", ["garbage", "truncated", "footer"])
def test_invalid_file_raises(tmp_path, record_file, damage):
    path, _ = record_file
    blob = open(path, "rb").read()
    bad = str(tmp_path / "bad.rec")
    if damage == "garbage":
        blob = b"not a record file, definitely" * 3
    elif damage == "truncated":
        blob = blob[:len(blob) // 2]
    else:   # a footer whose record count overflows the index
        blob = blob[:-12] + (2 ** 62).to_bytes(8, "little") + blob[-4:]
    with open(bad, "wb") as f:
        f.write(blob)
    with pytest.raises(ValueError, match="RecordFile"):
        read_range(bad, 0, 1)
    with pytest.raises(ValueError, match="RecordFile"):
        num_records(bad)


@needs_native
def test_reader_uses_native_path(record_file):
    path, payloads = record_file
    reader = RecordFileDataReader(path)
    task = Task(shard_name=path, start=5, end=15)
    before = reader_mod.native_range_reads
    assert list(reader.read_records(task)) == payloads[5:15]
    assert list(reader.read_records(
        Task(shard_name=path, start=0, end=3))) == payloads[:3]
    assert reader_mod.native_range_reads == before + 2   # one per task


def test_reader_python_fallback(record_file, monkeypatch):
    """With the extension cache forced empty the reader really goes
    through RecordFileScanner."""
    path, payloads = record_file
    monkeypatch.setattr(native, "_ext", None)
    monkeypatch.setattr(native, "_ext_load_attempted", True)
    assert not native_record_reader_available()
    reader = RecordFileDataReader(path)
    before = reader_mod.native_range_reads
    task = Task(shard_name=path, start=5, end=15)
    assert list(reader.read_records(task)) == payloads[5:15]
    assert reader_mod.native_range_reads == before


@needs_native
@pytest.mark.parametrize("start,end", [(40, 70), (50, 60), (60, 80),
                                       (0, 50)])
def test_reader_native_clamps_like_scanner(record_file, monkeypatch,
                                           start, end):
    """A task range past the file's end (a shard table built before the
    file was rewritten shorter) clamps on the native path as the
    scanner clamps it."""
    path, payloads = record_file
    task = Task(shard_name=path, start=start, end=end)
    got = list(RecordFileDataReader(path).read_records(task))
    monkeypatch.setattr(native, "_ext", None)
    monkeypatch.setattr(native, "_ext_load_attempted", True)
    want = list(RecordFileDataReader(path).read_records(task))
    assert got == want == payloads[start:end]


@needs_native
def test_large_records_take_the_scanner(tmp_path):
    """Above NATIVE_READ_MAX_MEAN_RECORD_BYTES (1024) the scanner is
    already memcpy-bound: the reader keeps it, as in the JAX package."""
    assert RecordFileDataReader.NATIVE_READ_MAX_MEAN_RECORD_BYTES == 1024
    rng = np.random.RandomState(1)
    small = [rng.bytes(900) for _ in range(8)]
    large = [rng.bytes(1100) for _ in range(8)]
    counted = []
    for name, payloads in (("small", small), ("large", large)):
        path = _write(str(tmp_path / f"{name}.rec"), payloads)
        before = reader_mod.native_range_reads
        got = list(RecordFileDataReader(path).read_records(
            Task(shard_name=path, start=0, end=8)))
        assert got == payloads
        counted.append(reader_mod.native_range_reads - before)
    assert counted == [1, 0]


def test_no_native_switch_turns_the_extension_off(tmp_path, record_file):
    path, payloads = record_file
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from elasticdl_tpu_torch.native.record_codec import "
        "native_record_reader_available\n"
        "from elasticdl_tpu_torch.data import reader as r\n"
        "from elasticdl_tpu_torch.common.task import Task\n"
        f"t = Task(shard_name={path!r}, start=2, end=6)\n"
        "got = list(r.RecordFileDataReader(t.shard_name).read_records(t))\n"
        "print(native_record_reader_available(), r.native_range_reads,"
        " len(got))\n")
    env = {**os.environ, "ELASTICDL_TPU_TORCH_NO_NATIVE": "1"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "0", "4"]


def test_extension_builds_keyed_on_the_interpreter(tmp_path, monkeypatch):
    """A fresh build lands in the build directory under a name keyed on
    the source, the flags and the ABI tag, records its seconds and
    loads as ``_record_ext``; another ABI tag names another file."""
    import sysconfig

    if not native_record_reader_available():
        pytest.skip("no compiler for the extension here")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_ext", None)
    monkeypatch.setattr(native, "_ext_load_attempted", False)
    monkeypatch.setattr(native, "ext_build_seconds", None)
    path = native.extension_path()
    assert os.path.dirname(path) == str(tmp_path / "build")
    module = native.get_record_ext()
    assert module.__name__ == "_record_ext" and os.path.exists(path)
    assert native.ext_build_seconds > 0
    real = sysconfig.get_config_var
    monkeypatch.setattr(sysconfig, "get_config_var", lambda name: (
        "cpython-399-other" if name == "SOABI" else real(name)))
    assert native.extension_path() != path
