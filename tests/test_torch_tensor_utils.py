"""The port's msgpack codec (elasticdl_tpu_torch/common/tensor_utils.py)
against the ``msgpack`` package and the JAX package's writers: byte
equality on the trees records, requests and replies carry, and reading
JAX-written records and flax param files with no ``msgpack`` at all."""

import sys

import jax
import msgpack
import numpy as np
import pytest
from flax import serialization

from elasticdl_tpu.common import tensor_utils as jtu
from elasticdl_tpu.testing import data as jdata
from elasticdl_tpu_torch.common import tensor_utils as tu
from elasticdl_tpu_torch.data.record_file import RecordFileScanner
from elasticdl_tpu_torch.serving import export

_RNG = np.random.default_rng(0)
TREES = {
    "lm_record": {"tokens": np.arange(33, dtype=np.int64) % 256},
    "mnist_record": {"image": _RNG.random((28, 28)).astype(np.float32),
                     "label": 7},
    "census_record": {"age": 39.0, "education": "Bachelors", "label": 1},
    "request": {"features": _RNG.integers(0, 97, (2, 64)).astype(np.int32)},
    "request_dict": {"features": {
        "ids": _RNG.integers(0, 2 ** 40, (3, 5)).astype(np.int64),
        "dense": _RNG.random((3, 4)).astype(np.float32)}},
    "reply": {"predictions": _RNG.random((1, 3, 97)).astype(np.float32),
              "model_version": 3},
    "error": {"error": "queue full: " + "x" * 40},
    "widths": {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                        2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
                        -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
               "floats": (0.5, np.float64(-2.25), np.float32(0.1)),
               "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                        "é" * 40000],
               "bins": [b"", b"\0" * 255, b"\1" * 256, bytes(70000)],
               "flags": [True, False, None],
               "long": list(range(17)), "wide": {str(i): i for i in
                                                 range(17)},
               "huge": list(range(70000)), "scalar": np.int64(-5),
               "nd0": np.asarray(1.5), "bools": np.array([True, False])},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_dumps_is_byte_equal_to_msgpack(name):
    tree = TREES[name]
    want = msgpack.packb(tree, default=jtu._encode, use_bin_type=True)
    assert tu.dumps(tree) == want


@pytest.mark.parametrize("name", sorted(TREES))
def test_loads_reads_what_the_jax_package_writes(name):
    raw = jtu.dumps(TREES[name])
    got, want = tu.loads(raw), jtu.loads(raw)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    assert type(got) is type(want)


@pytest.mark.parametrize("code,size", [(1, 1), (2, 2), (3, 4), (4, 8),
                                       (5, 16), (6, 3), (7, 300),
                                       (8, 70000)])
def test_ext_values_decode_like_msgpack(code, size):
    data = bytes(range(256)) * (size // 256) + bytes(size % 256)
    raw = msgpack.packb({"x": msgpack.ExtType(code, data)})
    assert tu.unpackb(raw) == {"x": tu.ExtType(code, data)}
    assert tu.unpackb(raw, ext_hook=lambda c, d: (c, len(d))) == {
        "x": (code, size)}


def test_float32_values_decode():
    assert tu.unpackb(msgpack.packb(0.5, use_single_float=True)) == 0.5


@pytest.mark.parametrize("raw,match", [
    (b"\xcd\x01", "truncated"),
    (b"\x01\x02", "bytes after"),
    (b"\xc1", "unsupported"),
])
def test_malformed_input_raises_value_error(raw, match):
    with pytest.raises(ValueError, match=match):
        tu.unpackb(raw)


def test_unknown_types_raise_type_error():
    with pytest.raises(TypeError, match="Cannot serialize"):
        tu.dumps({"x": object()})


def _flax_file(path):
    params = {"dense": {"kernel": np.arange(6, dtype=np.float32)
                        .reshape(2, 3),
                        "bias": np.zeros(3, np.float32)},
              "embed": np.ones((4, 2), np.float16),
              "count": np.int32(7)}
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(params))
    return params


def test_reads_jax_records_and_flax_params_without_msgpack(tmp_path,
                                                            monkeypatch):
    records = jdata.create_lm_record_file(str(tmp_path / "lm.rec"), 3,
                                          seed=4, seq_len=16)
    params = _flax_file(str(tmp_path / "params.msgpack"))
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack as _  # noqa: F401
    with RecordFileScanner(records) as scanner:
        rows = [tu.loads(r)["tokens"] for r in scanner]
    assert len(rows) == 3 and all(r.dtype == np.int64 for r in rows)
    np.testing.assert_array_equal(np.diff(rows[0]) % 256, 1)
    got = export.load_flax_params(str(tmp_path / "params.msgpack"))
    jax.tree.map(np.testing.assert_array_equal, got, params)
    assert tu.loads(tu.dumps({"a": np.ones(2)}))["a"].tolist() == [1, 1]
