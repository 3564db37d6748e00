"""Array-tree serialization: the same msgpack wire format as
elasticdl_tpu/common/tensor_utils.py (``{"__nd__": {dtype, shape,
data}}`` per ndarray), so clients of either server interoperate and
both packages read the same record files.

The codec is the port's own, in plain Python: the subset of
MessagePack that records, requests, replies and flax's param files use
(nil, bool, int of every width, float32/64, str, bin, array, map; ext
is read, as flax's param files hold it). It needs no ``msgpack``
package, and where one is installed it writes the same bytes as
``msgpack.packb(tree, default=..., use_bin_type=True)``: each value
takes the shortest form, Python floats go out as float64, tuples as
arrays.

``IndexedSlices`` (a table's rows by id, the checkpoint's embeddings
payload) encodes as ``{"__is__": {"values": ..., "ids": ...}}``, as
in the JAX codec; a bf16 array (``dtypes.BFLOAT16_BITS``, the bits of a
bfloat16 tensor) under the dtype name "bfloat16", as the JAX codec
writes a bfloat16 array.
"""

import struct
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np

from elasticdl_tpu_torch.common import dtypes


class ExtType(NamedTuple):
    """An ext value read without an ``ext_hook``: an application type
    ``code`` and its raw bytes."""

    code: int
    data: bytes


_BE = {name: struct.Struct(">" + fmt) for name, fmt in (
    ("B", "B"), ("H", "H"), ("I", "I"), ("Q", "Q"),
    ("b", "b"), ("h", "h"), ("i", "i"), ("q", "q"),
    ("f", "f"), ("d", "d"),
)}
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _pack_int(out: bytearray, n: int):
    if -0x20 <= n < 0x80:
        out += _BE["b" if n < 0 else "B"].pack(n)
    elif 0x80 <= n <= 0xff:
        out += b"\xcc" + _BE["B"].pack(n)
    elif -0x80 <= n < 0:
        out += b"\xd0" + _BE["b"].pack(n)
    elif 0xff < n <= 0xffff:
        out += b"\xcd" + _BE["H"].pack(n)
    elif -0x8000 <= n < -0x80:
        out += b"\xd1" + _BE["h"].pack(n)
    elif 0xffff < n <= 0xffffffff:
        out += b"\xce" + _BE["I"].pack(n)
    elif -0x80000000 <= n < -0x8000:
        out += b"\xd2" + _BE["i"].pack(n)
    elif 0xffffffff < n <= 0xffffffffffffffff:
        out += b"\xcf" + _BE["Q"].pack(n)
    elif -0x8000000000000000 <= n < -0x80000000:
        out += b"\xd3" + _BE["q"].pack(n)
    else:
        raise OverflowError(f"integer {n} out of msgpack range")


def _pack_len(out: bytearray, n: int, fix_base: Optional[int],
              fix_max: int, codes):
    """A length header: the fix form below ``fix_max``, else the 8-,
    16- or 32-bit form (``codes``; None where the type has no 8-bit
    form)."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n <= 0xff:
        out += bytes((codes[0], n))
    elif n <= 0xffff:
        out += bytes((codes[1],)) + _BE["H"].pack(n)
    elif n <= 0xffffffff:
        out += bytes((codes[2],)) + _BE["I"].pack(n)
    else:
        raise ValueError(f"msgpack object of {n} entries/bytes is too long")


def _pack(out: bytearray, obj, default, depth: int,
          default_used: bool = False):
    if depth > 512:
        raise ValueError("tree too deep to serialize")
    if obj is None:
        out.append(0xc0)
    elif obj is True:
        out.append(0xc3)
    elif obj is False:
        out.append(0xc2)
    elif isinstance(obj, int):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out += b"\xcb" + _BE["d"].pack(obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, (0xc4, 0xc5, 0xc6))
        out += obj
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += raw
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for key, value in obj.items():
            _pack(out, key, default, depth + 1)
            _pack(out, value, default, depth + 1)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for item in obj:
            _pack(out, item, default, depth + 1)
    elif default is not None and not default_used:
        _pack(out, default(obj), default, depth, default_used=True)
    else:
        raise TypeError(f"Cannot serialize {type(obj)}")


def packb(obj: Any, default: Optional[Callable] = None) -> bytes:
    """MessagePack bytes of ``obj``; ``default`` maps any other type to
    one the format has (called once per value, as msgpack does)."""
    out = bytearray()
    _pack(out, obj, default, 0)
    return bytes(out)


class _Reader:
    def __init__(self, data, object_hook, ext_hook):
        self.buf = memoryview(data)
        self.pos = 0
        self.object_hook = object_hook
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        chunk = self.buf[self.pos:end]
        self.pos = end
        return chunk

    def num(self, name: str):
        fmt = _BE[name]
        return fmt.unpack(self.take(fmt.size))[0]

    def array(self, n: int, depth: int) -> list:
        return [self.value(depth + 1) for _ in range(n)]

    def map(self, n: int, depth: int):
        out = {}
        for _ in range(n):
            key = self.value(depth + 1)
            out[key] = self.value(depth + 1)
        return self.object_hook(out) if self.object_hook else out

    def ext(self, n: int):
        code = self.num("b")
        data = self.take(n).tobytes()
        if self.ext_hook is not None:
            return self.ext_hook(code, data)
        return ExtType(code, data)

    def value(self, depth: int = 0):
        if depth > 512:
            raise ValueError("msgpack data nested too deep")
        b = self.num("B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, depth)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f, depth)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        handler = _DECODERS.get(b)
        if handler is None:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return handler(self, depth)


def _sized(kind: str, width: str):
    def read(r: _Reader, depth: int):
        n = r.num(width)
        if kind == "str":
            return str(r.take(n), "utf-8")
        if kind == "bin":
            return r.take(n).tobytes()
        if kind == "array":
            return r.array(n, depth)
        if kind == "map":
            return r.map(n, depth)
        return r.ext(n)
    return read


def _fixed(value):
    return lambda r, depth: value


def _scalar(name: str):
    return lambda r, depth: r.num(name)


def _fixext(n: int):
    return lambda r, depth: r.ext(n)


_DECODERS = {
    0xc0: _fixed(None), 0xc2: _fixed(False), 0xc3: _fixed(True),
    0xc4: _sized("bin", "B"), 0xc5: _sized("bin", "H"),
    0xc6: _sized("bin", "I"),
    0xc7: _sized("ext", "B"), 0xc8: _sized("ext", "H"),
    0xc9: _sized("ext", "I"),
    0xca: _scalar("f"), 0xcb: _scalar("d"),
    0xcc: _scalar("B"), 0xcd: _scalar("H"), 0xce: _scalar("I"),
    0xcf: _scalar("Q"),
    0xd0: _scalar("b"), 0xd1: _scalar("h"), 0xd2: _scalar("i"),
    0xd3: _scalar("q"),
    **{code: _fixext(n) for n, code in _FIXEXT.items()},
    0xd9: _sized("str", "B"), 0xda: _sized("str", "H"),
    0xdb: _sized("str", "I"),
    0xdc: _sized("array", "H"), 0xdd: _sized("array", "I"),
    0xde: _sized("map", "H"), 0xdf: _sized("map", "I"),
}


def unpackb(data, object_hook: Optional[Callable] = None,
            ext_hook: Optional[Callable] = None) -> Any:
    """The value that ``data`` holds: str as ``str``, bin as ``bytes``,
    arrays as lists, maps as dicts passed through ``object_hook``, ext
    values through ``ext_hook(code, data)`` (else ``ExtType``). Raises
    ValueError on truncated data or bytes after the value."""
    reader = _Reader(data, object_hook, ext_hook)
    value = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(
            f"{len(reader.buf) - reader.pos} bytes after the msgpack value"
        )
    return value


@dataclass
class IndexedSlices:
    """A sparse update: ``values[i]`` applies to row ``ids[i]`` of a table
    (host-side container, as in the JAX package)."""

    values: np.ndarray  # (n, dim)
    ids: np.ndarray  # (n,)


def serialize_ndarray(arr: np.ndarray) -> dict:
    # np.ascontiguousarray would promote 0-d arrays to 1-d; asarray with
    # order="C" keeps scalar shape () intact.
    arr = np.asarray(arr, order="C")
    return {
        "dtype": dtypes.dtype_name(arr.dtype),
        "shape": list(arr.shape),
        "data": arr.tobytes(),
    }


def deserialize_ndarray(obj: dict) -> np.ndarray:
    """A "bfloat16" array decodes to its bits (``dtypes.BFLOAT16_BITS``;
    ``dtypes.bf16_from_numpy`` makes the tensor)."""
    dtype = (dtypes.BFLOAT16_BITS if obj["dtype"] == "bfloat16"
             else dtypes.np_dtype(obj["dtype"]))
    arr = np.frombuffer(obj["data"], dtype=dtype)
    return arr.reshape(obj["shape"]).copy()


def _encode(obj):
    if isinstance(obj, np.ndarray):
        return {"__nd__": serialize_ndarray(obj)}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, IndexedSlices):
        return {
            "__is__": {
                "values": serialize_ndarray(obj.values),
                "ids": serialize_ndarray(obj.ids),
            }
        }
    raise TypeError(f"Cannot serialize {type(obj)}")


def _decode(obj):
    if "__nd__" in obj:
        return deserialize_ndarray(obj["__nd__"])
    if "__is__" in obj:
        return IndexedSlices(
            values=deserialize_ndarray(obj["__is__"]["values"]),
            ids=deserialize_ndarray(obj["__is__"]["ids"]),
        )
    return obj


def dumps(tree: Any) -> bytes:
    """Serialize a tree of ndarrays/scalars/strings to bytes."""
    return packb(tree, default=_encode)


def loads(data: bytes) -> Any:
    return unpackb(data, object_hook=_decode)
