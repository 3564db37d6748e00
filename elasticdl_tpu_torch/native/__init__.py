"""Native (C++) host row store: build and ctypes binding (port of the
row-store half of elasticdl_tpu/native/__init__.py).

``row_store.cc`` is the port's own copy of the JAX package's source.
At first use it is compiled with ``g++ -O3 -shared -fPIC -std=c++17``
into ``native/_build/`` (git-ignored), under a name keyed on the hash
of the source and the flags, through a temp file and an atomic rename
(concurrent builders race benignly), and bound with ctypes.

``native_available()`` gates every caller. ``ELASTICDL_TPU_TORCH_NO_NATIVE=1``
switches the native store off, and a failed build falls back to the
pure-Python tables with a warning, as in the JAX package;
``build_seconds`` says whether (and how long) this process compiled.
The record-decode extension is not ported.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from typing import Optional

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("native")

NO_NATIVE_ENV = "ELASTICDL_TPU_TORCH_NO_NATIVE"
_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "row_store.cc")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_load_attempted = False
# Seconds this process spent compiling the library (None: no build ran,
# the cached library was loaded or the store is off).
build_seconds: Optional[float] = None


def library_path() -> str:
    """Where the library lands: keyed on the source and the flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"_librowstore_{digest.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.monotonic()
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        build_seconds = time.monotonic() - t0
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as exc:
        detail = getattr(exc, "stderr", b"")
        logger.warning(
            "native build failed (%s) %s — using pure-Python row store",
            exc, detail.decode() if detail else "",
        )
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _bind(lib):
    c = ctypes
    i64, u32, f32 = c.c_int64, c.c_uint32, c.c_float
    p, i64p, f32p = c.c_void_p, c.POINTER(c.c_int64), c.POINTER(c.c_float)
    lib.rs_create.restype = p
    lib.rs_create.argtypes = [i64, u32, c.c_int, f32, f32]
    lib.rs_destroy.argtypes = [p]
    lib.rs_num_rows.restype = i64
    lib.rs_num_rows.argtypes = [p]
    lib.rs_dim.restype = i64
    lib.rs_dim.argtypes = [p]
    lib.rs_created_count.restype = i64
    lib.rs_created_count.argtypes = [p]
    lib.rs_erase.restype = i64
    lib.rs_erase.argtypes = [p, i64p, i64]
    lib.rs_contains.argtypes = [p, i64p, i64, c.POINTER(c.c_uint8)]
    lib.rs_get.argtypes = [p, i64p, i64, f32p]
    lib.rs_set.argtypes = [p, i64p, i64, f32p]
    lib.rs_export.argtypes = [p, i64p, f32p]
    lib.rs_sgd.argtypes = [p, i64p, i64, f32p, f32]
    lib.rs_momentum.argtypes = [p, p, i64p, i64, f32p, f32, f32, c.c_int]
    lib.rs_adagrad.argtypes = [p, p, i64p, i64, f32p, f32, f32]
    lib.rs_adam.argtypes = [p, p, p, p, i64p, i64, f32p, f32, f32, f32,
                            f32, i64]
    return lib


def get_lib():
    """The loaded library, or None when unavailable."""
    global _lib, _load_attempted
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get(NO_NATIVE_ENV):
            return None
        out = library_path()
        if not os.path.exists(out) and not _build(out):
            return None
        try:
            _lib = _bind(ctypes.CDLL(out))
        except OSError as exc:
            logger.warning("could not load %s: %s", out, exc)
            _lib = None
        return _lib


def native_available() -> bool:
    return get_lib() is not None
