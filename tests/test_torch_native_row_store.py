"""The port's host row store (``elasticdl_tpu_torch/native/``,
``embedding/table.py``, the host optimizer wrappers) against the JAX
package's.

Both build the same C++ source (``row_store.cc``) and seed Python rows
from the same (name, id) hash, so lazy rows are bit-equal; the row rules
run the same numpy expressions (the port's numpy branch of
``apply_rows``) or the same C++ kernels, so tables, slot tables and step
counters after the same gradients are bit-equal too. The native wrapper
against the Python one (another float order in C++) is held as the JAX
package's own test holds it: rtol 2e-5, atol 2e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from elasticdl_tpu.embedding import optimizer as jopt
from elasticdl_tpu.embedding.table import EmbeddingTable as JaxTable
from elasticdl_tpu.native import native_available as jax_native_available
from elasticdl_tpu_torch import native
from elasticdl_tpu_torch.embedding import optimizer as topt
from elasticdl_tpu_torch.embedding.table import EmbeddingTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(
    not (native.native_available() and jax_native_available()),
    reason="g++ could not build a native row store",
)

IDS = [5, -3, 0, 123456789, -(2**40), 7]
OPTS = [
    {"opt_type": "SGD", "lr": 0.1},
    {"opt_type": "Momentum", "lr": 0.1, "momentum": 0.9},
    {"opt_type": "Momentum", "lr": 0.1, "momentum": 0.9, "nesterov": True},
    {"opt_type": "Adagrad", "lr": 0.1},
    {"opt_type": "Adam", "lr": 0.01},
    {"opt_type": "Adam", "lr": 0.01, "amsgrad": True},
]
OPT_IDS = ["sgd", "momentum", "nesterov", "adagrad", "adam", "amsgrad"]


def _native_tables():
    from elasticdl_tpu.native.row_store import NativeEmbeddingTable as JN
    from elasticdl_tpu_torch.native.row_store import NativeEmbeddingTable

    return JN, NativeEmbeddingTable


def test_library_builds_into_the_ports_own_directory():
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.exists(path)
    with open(native.SOURCE, "rb") as f, open(os.path.join(
            os.path.dirname(jopt.__file__), "..", "native", "row_store.cc"),
            "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("dim", [1, 8, 33])
def test_native_lazy_rows_bit_equal(dim):
    JN, TN = _native_tables()
    want = JN("items", dim).get(IDS)
    got = TN("items", dim).get(IDS)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TN("other", dim).get(IDS),
                                  JN("other", dim).get(IDS))
    slot = TN("s", dim, is_slot=True, slot_init_value=0.1).get(IDS)
    np.testing.assert_array_equal(
        slot, JN("s", dim, is_slot=True, slot_init_value=0.1).get(IDS))


@pytest.mark.parametrize("initializer", ["uniform", "normal", "zeros"])
def test_python_lazy_rows_bit_equal(initializer):
    got = EmbeddingTable("items", 8, initializer=initializer).get(IDS)
    want = JaxTable("items", 8, initializer=initializer).get(IDS)
    np.testing.assert_array_equal(got, want)


def test_native_table_surface():
    _, TN = _native_tables()
    t = TN("r", 4)
    vals = np.arange(12, dtype=np.float32).reshape(3, 4)
    t.set([30, -10, 20], vals)
    np.testing.assert_array_equal(t.get([30, -10, 20]), vals)
    ids, rows = t.to_arrays()
    np.testing.assert_array_equal(ids, [-10, 20, 30])
    np.testing.assert_array_equal(rows[0], vals[1])
    assert t.num_rows == 3
    t.enable_dirty_tracking()
    t.get([40, 30])
    assert t.num_rows == 4 and t.dirty_count == 2
    dirty_ids, dirty_rows = t.dirty_arrays()
    np.testing.assert_array_equal(dirty_ids, [30, 40])
    np.testing.assert_array_equal(dirty_rows[0], vals[0])
    assert t.dirty_count == 0
    again = TN.from_arrays("r2", ids, rows)
    np.testing.assert_array_equal(again.get(ids), rows)


def _jax_wrappers(opt_kwargs):
    from elasticdl_tpu.native.row_store import NativeOptimizerWrapper

    return (jopt.HostOptimizerWrapper(jopt.make_row_optimizer(**opt_kwargs)),
            NativeOptimizerWrapper(jopt.make_row_optimizer(**opt_kwargs)))


def _port_wrappers(opt_kwargs):
    from elasticdl_tpu_torch.native.row_store import NativeOptimizerWrapper

    return (topt.HostOptimizerWrapper(topt.make_row_optimizer(**opt_kwargs)),
            NativeOptimizerWrapper(topt.make_row_optimizer(**opt_kwargs)))


def _run(wrapper, table_cls, dim, steps, seed=0):
    """Two tables, 4 applies each on partly repeating ids; returns the
    wrapper's state tables as {name: (ids, rows)}."""
    rng = np.random.RandomState(seed)
    tables = {name: table_cls(name, dim) for name in ("t", "u")}
    for step in range(steps):
        for name, table in tables.items():
            ids = np.unique(rng.randint(-50, 50, size=6)).astype(np.int64)
            grads = rng.randn(ids.size, dim).astype(np.float32)
            wrapper.apply_gradients(table, ids, grads)
    state = dict(tables)
    state.update(wrapper.state_tables(tables))
    return {name: t.to_arrays() for name, t in state.items()}


@pytest.mark.parametrize("opt_kwargs", OPTS, ids=OPT_IDS)
def test_wrappers_bit_equal_to_jax(opt_kwargs):
    """Each port wrapper against its JAX counterpart on the same
    gradients: main tables, slot tables and step counters bit-equal."""
    JN, TN = _native_tables()
    j_py, j_nat = _jax_wrappers(dict(opt_kwargs))
    t_py, t_nat = _port_wrappers(dict(opt_kwargs))
    for jw, tw, jcls, tcls in ((j_py, t_py, JaxTable, EmbeddingTable),
                               (j_nat, t_nat, JN, TN)):
        want = _run(jw, jcls, 5, steps=4)
        got = _run(tw, tcls, 5, steps=4)
        assert sorted(got) == sorted(want)
        assert topt.STEPS_TABLE_NAME in got
        for name in want:
            np.testing.assert_array_equal(got[name][0], want[name][0])
            np.testing.assert_array_equal(got[name][1], want[name][1],
                                          err_msg=name)


@pytest.mark.parametrize("opt_kwargs", OPTS, ids=OPT_IDS)
def test_native_optimizer_matches_python(opt_kwargs):
    """As tests/test_native_row_store.py: the fused C++ updates against
    the numpy rules, 4 steps on set rows."""
    _, TN = _native_tables()
    py_wrap, nat_wrap = _port_wrappers(dict(opt_kwargs))
    dim = 6
    rng = np.random.RandomState(0)
    ids = [2, 9, 4]
    init_rows = rng.randn(3, dim).astype(np.float32)
    py_table, nat_table = EmbeddingTable("t", dim), TN("t", dim)
    py_table.set(ids, init_rows)
    nat_table.set(ids, init_rows)
    for _ in range(4):
        grads = rng.randn(3, dim).astype(np.float32)
        py_wrap.apply_gradients(py_table, ids, grads)
        nat_wrap.apply_gradients(nat_table, ids, grads)
    np.testing.assert_allclose(nat_table.get(ids), py_table.get(ids),
                               rtol=2e-5, atol=2e-6)


def test_numpy_rules_stay_numpy_and_match_torch():
    """``apply_rows`` on numpy rows returns numpy; on f32 tensors the
    device path's rules give the same values (rtol 1e-6: another
    evaluation of the bias correction)."""
    import torch

    rng = np.random.RandomState(3)
    rows, grads = (rng.randn(4, 8).astype(np.float32) for _ in range(2))
    for kwargs in OPTS:
        opt = topt.make_row_optimizer(**dict(kwargs))
        slots = {n: np.full_like(rows, topt.slot_init_value(opt, n))
                 for n in opt.slot_names}
        new_rows, new_slots = opt.apply_rows(rows, grads, slots, 3)
        assert isinstance(new_rows, np.ndarray)
        assert all(isinstance(v, np.ndarray) for v in new_slots.values())
        t_rows, _ = opt.apply_rows(
            torch.from_numpy(rows), torch.from_numpy(grads),
            {n: torch.from_numpy(v) for n, v in slots.items()}, 3)
        np.testing.assert_allclose(t_rows.numpy(), new_rows, rtol=1e-6,
                                   atol=1e-7)


def test_make_host_helpers_pick_native():
    from elasticdl_tpu_torch.native import row_store as rs

    assert isinstance(rs.make_host_table("y", 4), rs.NativeEmbeddingTable)
    assert isinstance(rs.make_host_optimizer(topt.make_row_optimizer("Adam")),
                      rs.NativeOptimizerWrapper)
    assert isinstance(rs.make_host_table("z", 4, dtype=np.float64),
                      EmbeddingTable)


def test_fallback_when_the_native_store_is_switched_off():
    """With the port's switch set, a fresh process builds nothing and
    the helpers hand out the Python table and wrapper."""
    code = (
        "from elasticdl_tpu_torch import native\n"
        "from elasticdl_tpu_torch.native import row_store as rs\n"
        "from elasticdl_tpu_torch.embedding import optimizer as o\n"
        "t = rs.make_host_table('x', 4)\n"
        "w = rs.make_host_optimizer(o.SGD())\n"
        "print(native.native_available(), native.build_seconds,\n"
        "      type(t).__name__, type(w).__name__)\n"
    )
    env = dict(os.environ, **{native.NO_NATIVE_ENV: "1"})
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "None", "EmbeddingTable",
                                  "HostOptimizerWrapper"]


def test_fallback_helpers(monkeypatch):
    from elasticdl_tpu_torch.native import row_store as rs

    monkeypatch.setattr(rs, "native_available", lambda: False)
    assert isinstance(rs.make_host_table("x", 4), EmbeddingTable)
    assert isinstance(rs.make_host_optimizer(topt.make_row_optimizer("SGD")),
                      topt.HostOptimizerWrapper)
