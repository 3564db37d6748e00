"""The port's msgpack-over-gRPC layer (``elasticdl_tpu_torch/comm/rpc.py``)
against the JAX package's: round trips and ndarray payloads (a bf16 one
among them), the status codes, the retry rules, the request bytes
(``_serialize``, byte for byte), both packages' stubs against both
packages' servers, and the error types importing without ``grpc``.
"""

import os
import subprocess
import sys

import numpy as np
import ml_dtypes
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from elasticdl_tpu.comm import rpc as jax_rpc
from elasticdl_tpu_torch.comm import overload
from elasticdl_tpu_torch.comm import rpc
from elasticdl_tpu_torch.common import dtypes
from elasticdl_tpu_torch.observability import default_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _echo(request):
    return {"echo": request.get("value")}


def _boom(request):
    raise ValueError("handler exploded")


def _shape(request):
    arr = request["arr"]
    return {"shape": list(arr.shape), "dtype": str(arr.dtype), "arr": arr}


HANDLERS = {"Echo": {"echo": _echo, "boom": _boom, "shape": _shape}}


@pytest.fixture(params=["port", "jax"])
def server(request):
    """An Echo server of either package."""
    module = rpc if request.param == "port" else jax_rpc
    srv = module.RpcServer("localhost:0", HANDLERS).start()
    yield request.param, srv
    srv.stop(0)


def _retries_value(service: str, method: str, code: str) -> float:
    return default_registry().counter(
        "rpc_retries_total",
        "Transient RPC failures retried by RpcStub.call",
        ["service", "method", "code"],
    ).labels(service, method, code).value


@pytest.mark.parametrize("stub_side", ["port", "jax"])
def test_round_trips_between_packages(server, stub_side):
    """Each package's stub against each package's server: the same
    replies, ndarrays (f32, int64, a 0-d one) intact."""
    _, srv = server
    module = rpc if stub_side == "port" else jax_rpc
    stub = module.RpcStub(f"localhost:{srv.port}", "Echo")
    try:
        assert stub.call("echo", value=7) == {"echo": 7}
        assert stub.call("echo", value={"a": [1, 2.5, "x", None, True]}) \
            == {"echo": {"a": [1, 2.5, "x", None, True]}}
        for arr in (np.arange(12, dtype=np.float32).reshape(3, 4),
                    np.arange(5, dtype=np.int64), np.array(3.5, np.float32)):
            got = stub.call("shape", arr=arr)
            assert got["shape"] == list(arr.shape)
            np.testing.assert_array_equal(got["arr"], arr)
            assert got["arr"].dtype == arr.dtype
    finally:
        stub.close()


def test_bf16_payload_crosses_both_ways(server):
    """A bf16 array travels as the codec's "bfloat16": the port sends its
    bits (``dtypes.BFLOAT16_BITS``), a JAX handler sees an ml_dtypes
    bfloat16 array of the same values, and the port reads one back as
    the same bits."""
    side, srv = server
    values = np.array([[1.5, -2.0, 3.25], [0.0, 1e-3, -7.0]], np.float32)
    bits = values.astype(ml_dtypes.bfloat16).view(np.uint16).view(
        dtypes.BFLOAT16_BITS)
    stub = rpc.RpcStub(f"localhost:{srv.port}", "Echo")
    try:
        got = stub.call("shape", arr=bits)
    finally:
        stub.close()
    assert got["dtype"] == ("bfloat16" if side == "jax"
                            else str(dtypes.BFLOAT16_BITS))
    assert got["arr"].dtype == dtypes.BFLOAT16_BITS
    np.testing.assert_array_equal(got["arr"].view(np.uint16),
                                  bits.view(np.uint16))
    # And a JAX stub's ml_dtypes array reaches a port server as bits.
    jstub = jax_rpc.RpcStub(f"localhost:{srv.port}", "Echo")
    try:
        back = jstub.call("shape", arr=values.astype(ml_dtypes.bfloat16))
    finally:
        jstub.close()
    np.testing.assert_array_equal(back["arr"].astype(np.float32),
                                  values.astype(ml_dtypes.bfloat16)
                                  .astype(np.float32))


@pytest.mark.parametrize("stub_side", ["port", "jax"])
def test_status_codes_match(server, stub_side):
    """INTERNAL for a raising handler, UNIMPLEMENTED for an unknown
    method or service, whichever package serves or calls."""
    _, srv = server
    module = rpc if stub_side == "port" else jax_rpc
    addr = f"localhost:{srv.port}"
    stub = module.RpcStub(addr, "Echo", max_retries=0)
    other = module.RpcStub(addr, "NoSuchService", max_retries=0)
    try:
        with pytest.raises(module.RpcError) as info:
            stub.call("boom")
        assert info.value.code == "INTERNAL"
        assert "handler exploded" in str(info.value)
        with pytest.raises(module.RpcError) as info:
            stub.call("no_such_method")
        assert info.value.code == "UNIMPLEMENTED"
        with pytest.raises(module.RpcError) as info:
            other.call("echo")
        assert info.value.code == "UNIMPLEMENTED"
    finally:
        stub.close()
        other.close()


def _flaky_hook(failures: int, code: str = "UNAVAILABLE"):
    state = {"left": failures}

    def hook(service, method, request):
        if state["left"] > 0:
            state["left"] -= 1
            raise rpc.RpcError(f"injected {code}", code=code)

    return hook


@pytest.fixture
def port_server():
    overload.reset_retry_budgets()
    overload.reset_breakers()
    srv = rpc.RpcServer("localhost:0", HANDLERS).start()
    yield srv
    srv.stop(0)
    rpc.set_chaos_hooks(None, None)


@pytest.mark.parametrize("failures,max_retries,code,want_code,retried", [
    (2, 3, "UNAVAILABLE", None, 2),              # a blip, then success
    (99, 2, "UNAVAILABLE", "UNAVAILABLE", 2),     # the retry cap
    (99, 3, "INTERNAL", "INTERNAL", 0),           # a permanent code
], ids=["blip", "cap", "permanent"])
def test_retry_rules(port_server, failures, max_retries, code, want_code,
                     retried):
    stub = rpc.RpcStub(f"localhost:{port_server.port}", "Echo",
                       max_retries=max_retries, backoff_base=0.01)
    before = _retries_value("Echo", "echo", code)
    rpc.set_chaos_hooks(client=_flaky_hook(failures, code))
    try:
        if want_code is None:
            assert stub.call("echo", value=1) == {"echo": 1}
        else:
            with pytest.raises(rpc.RpcError) as info:
                stub.call("echo", value=1)
            assert info.value.code == want_code
    finally:
        rpc.set_chaos_hooks(None, None)
        stub.close()
    assert _retries_value("Echo", "echo", code) == before + retried


_leaf = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1),
    st.floats(allow_nan=False), st.text(max_size=40),
    st.binary(max_size=40),
)
_arrays = hnp.arrays(
    st.sampled_from([np.float32, np.float64, np.int32, np.int64, np.uint8,
                     np.bool_]),
    hnp.array_shapes(min_dims=0, max_dims=3, max_side=4),
)
_trees = st.recursive(
    st.one_of(_leaf, _arrays),
    lambda children: st.one_of(
        st.lists(children, max_size=4),
        st.dictionaries(st.text(max_size=10), children, max_size=4),
    ),
    max_leaves=20,
)


@settings(max_examples=150, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.dictionaries(st.text(max_size=12), _trees, max_size=6))
def test_serialize_is_byte_equal_to_jax(request):
    """What the port's stub puts on the wire is what the JAX stub puts
    there, byte for byte, and each side reads the other's."""
    got = rpc._serialize(request)
    assert got == jax_rpc._serialize(request)
    back = rpc._deserialize(got)
    assert jax_rpc._serialize(back) == got


def test_error_types_import_without_grpc():
    """RpcError, InvalidRequest, RETRYABLE_CODES and decorrelated_jitter
    import on a host without grpcio (the in-process master's path)."""
    code = (
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'grpc' or name.startswith('grpc.'):\n"
        "            raise ImportError('grpc hidden')\n"
        "sys.meta_path.insert(0, _Block())\n"
        "sys.modules.pop('grpc', None)\n"
        "from elasticdl_tpu_torch.comm.rpc import (RETRYABLE_CODES, "
        "InvalidRequest, RpcError, decorrelated_jitter)\n"
        "from elasticdl_tpu_torch.testing.in_process_master import "
        "InProcessMaster\n"
        "assert RpcError('x', code='UNAVAILABLE').code in RETRYABLE_CODES\n"
        "assert issubclass(InvalidRequest, ValueError)\n"
        "assert decorrelated_jitter(0.0) == 0.05\n"
        "assert 'grpc' not in sys.modules\n"
        "try:\n"
        "    from elasticdl_tpu_torch.comm.rpc import build_channel\n"
        "    build_channel('localhost:1')\n"
        "except ImportError:\n"
        "    print('wire needs grpc')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "wire needs grpc"
