"""The port's ``msgpack_lite`` against the ``msgpack`` package for what the
``grpc_sim`` transport sends: ``bin`` 8/16/32 around its length limits,
float 64 (an error's ``retry_after``), and the maps that carry them.
``packb`` gives the package's bytes (``use_bin_type=True``) and each side
reads the other's; checkpoint manifests keep their encodings
(``tests/test_torch_data_checkpoint.py``)."""
import math

import msgpack
import pytest

from repro_torch.checkpoint import msgpack_lite

BIN_SIZES = [0, 1, 255, 256, 65_535, 65_536, 70_000]
FLOATS = [0.0, -0.0, 1.5, -2.25, 0.1, 1e-300, 1e300, 3.4e38, float("inf"),
          float("-inf")]


@pytest.mark.parametrize("n", BIN_SIZES)
def test_bin_matches_msgpack(n):
    data = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    want = msgpack.packb(data, use_bin_type=True)
    assert msgpack_lite.packb(data) == want
    assert msgpack_lite.packb(bytearray(data)) == want
    assert msgpack_lite.packb(memoryview(data)) == want
    assert msgpack_lite.unpackb(want) == data
    assert msgpack.unpackb(msgpack_lite.packb(data), raw=False) == data


@pytest.mark.parametrize("x", FLOATS)
def test_float64_matches_msgpack(x):
    want = msgpack.packb(x, use_bin_type=True)
    assert msgpack_lite.packb(x) == want
    got = msgpack_lite.unpackb(want)
    assert got == x and math.copysign(1, got) == math.copysign(1, x)
    assert msgpack.unpackb(msgpack_lite.packb(x)) == x


def test_nan_and_float32_read():
    assert math.isnan(msgpack_lite.unpackb(msgpack.packb(float("nan"))))
    assert msgpack_lite.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5


@pytest.mark.parametrize("obj", [
    {"op": "count", "data": b"hello world"},
    {"status": 0, "data": b"\x00" * 300},
    {"status": 1, "error": msgpack.packb({"type": "RateLimited", "msg": "slow",
                                         "retry_after": 0.25}, use_bin_type=True)},
    {"type": "Overloaded", "msg": "busy", "retry_after": 1.5},
    {"op": "stop"},
    [b"", 2.5, None, {"k": [b"x" * 256, -1.0]}],
])
def test_grpc_bodies_match_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_lite.packb(obj) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want, raw=False)
    assert msgpack.unpackb(msgpack_lite.packb(obj), raw=False) == \
        msgpack.unpackb(want, raw=False)
