"""``paddle.device`` of the port (``paddle_tpu_torch/device``) on the CPU,
beside the JAX package's (``paddle_tpu/device``): the same names, the
answers a build without CUDA gives in both, and ``synchronize()`` as a
lazy-dispatch materialisation point that joins background builds.
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import lazy


@pytest.fixture(autouse=True)
def _cpu():
    previous = paddle.get_device()
    paddle.set_device("cpu")
    lazy.reset_lazy_state()
    yield
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": False})
    lazy.reset_lazy_state()
    paddle.set_device(previous)


def test_every_name_of_the_jax_module_is_here():
    names = [n for n in jpaddle.device.__all__]
    assert names and all(hasattr(paddle.device, n) for n in names), names
    for n in ("Stream", "Event", "current_stream", "stream_guard", "get_device_name",
              "get_device_capability", "get_device_properties", "max_memory_reserved"):
        assert hasattr(paddle.device, n) and hasattr(jpaddle.device, n), n
    for n in ("Stream", "Event", "current_stream", "stream_guard", "device_count",
              "memory_allocated", "max_memory_allocated", "memory_reserved",
              "max_memory_reserved", "empty_cache", "synchronize", "get_device_name",
              "get_device_capability", "get_device_properties"):
        assert hasattr(paddle.device.cuda, n) and hasattr(jpaddle.device.cuda, n), n


def test_without_cuda_the_answers_are_the_jax_packages():
    assert paddle.device.get_device() == "cpu"
    assert paddle.device.is_compiled_with_cuda() is False
    for n in ("rocm", "xpu", "npu", "mlu", "ipu", "cinn"):
        got = getattr(paddle.device, f"is_compiled_with_{n}")()
        assert got is getattr(jpaddle.device, f"is_compiled_with_{n}")() is False, n
    assert paddle.device.get_device_capability() == jpaddle.device.get_device_capability() \
        == (0, 0)
    assert paddle.device.get_cudnn_version() is None
    assert paddle.device.get_all_device_type() == ["cpu"]
    assert paddle.device.get_available_device() == ["cpu"]
    assert paddle.device.cuda.device_count() == 0
    for f in ("memory_allocated", "max_memory_allocated", "memory_reserved",
              "max_memory_reserved"):
        assert getattr(paddle.device, f)() == 0 == getattr(paddle.device.cuda, f)(), f
    paddle.device.cuda.empty_cache()
    props = paddle.device.get_device_properties()
    assert props.total_memory == 0 and props.multi_processor_count == 1


def test_streams_and_events_are_done_identity_objects_without_cuda():
    s = paddle.device.Stream()
    e = s.record_event()
    assert e.query() and s.query()
    s.wait_event(e)
    s.wait_stream(paddle.device.current_stream())
    s.synchronize()
    e.synchronize()
    with paddle.device.stream_guard(s) as got:
        assert got is s
    assert isinstance(paddle.device.cuda.current_stream(), paddle.device.Stream)
    assert paddle.device.cuda.Event(enable_timing=True).elapsed_time(e) == 0.0


def test_synchronize_flushes_pending_segments_and_joins_builds():
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_eager_async_compile": True})
    try:
        x = paddle.to_tensor(np.ones(4, np.float32)) * 5.0
        assert lazy.pending_op_count() == 1
        paddle.device.synchronize()
        assert lazy.pending_op_count() == 0
        assert not isinstance(x._v, lazy.LazyRef)
        np.testing.assert_allclose(x.numpy(), np.full(4, 5.0))
        y = (x + 1.0).sum()  # the same signature's build: submitted at its first flush
        float(y)
        paddle.device.cuda.synchronize()
        assert lazy.step_capture_state()["pending_compiles"] == 0
    finally:
        paddle.set_flags({"FLAGS_eager_async_compile": True})


def test_set_device_round_trips_through_the_device_module():
    assert paddle.device.set_device("cpu") == paddle.CPUPlace()
    assert paddle.device.get_device() == "cpu"
    with pytest.raises(ValueError, match="unknown device"):
        paddle.device.set_device("tpu")
