"""``paddle.device`` for the port: device selection, synchronisation,
memory statistics, streams and events (``paddle_tpu/device/__init__.py``).

``synchronize()`` is a lazy-dispatch materialisation point, as in the JAX
package: the pending segment is flushed as one program (a deferred whole
step resolves first), every background build is joined, and then the
card's queue is waited for. The memory figures are the caching
allocator's (``torch.cuda.memory_allocated`` and friends) on the card and
0 on the CPU. ``Stream`` and ``Event`` wrap ``torch.cuda.Stream`` and
``torch.cuda.Event`` when CUDA is available; without it they are the JAX
package's identity objects (recordable, waitable, always done).
``cuda`` is the ``paddle.device.cuda`` namespace over the same functions.
"""
from __future__ import annotations

import torch

from ..core.place import (  # noqa: F401
    CUDAPlace,
    IPUPlace,
    MLUPlace,
    Place,
    XPUPlace,
    get_device,
    set_device,
)

__all__ = [
    "set_device",
    "get_device",
    "get_all_device_type",
    "get_available_device",
    "memory_allocated",
    "max_memory_allocated",
    "memory_reserved",
    "max_memory_reserved",
    "synchronize",
    "Stream",
    "Event",
    "current_stream",
    "stream_guard",
    "cuda",
]


def _cuda() -> bool:
    return torch.cuda.is_available()


def _index(device=None) -> int:
    """A card index from an int, a ``"gpu:1"`` string, a Place or None
    (the current device's, 0 for the CPU)."""
    if device is None:
        cur = get_device()
        return int(cur.split(":")[1]) if cur.startswith("gpu:") else 0
    if isinstance(device, int):
        return device
    if isinstance(device, str):
        tail = device.rsplit(":", 1)[-1]
        return int(tail) if tail.isdigit() else 0
    if isinstance(device, torch.device):
        return device.index or 0
    return int(getattr(device, "_device_id", getattr(device, "device_id", 0)) or 0)


def synchronize(device=None):
    """Flush the pending lazy segment (``core/lazy.py``), then wait for
    every queued kernel of the card."""
    from ..core import lazy

    lazy.flush_if_pending("explicit_sync")
    if _cuda():
        torch.cuda.synchronize(_index(device))


def is_compiled_with_cuda() -> bool:
    return _cuda()


def is_compiled_with_rocm() -> bool:
    return bool(getattr(torch.version, "hip", None))


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_mlu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def get_cudnn_version():
    """cuDNN's version as an int (e.g. 90100), or None without CUDA."""
    if not _cuda():
        return None
    return torch.backends.cudnn.version()


def get_all_custom_device_type():
    return []


def get_available_custom_device():
    return []


def get_all_device_type():
    return ["cpu", "gpu"] if _cuda() else ["cpu"]


def get_available_device():
    n = torch.cuda.device_count() if _cuda() else 0
    return [f"gpu:{i}" for i in range(n)] or ["cpu"]


def memory_allocated(device=None) -> int:
    """Bytes held by live tensors on the card (0 on the CPU)."""
    return int(torch.cuda.memory_allocated(_index(device))) if _cuda() else 0


def max_memory_allocated(device=None) -> int:
    return int(torch.cuda.max_memory_allocated(_index(device))) if _cuda() else 0


def memory_reserved(device=None) -> int:
    """Bytes the caching allocator holds from the card (0 on the CPU)."""
    return int(torch.cuda.memory_reserved(_index(device))) if _cuda() else 0


def max_memory_reserved(device=None) -> int:
    return int(torch.cuda.max_memory_reserved(_index(device))) if _cuda() else 0


class Stream:
    """A stream of the card (``torch.cuda.Stream``); without CUDA an
    identity object that is always done."""

    def __init__(self, device=None, priority=2):
        self.device = device
        self.priority = priority
        # Paddle's priorities are 1 (high) and 2 (normal); torch's 0 is normal
        self._s = (torch.cuda.Stream(device=_index(device), priority=-1 if priority == 1 else 0)
                   if _cuda() else None)

    @classmethod
    def _of(cls, s, device=None):
        out = cls.__new__(cls)
        out.device, out.priority, out._s = device, 2, s
        return out

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event

    def wait_event(self, event):
        if self._s is not None and event._e is not None:
            self._s.wait_event(event._e)

    def wait_stream(self, stream):
        if self._s is not None and stream._s is not None:
            self._s.wait_stream(stream._s)

    def synchronize(self):
        if self._s is not None:
            self._s.synchronize()

    def query(self):
        return True if self._s is None else self._s.query()


class Event:
    """An event of the card (``torch.cuda.Event``); without CUDA an
    identity object that is always done."""

    def __init__(self, enable_timing=False, blocking=False, interprocess=False):
        self._e = (torch.cuda.Event(enable_timing=enable_timing, blocking=blocking,
                                    interprocess=interprocess) if _cuda() else None)

    def record(self, stream=None):
        if self._e is not None:
            self._e.record(None if stream is None else stream._s)

    def query(self):
        return True if self._e is None else self._e.query()

    def synchronize(self):
        if self._e is not None:
            self._e.synchronize()

    def elapsed_time(self, end):
        return 0.0 if self._e is None else self._e.elapsed_time(end._e)


def current_stream(device=None):
    if not _cuda():
        return Stream._of(None, device)
    return Stream._of(torch.cuda.current_stream(_index(device)), device)


class stream_guard:
    """Run the block on ``stream`` (``torch.cuda.stream``)."""

    def __init__(self, stream):
        self.stream = stream
        self._ctx = None

    def __enter__(self):
        if self.stream is not None and self.stream._s is not None:
            self._ctx = torch.cuda.stream(self.stream._s)
            self._ctx.__enter__()
        return self.stream

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
        return False


def get_device_name(device=None):
    return torch.cuda.get_device_name(_index(device)) if _cuda() else "cpu"


def get_device_capability(device=None):
    """The card's compute capability, ``(9, 0)`` on an H100; (0, 0) without
    CUDA, as the JAX package answers."""
    return tuple(torch.cuda.get_device_capability(_index(device))) if _cuda() else (0, 0)


def get_device_properties(device=None):
    """``torch.cuda.get_device_properties`` (name, total_memory,
    multi_processor_count, major, minor); a stand-in of the CPU without
    CUDA."""
    if _cuda():
        return torch.cuda.get_device_properties(_index(device))

    class _Props:
        name = "cpu"
        major, minor = 0, 0
        total_memory = 0
        multi_processor_count = 1

        def __repr__(self):
            return f"_CudaDeviceProperties(name='{self.name}', total_memory=0)"

    return _Props()


class _CudaNamespace:
    """``paddle.device.cuda``."""

    Stream = Stream
    Event = Event
    current_stream = staticmethod(current_stream)
    stream_guard = stream_guard
    get_device_name = staticmethod(get_device_name)
    get_device_capability = staticmethod(get_device_capability)
    get_device_properties = staticmethod(get_device_properties)
    memory_allocated = staticmethod(memory_allocated)
    max_memory_allocated = staticmethod(max_memory_allocated)
    memory_reserved = staticmethod(memory_reserved)
    max_memory_reserved = staticmethod(max_memory_reserved)
    synchronize = staticmethod(synchronize)

    @staticmethod
    def device_count():
        return torch.cuda.device_count() if _cuda() else 0

    @staticmethod
    def empty_cache():
        """Return the caching allocator's unused blocks to the card."""
        if _cuda():
            torch.cuda.empty_cache()


cuda = _CudaNamespace()
