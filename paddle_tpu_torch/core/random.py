"""Random state: one ``Generator`` per device behind ``seed()``.

``paddle.seed`` reseeds every device's default ``Generator`` and returns the
current device's, as the JAX package's returns its ``default_generator``; the
random ops of ``paddle.*`` and the port's modules draw from the default
Generator of the device they run on (``generator(device)`` is its
``torch.Generator``).

The counterpart of ``paddle_tpu/core/random.py``, which splits jax keys. The
two packages can never share random bits, so tests make their inputs with
numpy and carry weights across with ``convert.state_dict_from_numpy``.

A CUDA graph reads a generator's seed and offset from device memory that is
filled before each replay, but only for the generator states registered with
the graph before its capture (``register_generator_state``); each replay then
draws new bits and advances the state, as every JAX call draws a new key.

A recompute segment (``incubate.recompute``) draws its forward's random bits
again in the backward. ``SegmentRng`` stashes what that takes: outside a
capture the generator's state, restored around the recomputation; inside a
capture, where a state cannot be rewound, a pair of generator states made and
registered before the capture (``SegmentPairs``), the first drawn from by the
segment's forward and the second by its recomputation. Before every replay
both of a pair are seeded from a key drawn from the device's generator, so
the device generators are the whole random state: ``get_rng_state`` and
``seed`` cover the segments' masks too, as the JAX step splits its key from
the global one.
"""
from __future__ import annotations

import contextlib

import torch

_DEFAULT_SEED = 0
_seed = _DEFAULT_SEED
_generators: dict = {}
_scope = None  # the _Segments of a jit step in progress, if any

_M64 = (1 << 64) - 1

# The host sampling stream of ``paddle.io``'s samplers: [seed, draws].
# The JAX package seeds RandomSampler, SubsetRandomSampler and
# WeightedRandomSampler with numpy from its generator's (seed, key counter);
# the port's generators are torch's and count no keys, so the samplers count
# their own draws here. ``seed()`` restarts the stream at (value, 0), where the
# JAX generator's counter restarts, so a fresh seed gives both packages the
# same first draw; each iteration of such a sampler is one draw (the JAX
# samplers reuse a counter until some random op advances it).
_host_stream = [_DEFAULT_SEED, 0]


def seed(value: int) -> "Generator":
    """``paddle.seed``: reseed every device's default Generator from ``value``
    and return the current device's.

    Generators are reseeded in place, so CUDA graphs that registered them
    draw from the new seed at their next replay."""
    global _seed
    _seed = int(value)
    _host_stream[:] = [_seed, 0]
    for gen in _generators.values():
        gen.manual_seed(_seed)
    return default_generator()


def host_stream_state() -> tuple:
    """(seed, draws) of the host sampling stream."""
    return tuple(_host_stream)


def set_host_stream_state(state) -> None:
    _host_stream[:] = [int(state[0]), int(state[1])]


def host_draw() -> tuple:
    """The stream's (seed, draws) for one draw, then one more draw counted."""
    state = tuple(_host_stream)
    _host_stream[1] += 1
    return state


class Generator:
    """``paddle.Generator``: a seeded source of random bits on one device (the
    current one unless given), over the ``torch.Generator`` in ``generator``.

    That is made on first use, so a Generator of a card that CUDA cannot
    reach raises only when it is drawn from."""

    def __init__(self, seed: int = 0, device=None):
        self.device = _key_device(device)
        self._seed = int(seed)
        self._gen = None

    @property
    def generator(self) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(self._seed)
        return self._gen

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        if self._gen is not None:
            self._gen.manual_seed(self._seed)
        return self

    def initial_seed(self) -> int:
        return self._seed if self._gen is None else self._gen.initial_seed()

    def get_state(self):
        return self.generator.get_state()

    def set_state(self, state):
        self.generator.set_state(state)


def _key_device(device) -> torch.device:
    """``device`` (a torch device, a Place or its name; the current device when
    None) as a torch device with its index, without asking CUDA whether the
    card is there."""
    if not isinstance(device, torch.device):
        from .place import device_of

        device = device_of(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def default_generator(device=None) -> Generator:
    """The default Generator of ``device`` (the current device when None),
    made from the current seed on first use."""
    device = _key_device(device)
    key = str(device)
    gen = _generators.get(key)
    if gen is None:
        gen = _generators[key] = Generator(_seed, device)
    return gen


def generator(device) -> torch.Generator:
    """The ``torch.Generator`` of ``device``'s default Generator."""
    return default_generator(torch.device(device)).generator


def get_rng_state():
    """``paddle.get_rng_state``: the seed and the state of every device
    generator drawn from so far."""
    return _seed, {key: gen.get_state() for key, gen in _generators.items()
                   if gen._gen is not None}


def set_rng_state(state) -> None:
    """``paddle.set_rng_state``: restore what ``get_rng_state`` returned, in
    place for generators that exist (graphs that registered them follow)."""
    global _seed
    _seed, states = int(state[0]), state[1]
    for gen in _generators.values():
        if gen._gen is None:
            gen.manual_seed(_seed)
    for key, value in states.items():
        generator(key).set_state(value)


def _capturing(device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _mix(*words: int) -> int:
    """splitmix64 over ``words``: a 64-bit seed, each of a stream of its own
    (Philox streams of different keys are independent)."""
    z = 0
    for w in words:
        z = (z + (w & _M64) + 0x9E3779B97F4A7C15) & _M64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        z ^= z >> 31
    return z


def _draw_key(gen: torch.Generator) -> int:
    """A 64-bit key drawn from ``gen`` on the host, advancing it as a draw
    would: from a CUDA generator its seed and Philox offset, then one Philox
    block (an offset of 4); from a CPU generator a random integer."""
    if gen.device.type == "cuda":
        offset = gen.get_offset()
        gen.set_offset(offset + 4)
        return _mix(gen.initial_seed(), offset)
    return int(torch.randint(1 << 62, (), generator=gen))


@contextlib.contextmanager
def drawing_from(gen: torch.Generator, source: torch.Generator):
    """Inside the context, ops given ``gen`` draw from ``source``'s state and
    advance it; safe inside a CUDA-graph capture."""
    own = gen.graphsafe_get_state()
    gen.graphsafe_set_state(source)
    try:
        yield
    finally:
        gen.graphsafe_set_state(own)


class SegmentPairs:
    """The generator pairs of a captured step's recompute segments, one per
    segment, in the order the step runs them: ``(forward, recompute)``.

    ``reseed()``, before every replay, seeds both of each pair alike from a
    key drawn from the device's generator: the replay's forward and its
    recomputation draw the same bits, every replay draws new ones, and
    restoring the device's generator restores them."""

    def __init__(self, device, n: int):
        device = torch.device(device)
        self._gen = generator(device)
        self._pairs = [(torch.Generator(device=device), torch.Generator(device=device))
                       for _ in range(n)]

    def __len__(self):
        return len(self._pairs)

    def __iter__(self):
        return iter(self._pairs)

    def __getitem__(self, i):
        return self._pairs[i]

    def reseed(self) -> None:
        if not self._pairs:
            return  # the device's generator is not advanced for no segments
        key = _draw_key(self._gen)
        for i, pair in enumerate(self._pairs):
            for gen in pair:
                gen.manual_seed(_mix(key, i))


class _Segments:
    """The recompute segments a jit step runs: their count, and inside a
    capture the pairs registered for them."""

    def __init__(self, pairs=None):
        self.count = 0
        self.pairs = pairs


def _enter_segment(device):
    """Count a recompute segment of the jit step in progress; inside a
    capture, return the segment's pair."""
    if _scope is not None:
        _scope.count += 1
    if not _capturing(device):
        return None
    if _scope is None or _scope.pairs is None or _scope.count > len(_scope.pairs):
        raise RuntimeError(
            "a recompute segment in a CUDA-graph capture needs a generator pair "
            "registered before the capture (core.random.register_generator_state)")
    return _scope.pairs[_scope.count - 1]


@contextlib.contextmanager
def counting_segments():
    """Count the recompute segments that run inside the context: yields an
    object whose ``count`` is their number."""
    global _scope
    outer, _scope = _scope, _Segments()
    try:
        yield _scope
    finally:
        _scope = outer


@contextlib.contextmanager
def register_generator_state(graph, device, segments: int = 0):
    """Register the port's generators on ``device`` with ``graph`` before its
    capture, and the generator pairs of ``segments`` recompute segments,
    which the capture inside this context hands to the segments it runs, in
    order. Yields the ``SegmentPairs``; call its ``reseed()`` before every
    replay.

    The device's generator is made if it does not exist: one made during the
    capture would not be registered. Raises if the capture ran a number of
    segments other than ``segments``."""
    global _scope
    device = torch.device(device)
    generator(device)
    for key, gen in _generators.items():
        if torch.device(key) == device:
            graph.register_generator_state(gen.generator)
    pairs = SegmentPairs(device, segments)
    for pair in pairs:
        for gen in pair:
            graph.register_generator_state(gen)
    outer, _scope = _scope, _Segments(pairs)
    try:
        yield pairs
        if _scope.count != segments:
            raise RuntimeError(f"the capture ran {_scope.count} recompute segments, "
                               f"its warm-up steps {segments}")
    finally:
        _scope = outer


class SegmentRng:
    """What a recompute segment on ``device`` needs to draw its forward's
    random bits again: ``forward()`` around the forward, ``replay()`` around
    the recomputation, each a context manager."""

    def __init__(self, device):
        device = torch.device(device)
        self._gen = generator(device)
        self._pair = _enter_segment(device)
        if self._pair is None:
            self._state = self._gen.get_state()

    def forward(self):
        if self._pair is None:
            return contextlib.nullcontext()
        return drawing_from(self._gen, self._pair[0])

    @contextlib.contextmanager
    def replay(self):
        if self._pair is not None:
            with drawing_from(self._gen, self._pair[1]):
                yield
            return
        after = self._gen.get_state()
        self._gen.set_state(self._state)
        try:
            yield
        finally:
            self._gen.set_state(after)
