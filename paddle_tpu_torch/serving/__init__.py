"""``paddle.serving`` for the port: the continuous-batching inference runtime.

A request queue feeding shape-bucketed continuous batches, a **paged KV
cache** (one shared block pool per layer; admission is refused when a
request can never fit it), and prefill/decode steps captured as **one CUDA
graph per bucket signature** (``core/lazy.py``). Per-request deadlines,
SLO-aware admission with load shedding, and health states are ported;
the JAX package's Supervisor, fleet FrontDoor, inference
``GenerativePredictor``, fault ladder and memory planner are not yet
(ROADMAP queue 1 items 10-12).

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    model = GPTForPretraining(GPTConfig(...))
    engine = pt.serving.Engine(model)
    rid = engine.submit(prompt_ids, max_new_tokens=64, eos_token_id=0)
    engine.run_until_idle()
    print(engine.response(rid).tokens)
"""
from __future__ import annotations

from .admission import AdmissionController  # noqa: F401
from .cache import BlockPool, PagedCacheView  # noqa: F401
from .engine import HEALTH_STATES, Engine, ServingConfig, StepTiming  # noqa: F401
from .scheduler import (  # noqa: F401
    PRIORITIES,
    Request,
    RequestQueue,
    Response,
    ServingBuckets,
)

__all__ = [
    "AdmissionController",
    "BlockPool",
    "Engine",
    "HEALTH_STATES",
    "PRIORITIES",
    "PagedCacheView",
    "Request",
    "RequestQueue",
    "Response",
    "ServingBuckets",
    "ServingConfig",
    "StepTiming",
    "create_engine",
]


def create_engine(model, **kwargs) -> Engine:
    """Build an :class:`Engine` with keyword config (the
    ``inference.create_predictor`` idiom for the serving surface)."""
    return Engine(model, ServingConfig(**kwargs) if kwargs else None)
