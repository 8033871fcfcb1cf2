"""``paddle.serving`` for the port: the continuous-batching inference runtime.

A request queue feeding shape-bucketed continuous batches, a **paged KV
cache** (one shared block pool per layer; admission is refused when a
request can never fit it), and prefill/decode steps captured as **one CUDA
graph per bucket signature** (``core/lazy.py``). The resilience ladder runs
through the serve loop: a transient fault mid-decode demotes that bucket's
program from its graph to the retained rung and retries the batch without
dropping requests; SIGTERM drains in-flight sequences. Per-request
deadlines, SLO-aware admission with load shedding, health states and the
**Supervisor** that restarts a wedged engine (bounded, then fails cleanly)
are ported. The fleet FrontDoor and the memory planner are not yet
(ROADMAP queue 1 items 13 and 12).

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
from .supervisor import Supervisor  # noqa: F401

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
    "Supervisor",
    "create_engine",
]


def create_engine(model, **kwargs) -> Engine:
    """Build an :class:`Engine` with keyword config (the
    ``inference.create_predictor`` idiom for the serving surface)."""
    return Engine(model, ServingConfig(**kwargs) if kwargs else None)
