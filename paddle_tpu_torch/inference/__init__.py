"""``paddle.inference`` for the port: the deployment predictor API of
``paddle_tpu/inference``, over the serving engine.

A Config with ``enable_generative_serving(model, ...)`` gives a
``GenerativePredictor``: the Paddle predictor surface (zero-copy
``input_ids`` / ``prompt_lens`` handles in, a ``tokens`` handle out) over a
``serving.Engine``, the continuous-batching runtime with its CUDA-graph
decode. ``PredictorPool`` holds several and routes around unhealthy ones.

The predictor serves on its model's device and never moves the model:
``Config`` asks for the card unless ``disable_gpu()`` was called, and a
Config that asks for the CPU with the model on the card (or the reverse)
raises.

Not ported yet: ``Predictor``, the executor of a saved program artifact.
The JAX one runs the StableHLO program ``jit.save`` exported; the port has
no ``jit.save`` (ROADMAP queue 1 item 14), so a non-generative Config
raises NotImplementedError.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "Config",
    "DataType",
    "GenerativePredictor",
    "PlaceType",
    "PrecisionType",
    "Predictor",
    "PredictorPool",
    "Tensor",
    "create_predictor",
    "get_num_bytes_of_data_type",
    "get_version",
]

_ARTIFACT_SUFFIXES = (".stablehlo", ".pdmodel", ".pdparams")


def _not_ported_artifact():
    return NotImplementedError(
        "inference.Predictor (a saved program artifact's executor) is not ported "
        "yet: it needs jit.save (ROADMAP, open items, queue 1 item 14); use "
        "Config.enable_generative_serving(model) for a generative model")


def _strip_suffix(path: str) -> str:
    for suffix in _ARTIFACT_SUFFIXES:
        if path.endswith(suffix):
            return path[: -len(suffix)]
    return path


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    kUNK = -1
    kCPU = 0
    kGPU = 1


class Config:
    """AnalysisConfig analogue (reference: paddle_analysis_config.h).

    The device toggles map onto the card: the predictor serves on the card
    unless ``disable_gpu()`` was called. TensorRT and MKLDNN toggles warn:
    the port's kernels are its own."""

    def __init__(self, prog_file: Optional[str] = None, params_file: Optional[str] = None):
        self._prefix = _strip_suffix(prog_file or "")
        self._device = "gpu"
        self._device_id = 0
        self._memory_optim = True
        self._ir_optim = True
        self._threads = 1
        self._generative_model = None
        self._serving_opts: Dict = {}

    # --- model location -------------------------------------------------
    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        """Update the model location; other toggles keep their values."""
        prefix = _strip_suffix(prog_file)
        if params_file is not None and _strip_suffix(params_file) != prefix:
            warnings.warn(
                f"params_file prefix {_strip_suffix(params_file)!r} differs from "
                f"prog_file prefix {prefix!r}; artifacts keep program and params "
                "under one prefix — using the prog_file prefix"
            )
        self._prefix = prefix

    def model_dir(self) -> str:
        return self._prefix

    def prog_file(self) -> str:
        return self._prefix + ".stablehlo"

    def params_file(self) -> str:
        return self._prefix + ".pdmodel"

    # --- device selection -------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100, device_id: int = 0):
        self._device = "gpu"
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device != "cpu"

    def gpu_device_id(self) -> int:
        return self._device_id

    def set_cpu_math_library_num_threads(self, n: int):
        self._threads = n

    # --- generative serving (serving.Engine) --------------------------------
    def enable_generative_serving(self, model, **serving_opts):
        """Route this predictor onto the serving engine: ``model`` is a live
        generative LM (``models.gpt.GPTForPretraining``-shaped — KV-cache
        decode through per-layer cache views). ``serving_opts`` forward to
        ``serving.ServingConfig`` (block_size, prompt_buckets, ...), and
        ``max_new_tokens`` / ``eos_token_id`` to every request.
        ``enable_memory_optim`` then decides the paged KV pool's size: on
        (the default), a pool sized from FLAGS_memory_budget_mb when one is
        set, which needs the memory planner and raises (ROADMAP queue 1 item
        12); off, the unbudgeted default size."""
        self._generative_model = model
        self._serving_opts = dict(serving_opts)

    def is_generative(self) -> bool:
        return self._generative_model is not None

    # --- optimization toggles ---------------------------------------------
    def switch_ir_optim(self, flag: bool = True):
        self._ir_optim = flag

    def enable_memory_optim(self, flag: bool = True):
        """For generative serving predictors: on, the paged KV block pool is
        budgeted against FLAGS_memory_budget_mb when it is set (not ported:
        the engine raises); off, the pool takes the default size."""
        self._memory_optim = flag

    def enable_tensorrt_engine(self, *a, **k):
        warnings.warn(
            "enable_tensorrt_engine is a no-op and deprecated here: the port "
            "serves through its own kernels and CUDA graphs; for generative-"
            "model serving use Config.enable_generative_serving",
            DeprecationWarning, stacklevel=2,
        )

    def enable_mkldnn(self, *a, **k):
        warnings.warn(
            "enable_mkldnn is a no-op and deprecated here: the port serves on "
            "the card",
            DeprecationWarning, stacklevel=2,
        )

    def switch_use_feed_fetch_ops(self, flag: bool):
        pass

    def switch_specify_input_names(self, flag: bool = True):
        pass

    def summary(self) -> str:
        return (
            f"Config(prefix={self._prefix!r}, device={self._device}, "
            f"ir_optim={self._ir_optim}, memory_optim={self._memory_optim})"
        )


class Tensor:
    """Zero-copy IO handle (reference: paddle_tensor.h ZeroCopyTensor) over
    one torch tensor. ``copy_from_cpu`` copies in, ``copy_to_cpu`` is the
    host read; ``share_external_data`` keeps a torch tensor without a copy.
    A generative predictor's handles live on the host, where the scheduler
    reads prompts."""

    def __init__(self, name: str, dtype=None, shape=None):
        self._name = name
        self._value: Optional[torch.Tensor] = None
        self._dtype = np.dtype(dtype) if dtype is not None else None
        self._declared_shape = shape

    def name(self) -> str:
        return self._name

    def reshape(self, shape):
        """Declare the upcoming input shape (the copy itself fixes it)."""
        self._declared_shape = list(shape)

    def copy_from_cpu(self, data):
        arr = np.asarray(data)
        if self._dtype is not None and arr.dtype != self._dtype:
            arr = arr.astype(self._dtype)
        self._value = torch.from_numpy(np.ascontiguousarray(arr)).clone()

    def share_external_data(self, data):
        self._value = data if isinstance(data, torch.Tensor) else torch.as_tensor(data)

    def copy_to_cpu(self):
        if self._value is None:
            raise RuntimeError(f"output handle '{self._name}' has no data; call run() first")
        return self._value.detach().cpu().numpy()

    def shape(self):
        if self._value is not None:
            return list(self._value.shape)
        return list(self._declared_shape or [])

    def type(self):
        v = self._value
        return str(v.dtype) if v is not None else str(self._dtype)


class Predictor:
    """AnalysisPredictor analogue over a saved program artifact: not ported
    (it needs ``jit.save``, ROADMAP queue 1 item 14). Constructing one
    raises NotImplementedError."""

    def __init__(self, config: Config):
        raise _not_ported_artifact()


class GenerativePredictor:
    """Predictor-surface adapter over the serving engine — what
    ``create_predictor`` returns for a Config with
    ``enable_generative_serving`` set. Feed ``input_ids`` ([b, s] int, one
    prompt per row) and optionally ``prompt_lens`` ([b] int true lengths for
    right-padded rows); after ``run()`` the ``tokens`` handle holds
    [b, max_new] generated ids, -1-padded past each row's completion."""

    def __init__(self, config: Config):
        from .. import serving as _serving

        model = config._generative_model
        model_device = next(model.parameters()).device
        if config.use_gpu() != (model_device.type == "cuda"):
            raise ValueError(
                f"the Config asks for the {'card' if config.use_gpu() else 'CPU'} "
                f"but the model is on {model_device}: the predictor serves on its "
                "model's device and does not move the model (move it, or "
                f"{'call Config.disable_gpu()' if config.use_gpu() else 'leave the GPU enabled'})"
            )
        self._config = config
        opts = dict(config._serving_opts)
        self._max_new = int(opts.pop("max_new_tokens", 0)) or None
        self._eos = opts.pop("eos_token_id", None)
        if not config._memory_optim:
            # memory_optim off: no budgeting, the default pool
            from ..serving.cache import default_num_blocks

            opts["num_blocks"] = opts.get("num_blocks") or default_num_blocks()
        self._engine = _serving.Engine(
            model, _serving.ServingConfig(**opts) if opts else None)
        self._inputs, self._outputs = self._handles()

    @staticmethod
    def _handles():
        return ({"input_ids": Tensor("input_ids", np.int64),
                 "prompt_lens": Tensor("prompt_lens", np.int64)},
                {"tokens": Tensor("tokens")})

    def get_input_names(self) -> List[str]:
        return ["input_ids", "prompt_lens"]

    def get_output_names(self) -> List[str]:
        return ["tokens"]

    def get_input_handle(self, name: str) -> Tensor:
        return self._inputs[name]

    def get_output_handle(self, name: str) -> Tensor:
        return self._outputs[name]

    @property
    def engine(self):
        """The underlying serving.Engine (stats(), submit(), ...)."""
        return self._engine

    def health(self) -> str:
        """The engine's live health state (warming/ready/degraded/
        draining/dead) — what PredictorPool.acquire routes on."""
        return self._engine.health

    def serviceable(self) -> bool:
        return self._engine.serviceable()

    def run(self, inputs=None):
        if inputs is not None:
            self._inputs["input_ids"].copy_from_cpu(inputs[0])
            if len(inputs) > 1:
                self._inputs["prompt_lens"].copy_from_cpu(inputs[1])
            else:
                # a list-style call without lens must not inherit a stale
                # prompt_lens handle from a previous run
                self._inputs["prompt_lens"]._value = None
        ids_h = self._inputs["input_ids"]
        if ids_h._value is None:
            raise RuntimeError("input 'input_ids' not set; call copy_from_cpu first")
        ids = ids_h.copy_to_cpu()
        if ids.ndim == 1:
            ids = ids[None, :]
        lens_h = self._inputs["prompt_lens"]
        lens = (lens_h.copy_to_cpu().reshape(-1).astype(int) if lens_h._value is not None
                else np.full((ids.shape[0],), ids.shape[1], int))
        if lens.shape[0] != ids.shape[0]:
            raise ValueError(
                f"prompt_lens has {lens.shape[0]} entries for a batch of "
                f"{ids.shape[0]} prompts"
            )
        if ((lens < 1) | (lens > ids.shape[1])).any():
            raise ValueError(
                f"prompt_lens entries must be in [1, {ids.shape[1]}] "
                f"(the input_ids width); got {lens.tolist()}"
            )
        prompts = [ids[i, : int(lens[i])] for i in range(ids.shape[0])]
        resps = self._engine.serve(
            prompts, max_new_tokens=self._max_new, eos_token_id=self._eos)
        # fixed documented shape [b, max_new], -1-padded past each row's
        # completion (EOS can end a row early)
        width = self._max_new or self._engine._default_max_new
        out = np.full((len(resps), max(1, width)), -1, np.int64)
        for i, r in enumerate(resps):
            if not r.ok:
                raise RuntimeError(
                    f"serving request {r.request_id} failed: {r.status}: {r.error}"
                )
            out[i, : len(r.tokens)] = r.tokens
        self._outputs["tokens"]._value = torch.from_numpy(out)
        if inputs is not None:
            return [out]
        return True

    def clone(self) -> "GenerativePredictor":
        """Share the engine (a serving engine already multiplexes requests);
        fresh IO handles — the Predictor.clone()/PredictorPool contract."""
        p = object.__new__(GenerativePredictor)
        p._config = self._config
        p._max_new = self._max_new
        p._eos = self._eos
        p._engine = self._engine
        p._inputs, p._outputs = self._handles()
        return p

    def try_shrink_memory(self):
        pass


def create_predictor(config: Config):
    """reference: paddle_infer::CreatePredictor. A Config with
    ``enable_generative_serving(model)`` routes onto the serving engine; a
    saved artifact needs ``Predictor``, which is not ported yet."""
    if config.is_generative():
        return GenerativePredictor(config)
    return Predictor(config)


class DataType:
    """reference: paddle_infer.DataType enum."""

    FLOAT32 = "float32"
    FLOAT16 = "float16"
    INT8 = "int8"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    BOOL = "bool"


_DTYPE_BYTES = {
    DataType.FLOAT32: 4, DataType.FLOAT16: 2, DataType.INT8: 1,
    DataType.INT32: 4, DataType.INT64: 8, DataType.UINT8: 1, DataType.BOOL: 1,
}


def get_num_bytes_of_data_type(dtype) -> int:
    return _DTYPE_BYTES[dtype]


def get_version() -> str:
    return (f"paddle_tpu_torch inference (PyTorch {torch.__version__}, "
            f"CUDA {torch.version.cuda})")


def _pick_serviceable(candidates, rr: int = 0) -> Optional[int]:
    """Round-robin index pick under the fleet health-preference rule (the
    port's copy of ``paddle_tpu/serving/frontdoor.py``'s
    ``pick_serviceable``; the front door itself is ROADMAP queue 1 item
    13): never a draining/dead candidate, 'degraded' only when nothing
    healthier serves. None when no candidate is serviceable."""
    n = len(candidates)
    degraded = None
    for i in range(n):
        idx = (rr + i) % n
        c = candidates[idx]
        if not c.serviceable():
            continue
        if c.health() == "degraded":
            if degraded is None:
                degraded = idx
            continue
        return idx
    return degraded


class PredictorPool:
    """Pool of predictors for concurrent serving (reference:
    paddle_infer.PredictorPool over AnalysisPredictor::Clone).

    ``clone=True`` (the default, the reference contract) shares one engine
    across the pool; ``clone=False`` builds independent replicas via
    ``create_predictor`` — one Engine each, which is what makes the
    health-aware routing in :meth:`acquire` meaningful (clones of one
    engine get sick together)."""

    def __init__(self, config: Config, size: int = 1, clone: bool = True):
        if size < 1:
            raise ValueError("pool size must be >= 1")
        first = create_predictor(config)
        if clone:
            rest = [first.clone() for _ in range(size - 1)]
        else:
            rest = [create_predictor(config) for _ in range(size - 1)]
        self._predictors = [first] + rest
        self._rr = 0

    def retrieve(self, idx: int):
        return self._predictors[idx]

    def acquire(self):
        """The next predictor that will accept work, round-robin, routing
        around unhealthy replicas: draining/dead engines are skipped, and
        'ready'/'warming' replicas are preferred over 'degraded' ones (a
        degraded replica still serves when it is all that's left). Raises
        when every replica is dead/draining — fail loud, never hang."""
        idx = _pick_serviceable(self._predictors, rr=self._rr)
        if idx is None:
            raise RuntimeError(
                "PredictorPool.acquire: no serviceable replica "
                f"(healths: {[p.health() for p in self._predictors]})")
        self._rr = (idx + 1) % len(self._predictors)
        return self._predictors[idx]

    def healths(self) -> List[str]:
        return [p.health() for p in self._predictors]

    def __len__(self):
        return len(self._predictors)
