"""DistributedStrategy — the declarative distributed config.

The port of ``paddle_tpu/distributed/fleet/distributed_strategy.py``
(reference: fleet/base/distributed_strategy.py wrapping the ~207 field
protobuf, paddle/fluid/framework/distributed_strategy.proto:276): the
user-facing knobs (amp/amp_configs, recompute, sharding{_configs},
hybrid_configs, pipeline, tensor_parallel, lamb, ...) as plain Python
state, each read by ``fleet.init``, the sharded step or the
meta-optimizer chain (``strategy_compiler.FIELD_STATUS``).
"""
from __future__ import annotations

from typing import Any, Dict


class DistributedStrategy:
    def __init__(self):
        # collective/base
        self.amp = False
        self.amp_configs: Dict[str, Any] = {
            "init_loss_scaling": 32768.0,
            "use_pure_fp16": False,
            "use_pure_bf16": False,
            "custom_white_list": [],
            "custom_black_list": [],
        }
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {"checkpoints": []}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01, "exclude_from_weight_decay": []}
        self.lars = False
        self.lars_configs = {}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "rampup_step": 1, "sparsity": [0.999]}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 0}
        self.fp16_allreduce = False
        self.sharding = False
        self.sharding_configs: Dict[str, Any] = {
            "sharding_degree": 1,
            "stage": 1,
            "offload": False,
        }
        self.pipeline = False
        self.pipeline_configs: Dict[str, Any] = {
            "accumulate_steps": 1,
            "micro_batch_size": 1,
        }
        self.tensor_parallel = False
        self.tensor_parallel_configs: Dict[str, Any] = {"tensor_parallel_degree": 1}
        self.hybrid_configs: Dict[str, Any] = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        self.heter_ccl_mode = False
        self.auto = False
        # auto=True planning knobs: tune=True measures the planner's topk
        # candidates on the devices and keeps the fastest (reference:
        # tuner/optimization_tuner.py's measure-then-pick loop); the
        # analytic estimates are calibrated against the first measurement
        self.auto_configs: Dict[str, Any] = {
            "tune": True, "topk": 3, "tune_iters": 2,
        }
        self.a_sync = False
        self.a_sync_configs: Dict[str, Any] = {"k_steps": -1}
        self.nccl_comm_num = 1
        self.find_unused_parameters = False
        self.fuse_grad_size_in_MB = 32
        self.last_comm_group_size_MB = 1
        self.fuse_all_reduce_ops = True

    @property
    def sharding_stage(self) -> int:
        if not self.sharding and self.hybrid_configs.get("sharding_degree", 1) <= 1:
            return 0
        return int(self.sharding_configs.get("stage", 1))

    def __setattr__(self, key, value):
        # unknown fields fail fast: a typo (`strategy.gradient_merg = True`)
        # must not become a silent no-op (see strategy_compiler.FIELD_STATUS
        # for the consumption map every real field carries)
        if not key.startswith("_") and key not in self.__dict__:
            from .strategy_compiler import FIELD_STATUS

            if key not in FIELD_STATUS:
                raise AttributeError(
                    f"DistributedStrategy has no field {key!r} (unknown "
                    "fields would be silently ignored; check the spelling)"
                )
        # dict-valued configs merge instead of replace (reference setter
        # semantics: distributed_strategy.py assigns proto sub-messages)
        cur = self.__dict__.get(key)
        if isinstance(cur, dict) and isinstance(value, dict):
            merged = dict(cur)
            merged.update(value)
            object.__setattr__(self, key, merged)
        else:
            object.__setattr__(self, key, value)

    def __repr__(self):
        fields = {
            k: v for k, v in self.__dict__.items()
            if not k.startswith("_") and v not in (False, None)
        }
        return f"DistributedStrategy({fields})"
