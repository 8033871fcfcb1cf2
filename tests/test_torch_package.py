"""Package boundaries of the PyTorch port: it runs without jax, paddle_tpu or nvcc,
and its default device is the card."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import gpt as tgpt

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2, max_seq_len=16)


def _run(code, **env):
    full = dict(os.environ, PYTHONPATH=str(ROOT), **env)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_import_and_cpu_forward_load_neither_jax_nor_paddle_tpu():
    # the inference forward and one O2 AdamW training step, in a fresh process
    out = _run(
        "import sys, torch\n"
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.models import GPTConfig, GPTForPretraining\n"
        "pt.set_device('cpu')\n"
        f"m = GPTForPretraining(GPTConfig(**{TINY!r})).eval()\n"
        "with torch.no_grad():\n"
        "    y = m(torch.zeros(1, 8, dtype=torch.int64))\n"
        "assert y.shape == (1, 8, 32)\n"
        "from paddle_tpu_torch.models import GPTPretrainingCriterion\n"
        "m = pt.amp.decorate(m, level='O2', dtype='bfloat16')\n"
        "opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters())\n"
        "crit = GPTPretrainingCriterion()\n"
        "step = pt.jit.compile_train_step(m, lambda lo, lb: crit(lo.float(), lb), opt)\n"
        "ids = torch.zeros(1, 9, dtype=torch.int64)\n"
        "assert torch.isfinite(step(ids[:, :-1], ids[:, 1:]))\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'paddle_tpu')))\n"
    )
    assert out.strip() == "[]"


def test_fused_update_path_loads_neither_jax_nor_paddle_tpu():
    # slice 3's eager f32 path: Adam with L2Decay, a global-norm clip, a
    # warm-up scheduler, the fused-update flag and the rescue sentinel
    out = _run(
        "import sys, torch\n"
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.models import GPTConfig, GPTForPretraining\n"
        "from paddle_tpu_torch.models import GPTPretrainingCriterion\n"
        "from paddle_tpu_torch.ops.kernels import _build, fused_update as fu\n"
        "pt.set_device('cpu')\n"
        "pt.set_flags({'FLAGS_pallas_fused_update': True, 'FLAGS_numeric_rescue': 'skip'})\n"
        f"m = GPTForPretraining(GPTConfig(**{TINY!r}))\n"
        "sched = pt.optimizer.lr.LinearWarmup(1e-3, 2, 0.0, 1e-3)\n"
        "opt = pt.optimizer.Adam(learning_rate=sched, parameters=m.parameters(),\n"
        "    weight_decay=pt.regularizer.L2Decay(0.01), grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))\n"
        "ids = torch.zeros(1, 9, dtype=torch.int64)\n"
        "for _ in range(2):\n"
        "    GPTPretrainingCriterion()(m(ids[:, :-1]), ids[:, 1:]).backward()\n"
        "    opt.step(); opt.clear_grad(); sched.step()\n"
        "assert opt._step_count == 2 and pt.resilience.rescue.counters['numeric_rescues'] == 0\n"
        "assert not _build._loaded and fu.fused_adam.launches == 0\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'paddle_tpu')))\n"
    )
    assert out.strip() == "[]"


def test_serving_path_loads_neither_jax_nor_paddle_tpu():
    # the serving engine: paged prefill and decode through the capture cache
    out = _run(
        "import sys, numpy as np\n"
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.models import GPTConfig, GPTForPretraining\n"
        "pt.set_device('cpu')\n"
        f"m = GPTForPretraining(GPTConfig(**{TINY!r}))\n"
        "eng = pt.serving.create_engine(m, block_size=8, prompt_buckets=[8], num_blocks=4)\n"
        "(r,) = eng.serve([np.arange(1, 6)], max_new_tokens=3)\n"
        "assert r.ok and len(r.tokens) == 3, r\n"
        "c = pt.profiler.dispatch_counters()\n"
        "assert c['serve_capture_builds'] == 2 and c['serve_capture_replays'] == 1, dict(c)\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'paddle_tpu')))\n"
    )
    assert out.strip() == "[]"


def test_fused_update_source_has_plain_c_entries():
    """csrc/fused_update.cu is plain CUDA C++: no PyTorch or library headers,
    the three launchers the wrappers bind, round-to-nearest intrinsics only."""
    src = (ROOT / "paddle_tpu_torch" / "csrc" / "fused_update.cu").read_text()
    includes = [line.split()[1] for line in src.splitlines() if line.startswith("#include")]
    assert includes == ["<cuda_runtime.h>", "<stdint.h>"]
    for entry in ("paddle_fused_sgd", "paddle_fused_momentum", "paddle_fused_adam"):
        assert f'extern "C" int {entry}(' in src
    for intrinsic in ("__fmul_rn", "__fadd_rn", "__fsub_rn", "__fdiv_rn", "__fsqrt_rn"):
        assert intrinsic in src
    for banned in ("torch", "at::", "cublas", "fmaf", "sqrtf", "__fsqrt_rd"):
        assert banned not in src.split("#include <stdint.h>", 1)[1], banned


def test_sources_import_neither_jax_nor_paddle_tpu():
    files = list((ROOT / "paddle_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "paddle_tpu"), (path, name)


def test_default_device_is_the_card_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    previous = pt.get_device()
    try:
        pt.set_device("gpu")
        assert pt.get_device() == "gpu:0"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tgpt.GPTForPretraining(tgpt.GPTConfig(**TINY))
        # the CPU is an opt-in: by argument, or by set_device
        assert tgpt.GPTForPretraining(tgpt.GPTConfig(**TINY), device="cpu")
        pt.set_device("cpu")
        model = tgpt.GPTForPretraining(tgpt.GPTConfig(**TINY))
        assert model.gpt.final_ln.weight.device.type == "cpu"
    finally:
        pt.set_device(previous)
    with pytest.raises(ValueError, match="unknown device"):
        pt.set_device("tpu")


def test_kernel_module_imports_and_runs_on_cpu_without_nvcc(tmp_path):
    out = _run(
        "import os, torch\n"
        "from paddle_tpu_torch.ops.kernels import _build, flash_attention as fa\n"
        "q = torch.randn(1, 16, 2, 8)\n"
        "o, lse = fa.flash_attention_fwd(q, q, q, 0.5, True)\n"
        "assert o.shape == q.shape and lse.shape == (1, 2, 16)\n"
        "delta = fa.bwd_delta(o, q)\n"
        "dk, dv = fa.flash_attention_bwd_dkv(q, q, q, q, lse, delta, 0.5, True)\n"
        "dq = fa.flash_attention_bwd_dq(q, q, q, q, lse, delta, 0.5, True)\n"
        "assert dq.shape == dk.shape == dv.shape == q.shape\n"
        "assert not _build._loaded and fa.flash_attention_fwd.launches == 0\n"
        "assert fa.flash_attention_bwd_dkv.launches == fa.flash_attention_bwd_dq.launches == 0\n"
        "if not os.path.isfile('/usr/local/cuda/bin/nvcc'):\n"
        "    try:\n"
        "        _build.nvcc()\n"
        "    except RuntimeError as e:\n"
        "        assert 'nvcc not found' in str(e)\n"
        "    else:\n"
        "        raise AssertionError('nvcc() found a compiler on an empty PATH')\n"
        "print('ok')\n",
        PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "no-cuda"),
    )
    assert out.strip() == "ok"


def test_flags_registry():
    assert pt.get_flags("FLAGS_use_flash_attention") == {"FLAGS_use_flash_attention": True}
    try:
        pt.set_flags({"FLAGS_use_flash_attention": "off"})
        assert pt.get_flags(["use_flash_attention"]) == {"FLAGS_use_flash_attention": False}
    finally:
        pt.set_flags({"FLAGS_use_flash_attention": True})
    with pytest.raises(ValueError, match="unknown flag"):
        pt.set_flags({"FLAGS_no_such_flag": 1})


def test_dtype_names():
    from paddle_tpu_torch.core.dtype import to_torch_dtype

    assert [to_torch_dtype(n) for n in ("float32", "bfloat16", "float16", "int64")] == [
        torch.float32, torch.bfloat16, torch.float16, torch.int64]
    assert to_torch_dtype(torch.bfloat16) is torch.bfloat16
    with pytest.raises(ValueError, match="unsupported dtype"):
        to_torch_dtype("complex64")


def test_resilience_serving_inference_load_neither_jax_nor_paddle_tpu():
    # the modules of slice 9: a supervised serve under fault injection that
    # restarts once, a generative predictor, the flight recorder
    out = _run(
        "import sys, numpy as np\n"
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch import inference, resilience, serving\n"
        "from paddle_tpu_torch.profiler import trace\n"
        "from paddle_tpu_torch.models import GPTConfig, GPTForPretraining\n"
        "pt.set_device('cpu')\n"
        f"m = GPTForPretraining(GPTConfig(**{TINY!r}))\n"
        "pt.set_flags({'FLAGS_fault_inject': 'execute:p=1:x=3:decode',\n"
        "              'FLAGS_retry_backoff_ms': 0.0})\n"
        "eng = serving.create_engine(m, block_size=8, prompt_buckets=[8], num_blocks=8)\n"
        "sup = serving.Supervisor(eng)\n"
        "rid = eng.submit(np.arange(1, 6), max_new_tokens=3)\n"
        "eng.step()\n"
        "eng.restart(RuntimeError('forced'))\n"
        "sup.run_until_idle()\n"
        "r = eng.response(rid)\n"
        "assert r.ok and len(r.tokens) == 3, r\n"
        "c = pt.profiler.dispatch_counters()\n"
        "assert c['ladder_demotions'] >= 1 and c['serve_engine_restarts'] == 1, dict(c)\n"
        "assert any(e.kind == 'fault' for e in trace.events())\n"
        "pt.set_flags({'FLAGS_fault_inject': ''})\n"
        "config = inference.Config()\n"
        "config.disable_gpu()\n"
        "config.enable_generative_serving(m, block_size=8, prompt_buckets=[8],\n"
        "                                 num_blocks=8, max_new_tokens=2)\n"
        "(out,) = inference.create_predictor(config).run([np.ones((2, 4), np.int64)])\n"
        "assert out.shape == (2, 2)\n"
        "assert resilience.is_transient(resilience.InjectedExecuteError('x'))\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'paddle_tpu')))\n"
    )
    assert out.strip() == "[]"


# paddle.serving names of the fleet front door (ROADMAP queue 1 item 13)
FLEET_NAMES = {"FleetAutoscaler", "FrontDoor", "LocalReplica", "RemoteReplica",
               "ReplicaServer", "ReplicaUnreachable"}


def _api_names():
    """The public names of ``API.spec``: one per line, ``paddle.x.y (sig)``."""
    lines = (ROOT / "API.spec").read_text().splitlines()
    return [line.split(" ", 1)[0] for line in lines if line.strip()]


def _resolve(name):
    """The port's object for a ``paddle.`` name, or None."""
    import importlib

    parts = name.split(".")[1:]
    obj = pt
    for i, part in enumerate(parts):
        if hasattr(obj, part):
            obj = getattr(obj, part)
            continue
        try:
            obj = importlib.import_module(".".join(["paddle_tpu_torch", *parts[:i + 1]]))
        except ImportError:
            return None
    return obj


def test_api_spec_surface_of_resilience_serving_inference():
    names = _api_names()
    assert len(names) == 1208
    scoped = [n for n in names
              if n.split(".")[1] in ("resilience", "inference", "serving")]
    assert len(scoped) > 40
    missing = [n for n in scoped
               if _resolve(n) is None and n.rsplit(".", 1)[1] not in FLEET_NAMES]
    assert missing == []
    assert {n.rsplit(".", 1)[1] for n in scoped if n.startswith("paddle.serving.")
            and _resolve(n) is None} == FLEET_NAMES
    # the artifact predictor is present and says what it waits for
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        pt.inference.Predictor(pt.inference.Config("model"))
    covered = sum(_resolve(n) is not None for n in names)
    print(f"API.spec coverage of the port: {covered} of {len(names)} names "
          f"({covered / len(names):.1%}); resilience, inference and serving: "
          f"{sum(_resolve(n) is not None for n in scoped)} of {len(scoped)}")


def test_api_spec_surface_of_amp_recompute_and_rng_state():
    names = _api_names()
    scoped = [n for n in names if n.startswith(("paddle.amp.", "paddle.incubate.recompute"))
              or n in ("paddle.get_rng_state", "paddle.set_rng_state")]
    assert len(scoped) == 10
    assert [n for n in scoped if _resolve(n) is None] == []
    # the fleet re-export of recompute (reference distributed/fleet/utils.py:11)
    assert _resolve("paddle.distributed.fleet.utils.recompute") is pt.incubate.recompute
    covered = sum(_resolve(n) is not None for n in names)
    assert covered >= 125
    print(f"API.spec coverage of the port: {covered} of {len(names)} names")


def test_amp_and_recompute_paths_load_neither_jax_nor_paddle_tpu():
    # slice 10: an O1 fp16 step with a GradScaler over a recompute GPT with
    # dropout, and a compiled step returning an input's gradient
    out = _run(
        "import sys, torch\n"
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.models import GPTConfig, GPTForPretraining\n"
        "from paddle_tpu_torch.models import GPTPretrainingCriterion\n"
        "pt.set_device('cpu')\n"
        f"m = GPTForPretraining(GPTConfig(**{TINY!r}, use_recompute=True))\n"
        "opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=m.parameters())\n"
        "scaler = pt.amp.GradScaler()\n"
        "ids = torch.zeros(1, 9, dtype=torch.int64)\n"
        "with pt.amp.auto_cast(level='O1', dtype='float16'):\n"
        "    loss = GPTPretrainingCriterion()(m(ids[:, :-1]), ids[:, 1:])\n"
        "scaler.minimize(opt, scaler.scale(loss))\n"
        "assert opt._step_count == 1 and loss.dtype == torch.float32\n"
        "lin = pt.nn.Linear(4, 3)\n"
        "opt = pt.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())\n"
        "step = pt.jit.compile_train_step(lin, lambda o, y: (o - y).square().mean(), opt,\n"
        "                                 grad_input_idx=(0,))\n"
        "loss, (g,) = step(torch.ones(2, 4), torch.zeros(2, 3))\n"
        "assert g.shape == (2, 4)\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'paddle_tpu')))\n"
    )
    assert out.strip() == "[]"


CHECKPOINT_NAMES = {"AsyncCheckpointer", "CadenceTuner", "CheckpointCadence", "TrainingState",
                    "load_state_dict", "persists_in_flight", "restore_training_state",
                    "save_state_dict", "train_epoch_range", "train_step_range",
                    "training_state"}


def test_api_spec_surface_of_checkpoint_save_load_and_layer():
    names = _api_names()
    scoped = [n for n in names if n.startswith("paddle.distributed.checkpoint.")]
    assert {n.rsplit(".", 1)[1] for n in scoped} == CHECKPOINT_NAMES
    scoped += ["paddle.save", "paddle.load", "paddle.nn.Layer", "paddle.profiler.StepTimer"]
    assert all(n in names for n in scoped)
    assert [n for n in scoped if _resolve(n) is None] == []
    from paddle_tpu_torch.distributed import checkpoint

    assert sorted(checkpoint.__all__) == sorted(CHECKPOINT_NAMES)
    assert _resolve("paddle.save") is pt.framework.io_utils.save
    assert _resolve("paddle.nn.Layer") is pt.nn.layer_base.Layer
    covered = sum(_resolve(n) is not None for n in names)
    assert covered >= 125 + len(scoped)
    print(f"API.spec coverage of the port: {covered} of {len(names)} names")


def test_checkpoint_path_loads_neither_jax_nor_paddle_tpu(tmp_path):
    # slice 11: paddle.save / load, set_state_dict, and a preempted
    # train_step_range resumed from its emergency snapshot
    out = _run(
        "import os, signal, sys, torch\n"
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.distributed import checkpoint as dc\n"
        "from paddle_tpu_torch.framework import io_utils\n"
        "pt.set_device('cpu')\n"
        "net = pt.nn.Linear(4, 3)\n"
        f"pt.save(net.state_dict(), {str(tmp_path / 'w.pdparams')!r})\n"
        f"assert pt.nn.Linear(4, 3).set_state_dict(pt.load({str(tmp_path / 'w.pdparams')!r}))"
        " == ([], [])\n"
        "opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=net.parameters())\n"
        "step = pt.jit.compile_train_step(net, lambda o, y: (o - y).square().mean(), opt)\n"
        f"ck = dc.AsyncCheckpointer({str(tmp_path / 'ck')!r})\n"
        "try:\n"
        "    for i in dc.train_step_range(4, ck, dc.training_state(net, opt), save_freq=1,\n"
        "                                 guard=pt.resilience.PreemptionGuard()):\n"
        "        step(torch.ones(2, 4), torch.zeros(2, 3))\n"
        "        if i == 1:\n"
        "            os.kill(os.getpid(), signal.SIGTERM)\n"
        "except pt.resilience.Preempted:\n"
        "    pass\n"
        f"assert dc.AsyncCheckpointer({str(tmp_path / 'ck')!r}).restore_latest(\n"
        "    dc.training_state(net, opt)) == 1\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'paddle_tpu')))\n"
    )
    assert out.strip() == "[]"
