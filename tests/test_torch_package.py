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
    # every Paddle dtype since the tensor surface (slice 13)
    names = ("bool", "int8", "int16", "int32", "int64", "uint8", "float16", "float32",
             "float64", "bfloat16", "complex64", "complex128")
    assert [to_torch_dtype(n) for n in names] == [getattr(torch, n) for n in names]
    with pytest.raises(ValueError, match="unsupported dtype"):
        to_torch_dtype("float8")


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


OPTIMIZER_NAMES = ["Adadelta", "Adagrad", "Adamax", "Lamb", "Lars", "RMSProp"]


def test_api_spec_surface_of_bert_slice():
    """The six optimizers and ``nn.functional.tanh`` resolve; with them every
    ``paddle.optimizer`` class of API.spec is ported."""
    names = _api_names()
    scoped = [f"paddle.optimizer.{n}" for n in OPTIMIZER_NAMES] + ["paddle.nn.functional.tanh"]
    assert all(n in names for n in scoped)
    assert [n for n in scoped if _resolve(n) is None] == []
    assert _resolve("paddle.optimizer.Lamb") is pt.optimizer.optimizer.Lamb
    classes = [n for n in names if n.startswith("paddle.optimizer.") and n.count(".") == 2
               and n.rsplit(".", 1)[1][0].isupper()]
    assert [n for n in classes if _resolve(n) is None] == []
    covered = sum(_resolve(n) is not None for n in names)
    assert covered >= 140 + len(scoped)
    print(f"API.spec coverage of the port: {covered} of {len(names)} names")


def test_bert_path_loads_neither_jax_nor_paddle_tpu():
    # slice 12: an O2 BERT step through compile_train_step with Lamb, the
    # masked forward, and the other five new optimizers' eager steps
    out = _run(
        "import sys, torch\n"
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.models import BertConfig, BertForPretraining\n"
        "from paddle_tpu_torch.models import BertPretrainingCriterion\n"
        "pt.set_device('cpu')\n"
        "cfg = BertConfig(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,\n"
        "                 max_seq_len=8, dropout=0.0, attn_dropout=0.0)\n"
        "m = pt.amp.decorate(BertForPretraining(cfg), level='O2', dtype='bfloat16')\n"
        "crit = BertPretrainingCriterion()\n"
        "opt = pt.optimizer.Lamb(learning_rate=1e-3, parameters=m.parameters())\n"
        "step = pt.jit.compile_train_step(\n"
        "    m, lambda o, y: crit(o[0].float(), o[1].float(), y[:, :-1], y[:, -1]), opt)\n"
        "ids = torch.zeros(2, 8, dtype=torch.int64)\n"
        "assert torch.isfinite(step(ids, torch.zeros(2, 9, dtype=torch.int64)))\n"
        "mlm, nsp = m(ids, None, torch.ones(2, 8, dtype=torch.int64))\n"
        "assert mlm.shape == (2, 8, 32) and mlm.dtype == torch.float32\n"
        "for name in ('Adamax', 'Adagrad', 'Adadelta', 'RMSProp', 'Lars'):\n"
        "    w = torch.nn.Parameter(torch.ones(3))\n"
        "    o = getattr(pt.optimizer, name)(learning_rate=0.1, parameters=[w])\n"
        "    w.grad = torch.ones(3)\n"
        "    o.step()\n"
        "    assert bool((w < 1).all()), name\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'paddle_tpu')))\n"
    )
    assert out.strip() == "[]"


# top-level names of API.spec whose modules belong to later queue items
# (ROADMAP queue 1): hapi (item 14), DataParallel (item 13), static mode
# (item 14)
TOP_LEVEL_LATER = {
    "paddle.Model": "item 14", "paddle.summary": "item 14", "paddle.flops": "item 14",
    "paddle.DataParallel": "item 13", "paddle.enable_static": "item 14",
    "paddle.disable_static": "item 14",
}


def test_api_spec_top_level_resolves_but_for_later_items():
    """Every top-level ``paddle.<name>`` of API.spec resolves in the port but
    the names left to named queue items; with them the coverage of the
    whole spec rises from slice 12's 147 names."""
    names = _api_names()
    top = [n for n in names if n.count(".") == 1]
    assert len(top) == 328
    missing = sorted(n for n in top if _resolve(n) is None)
    assert missing == sorted(TOP_LEVEL_LATER), missing
    for name in ("Tensor", "to_tensor", "add", "matmul", "reshape", "sum", "grad", "no_grad"):
        assert _resolve(f"paddle.{name}") is getattr(pt, name)
    assert _resolve("paddle.Tensor") is pt.core.tensor.Tensor
    covered = sum(_resolve(n) is not None for n in names)
    assert covered >= 147 + 300
    print(f"API.spec coverage of the port: {covered} of {len(names)} names "
          f"({covered / len(names):.1%}); top level: {len(top) - len(missing)} of {len(top)}")


def _patch_list():
    """The method names and dunders ``paddle_tpu/tensor_api.py``'s
    ``_patch_tensor_methods`` binds (its list, then its ``Tensor.__x__``
    assignments), read from the source."""
    src = (ROOT / "paddle_tpu" / "tensor_api.py").read_text()
    body = src[src.index("def _patch_tensor_methods():"):src.index("_patch_tensor_methods()\n")]
    start = body.index("method_names = [") + len("method_names = ")
    listed = ast.literal_eval(body[start:body.index("]", start) + 1])
    assigned = [line.split("=")[0].strip().split(".", 1)[1] for line in body.splitlines()
                if line.strip().startswith("Tensor.") and "=" in line]
    return listed, assigned


@pytest.mark.parametrize("kind", ["methods", "dunders_and_rest"])
def test_tensor_has_every_method_of_the_jax_patch_list(kind):
    listed, assigned = _patch_list()
    assert len(listed) > 150 and "__add__" in assigned and "add_" in assigned
    names = listed if kind == "methods" else assigned
    missing = [n for n in names if not hasattr(pt.Tensor, n)]
    assert missing == []
    # the same list, bound on the port's Tensor, not on torch.Tensor
    from paddle_tpu_torch import tensor_api

    assert tensor_api.METHOD_NAMES == listed
    # a cell, not a torch.Tensor: torch's own class gains none of the names
    assert pt.Tensor.__mro__ == (pt.Tensor, object)
    assert not hasattr(torch.Tensor, "put_along_axis_")


def test_paddle_style_script_loads_neither_jax_nor_paddle_tpu():
    # slice 13: a Paddle user's script through the tensor surface: to_tensor,
    # the paddle.* functions, Tensor methods, backward, paddle.grad, a layer
    # and a criterion taking Tensors, an optimizer step, no_grad eval
    out = _run(
        "import sys, numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "from paddle_tpu_torch.models import GPTConfig, GPTForPretraining\n"
        "from paddle_tpu_torch.models import GPTPretrainingCriterion\n"
        "paddle.set_device('cpu')\n"
        "paddle.seed(0)\n"
        "x = paddle.to_tensor(np.arange(6.0).reshape(2, 3), dtype='float32', stop_gradient=False)\n"
        "y = paddle.matmul(x, x.t()).reshape([0, -1]).sum()\n"
        "y.backward()\n"
        "(g,) = paddle.grad([(x * x).sum()], [x])\n"
        "assert x.grad.shape == [2, 3] and g.stop_gradient\n"
        f"m = GPTForPretraining(GPTConfig(**{TINY!r}))\n"
        "opt = paddle.optimizer.Adam(learning_rate=1e-3, parameters=m.parameters())\n"
        "ids = paddle.to_tensor(np.zeros((1, 9)), dtype='int64')\n"
        "loss = GPTPretrainingCriterion()(m(ids[:, :-1]), ids[:, 1:])\n"
        "loss.backward(); opt.step(); opt.clear_grad()\n"
        "assert isinstance(loss, paddle.Tensor) and np.isfinite(float(loss))\n"
        "with paddle.no_grad():\n"
        "    acc = (paddle.argmax(m(ids[:, :-1]), axis=-1) == ids[:, 1:]).astype('float32').mean()\n"
        "assert acc.stop_gradient and 0.0 <= float(acc) <= 1.0\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'paddle_tpu')))\n"
    )
    assert out.strip() == "[]"


# API.spec names of paddle.nn left to queue 1 item 4's remainder: none, now
# that nn/layer/rnn.py is ported (nn.quant moved to item 14)
NN_REMAINDER = set()
# paddle.vision.models names of models_extra.py, with the rest of vision/ (item 14)
VISION_LATER = {"DenseNet", "GoogLeNet", "InceptionV3", "MobileNetV1", "MobileNetV3",
                "MobileNetV3Large", "MobileNetV3Small", "ShuffleNetV2", "SqueezeNet",
                "densenet121", "densenet161", "densenet169", "densenet201", "densenet264",
                "googlenet", "inception_v3", "mobilenet_v1", "mobilenet_v3_large",
                "mobilenet_v3_small", "shufflenet_v2_swish", "shufflenet_v2_x0_25",
                "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
                "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "squeezenet1_0", "squeezenet1_1"}


def test_api_spec_surface_of_nn_and_vision_models():
    """Every ``paddle.nn.*``, ``paddle.nn.functional.*``,
    ``paddle.nn.initializer.*`` and ``paddle.vision.models`` / ``resnet`` /
    ``vgg`` name of API.spec resolves in the port, the recurrent layers
    included, but ``models_extra``'s families (item 14)."""
    names = _api_names()
    scoped = [n for n in names if n.startswith(("paddle.nn.", "paddle.vision.models."))
              or n.startswith(("paddle.vision.resnet", "paddle.vision.vgg"))
              or n in ("paddle.vision.LeNet", "paddle.vision.ResNet")]
    assert len(scoped) > 300
    missing = sorted(n.rsplit(".", 1)[1] for n in scoped if _resolve(n) is None)
    assert missing == sorted(NN_REMAINDER | VISION_LATER), missing
    assert _resolve("paddle.nn.Conv2D") is pt.nn.layer.conv.Conv2D
    assert _resolve("paddle.vision.resnet50") is pt.vision.models.resnet50
    assert _resolve("paddle.ParamAttr") is pt.nn.ParamAttr
    assert _resolve("paddle.nn.LSTM") is pt.nn.layer.rnn.LSTM
    covered = sum(_resolve(n) is not None for n in names)
    assert covered >= 732  # 461 of 1208 before the nn layers, 711 before the recurrent ones
    print(f"API.spec coverage of the port: {covered} of {len(names)} names "
          f"({covered / len(names):.1%}); nn and vision models: "
          f"{len(scoped) - len(missing)} of {len(scoped)}")


def test_nn_and_resnet_paths_load_neither_jax_nor_paddle_tpu():
    # the nn slice: a Paddle-style ResNet step through compile_train_step on
    # paddle.Tensor inputs, and the nn layers of the encoder
    out = _run(
        "import sys, numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "from paddle_tpu_torch.vision.models import resnet18\n"
        "paddle.set_device('cpu')\n"
        "m = paddle.amp.decorate(resnet18(num_classes=4), level='O2', dtype='bfloat16')\n"
        "opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,\n"
        "                                parameters=m.parameters())\n"
        "crit = paddle.nn.CrossEntropyLoss()\n"
        "step = paddle.jit.compile_train_step(m, lambda o, y: crit(o.astype('float32'), y), opt)\n"
        "x = paddle.to_tensor(np.zeros((2, 3, 32, 32), np.float32))\n"
        "loss = step(x, paddle.to_tensor(np.array([1, 2])))\n"
        "assert isinstance(loss, paddle.Tensor) and np.isfinite(float(loss))\n"
        "enc = paddle.nn.TransformerEncoder(paddle.nn.TransformerEncoderLayer(8, 2, 16), 2)\n"
        "assert enc(paddle.to_tensor(np.ones((1, 4, 8), np.float32))).shape == [1, 4, 8]\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'paddle_tpu')))\n"
    )
    assert out.strip() == "[]"


def test_api_spec_surface_of_device():
    """Every ``paddle.device.*`` name of API.spec resolves in the port
    (``paddle_tpu_torch/device``)."""
    names = [n for n in _api_names() if n.startswith("paddle.device")]
    assert len(names) >= 10
    assert [n for n in names if _resolve(n) is None] == []
    assert _resolve("paddle.device.synchronize") is pt.device.synchronize
    assert _resolve("paddle.device.cuda") is pt.device.cuda


def test_eager_dispatch_rnn_and_device_paths_load_neither_jax_nor_paddle_tpu():
    # eager dispatch: a LeNet loop under lazy dispatch, captured whole, an LSTM, a
    # beam search, paddle.device
    out = _run(
        "import sys, numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        "paddle.set_flags({'FLAGS_eager_lazy_dispatch': True})\n"
        "m = paddle.vision.models.LeNet()\n"
        "opt = paddle.optimizer.Adam(learning_rate=1e-3, parameters=m.parameters())\n"
        "crit = paddle.nn.CrossEntropyLoss()\n"
        "x = paddle.to_tensor(np.zeros((2, 1, 28, 28), np.float32))\n"
        "y = paddle.to_tensor(np.array([1, 2]))\n"
        "def step():\n"
        "    loss = crit(m(x), y); loss.backward(); opt.step(); opt.clear_grad()\n"
        "    return loss\n"
        "c = paddle.profiler.measure_programs(step, warmup=3)  # the 3rd: build pending\n"
        "assert c['programs'] == 1 and c['captured_programs'] == 1, c\n"
        "lstm = paddle.nn.LSTM(4, 3, num_layers=2, direction='bidirect')\n"
        "out, (h, cell) = lstm(paddle.to_tensor(np.ones((2, 5, 4), np.float32)))\n"
        "assert out.shape == [2, 5, 6] and h.shape == [4, 2, 3]\n"
        "dec = paddle.nn.BeamSearchDecoder(paddle.nn.GRUCell(4, 8), 0, 1, 2,\n"
        "    embedding_fn=paddle.nn.Embedding(10, 4), output_fn=paddle.nn.Linear(8, 10))\n"
        "ids, scores = paddle.nn.dynamic_decode(dec, inits=paddle.zeros([2, 8]), max_step_num=3)\n"
        "paddle.device.synchronize()\n"
        "assert paddle.device.memory_allocated() == 0 and ids.shape[:2] == [2, 2]\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'paddle_tpu')))\n"
    )
    assert out.strip() == "[]"


def test_api_spec_surface_of_linalg_autograd_and_io():
    """Every ``paddle.linalg`` and ``paddle.autograd`` name of API.spec and
    ``paddle.io.BucketSpec`` resolve; the coverage reaches 775 of 1208."""
    names = _api_names()
    scoped = [n for n in names if n.startswith(("paddle.linalg.", "paddle.autograd."))]
    assert len([n for n in scoped if n.startswith("paddle.linalg.")]) == 37
    assert [n for n in scoped if _resolve(n) is None] == []
    assert _resolve("paddle.io.BucketSpec") is pt.io.bucketing.BucketSpec
    assert _resolve("paddle.autograd.Hessian") is pt.autograd.functional.Hessian
    assert _resolve("paddle.linalg.lstsq") is pt.linalg.lstsq
    covered = sum(_resolve(n) is not None for n in names)
    assert covered >= 775
    print(f"API.spec coverage of the port: {covered} of {len(names)} names")


def test_api_spec_surface_of_io_and_utils():
    """Every ``paddle.io`` and ``paddle.utils`` name of API.spec resolves in
    the port; the coverage reaches 798 of 1208."""
    names = _api_names()
    scoped = [n for n in names if n.startswith(("paddle.io.", "paddle.utils."))]
    assert len(scoped) == 24
    assert [n for n in scoped if _resolve(n) is None] == []
    assert _resolve("paddle.io.DataLoader") is pt.io.dataloader.DataLoader
    assert _resolve("paddle.utils.run_check") is pt.utils.run_check
    covered = sum(_resolve(n) is not None for n in names)
    assert covered >= 798
    print(f"API.spec coverage of the port: {covered} of {len(names)} names")


def test_ps_io_utils_and_ernie_paths_load_neither_jax_nor_paddle_tpu(tmp_path):
    # the PS tables over the wire, SparseEmbedding, the ERNIE CTR sync and
    # pipelined loops, a forked DataLoader, paddle.utils
    out = _run(
        "import sys, numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        "from paddle_tpu_torch.distributed import ps\n"
        "from paddle_tpu_torch.examples import ernie_ctr as ec\n"
        "s = ps.PsServer(port=0)\n"
        "c = ps.PsClient([f'127.0.0.1:{s.port}'])\n"
        "t = ps.DistributedSparseTable(c, 1, 4)\n"
        "assert t.pull(np.arange(3)).shape == (3, 4)\n"
        "c.stop_servers()\n"
        "emb = ps.SparseEmbedding([10, 4])\n"
        "emb(paddle.to_tensor(np.array([[1, 2]]))).sum().backward()\n"
        "cfg = ec.ErnieCtrConfig(vocab_size=50, hidden=16, layers=1, heads=2, seq_len=8,\n"
        "                        slots=2, sparse_dim=4)\n"
        "table, model, step = ec.build(cfg)\n"
        "b = ec.synthetic_batch(cfg, 4, np.random.default_rng(0))\n"
        "assert np.isfinite(ec.train_step(table, step, cfg, *b))\n"
        "assert all(np.isfinite(ec.train_pipelined(table, step, cfg, [b, b])))\n"
        "loader = paddle.io.DataLoader(np.arange(8, dtype=np.float32), batch_size=4,\n"
        "                              num_workers=2, timeout=60)\n"
        "assert [x.shape for x in loader] == [[4], [4]]\n"
        "paddle.utils.require_version('0.1.0')\n"
        "paddle.utils.run_check()\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'paddle_tpu')))\n"
    )
    assert out.strip().splitlines()[-1] == "[]"


def test_utils_surface():
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        pt.utils.cpp_extension.load("x", [], ops=["relu"])
    with pytest.raises(RuntimeError, match="required"):
        pt.utils.require_version("99.0")
    assert pt.utils.try_import("no_such_module_here") is None
    assert pt.utils.try_import("json") is not None

    @pt.utils.deprecated(update_to="paddle.new", since="2.0")
    def old(x):
        return x + 1

    with pytest.warns(DeprecationWarning, match="paddle.new"):
        assert old(1) == 2


# API.spec names of paddle.static.analysis the port's ``analysis`` package
# carries (ROADMAP queue 1 item 12a); the rest of the analysis names are
# item 12b (passes, the remat plan, equivalence, donation safety) and
# item 13 (sharding)
ANALYSIS_PORTED = {
    "Diagnostic", "ProgramVerificationError", "Severity", "check", "enforce", "pass_names",
    "register_pass", "run_passes", "memory.Buffer", "memory.MemoryPlan",
    "memory.captured_step_plans", "memory.device_hbm_bytes", "memory.plan_memory",
    # item 12b: the prover, donation safety, the block pool, the two checks
    "check_launch_budget", "check_pending_segment",
    "equivalence.CanonicalProgram", "equivalence.EquivalenceCertificate",
    "equivalence.canonicalize", "equivalence.certify_callables", "equivalence.program_diff",
    "equivalence.prove_equivalent",
    "memory.BlockPoolPlan", "memory.plan_block_pool", "memory.tensor_aliases",
    "memory.donated_buffer_alias_diags", "memory.donated_buffer_diags",
    "memory.donation_gate", "memory.traced_program_diags",
}


def test_api_spec_surface_of_profiler_and_analysis():
    """Every ``paddle.profiler`` name of API.spec resolves in the port (10
    new at the top, attribution 19, diag 10, sentinel 10, metrics 7 new),
    and the ported ``paddle.static.analysis`` names resolve through the
    port's ``analysis`` package: all 28 but the 13 of ``analysis.sharding``
    (item 13) since item 12b; the coverage reaches 854 of 1208, plus those
    28."""
    names = _api_names()
    scoped = [n for n in names if n.startswith("paddle.profiler.")]
    assert [n for n in scoped if _resolve(n) is None] == []
    for sub, count in (("attribution", 19), ("diag", 10), ("sentinel", 10), ("metrics", 10),
                       ("trace", 12)):
        assert len([n for n in scoped if n.startswith(f"paddle.profiler.{sub}.")]) == count
    assert _resolve("paddle.profiler.Profiler") is pt.profiler.Profiler
    assert _resolve("paddle.profiler.sentinel.PerfSentinel") is pt.profiler.sentinel.PerfSentinel
    analysis = [n[len("paddle.static.analysis."):] for n in names
                if n.startswith("paddle.static.analysis.")]
    assert len(analysis) == 41
    import importlib

    for name in analysis:
        mod, _, attr = ("." + name).rpartition(".")
        try:
            found = hasattr(importlib.import_module("paddle_tpu_torch.analysis" + mod), attr)
        except ModuleNotFoundError:  # sharding (item 13)
            found = False
        assert found == (name in ANALYSIS_PORTED), name
    assert len(ANALYSIS_PORTED) == 28
    assert [n for n in analysis if n not in ANALYSIS_PORTED
            and not n.startswith("sharding.")] == []
    covered = sum(_resolve(n) is not None for n in names)
    assert covered >= 854
    print(f"API.spec coverage of the port: {covered} of {len(names)} names "
          f"(+ {len(ANALYSIS_PORTED)} paddle.static.analysis names in its analysis package)")


def test_ops_plane_path_loads_neither_jax_nor_paddle_tpu(tmp_path):
    # the profiler session and export, the diag server, the sentinel, the
    # fused telemetry and the static profile of a captured step
    out = _run(
        "import sys, json, urllib.request, numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "from paddle_tpu_torch import profiler\n"
        "paddle.set_device('cpu')\n"
        "paddle.set_flags({'FLAGS_telemetry': True, 'FLAGS_sentinel_pct': 30.0,\n"
        "                  'FLAGS_eager_lazy_dispatch': True})\n"
        "addr = profiler.diag.start(port=0)\n"
        "m = paddle.nn.Linear(4, 2)\n"
        "opt = paddle.optimizer.Adam(parameters=m.parameters())\n"
        f"p = profiler.Profiler(on_trace_ready=profiler.export_chrome_tracing({str(tmp_path)!r}))\n"
        "with p:\n"
        "    for _ in range(4):\n"
        "        with profiler.RecordEvent('step'):\n"
        "            m(paddle.ones([3, 4])).sum().backward(); opt.step(); opt.clear_grad()\n"
        "        p.step()\n"
        "assert urllib.request.urlopen(f'http://{addr}/metrics').status == 200\n"
        "assert profiler.attribution.telemetry_state()['steps'] == 4\n"
        "assert any(k.startswith('captured:') for k in profiler.program_costs())\n"
        "profiler.diag.stop()\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'paddle_tpu')))\n"
    )
    assert out.strip().splitlines()[-1] == "[]"
