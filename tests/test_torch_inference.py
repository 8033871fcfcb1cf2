"""The port's ``inference`` module (``paddle_tpu_torch.inference``) against the
JAX package's, on the CPU.

The tiny GPT of ``tests/test_torch_serving.py`` (vocab 64, hidden 32, 2
layers, 2 heads, max_seq_len 32, ``initializer_range=0.2`` so greedy tokens
depend on context) is made in the JAX package from seed 7 and carried into
the port by ``convert.state_dict_from_numpy``. A generative predictor of each
package serves the same prompts: the tokens are equal, and equal to the
port's ``generate()``. The PredictorPool, lens and deprecation tests are
ports of ``tests/test_serving_overload.py``'s and ``tests/test_serving.py``'s.
"""
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu.core.lazy import reset_serve_programs as jreset_serve_programs
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForPretraining as JGPTForPretraining
import paddle_tpu_torch as pt
from paddle_tpu_torch import inference
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.core import lazy
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

VOCAB = 64
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2, max_seq_len=32,
           dropout=0.0, attn_dropout=0.0, initializer_range=0.2)
SERVE = dict(block_size=8, prompt_buckets=[8], num_blocks=16, max_new_tokens=3)


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JGPTForPretraining(JGPTConfig(**CFG))
    jm.eval()
    tm = GPTForPretraining(GPTConfig(**CFG), device="cpu").eval()
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture
def model(models):
    return models[1]


@pytest.fixture(autouse=True)
def _isolation():
    yield
    pt.set_flags({"FLAGS_memory_budget_mb": 0.0})
    lazy.reset_serve_programs()


def cpu_config(model, **opts):
    config = inference.Config()
    config.disable_gpu()  # the tiny model lives on the CPU
    config.enable_generative_serving(model, **(opts or SERVE))
    return config


def _generate(model, ids, n):
    return model.generate(np.asarray(ids, np.int64), max_new_tokens=n).numpy()[:, ids.shape[1]:]


def test_generative_predictor_routes_to_serving(model):
    config = cpu_config(model, block_size=8, prompt_buckets=[8], num_blocks=16,
                        max_new_tokens=5)
    pred = inference.create_predictor(config)
    assert isinstance(pred, inference.GenerativePredictor)
    ids = np.random.default_rng(0).integers(1, VOCAB, (2, 8))
    (out,) = pred.run([ids])
    assert out.shape == (2, 5)
    assert out.tolist() == _generate(model, ids, 5).tolist()
    assert pred.engine.stats()["completed"] == 2
    # the handle surface: the output handle holds the same tokens
    assert pred.get_output_handle("tokens").copy_to_cpu().tolist() == out.tolist()
    assert pred.get_input_names() == ["input_ids", "prompt_lens"]
    assert pred.get_output_names() == ["tokens"]


def test_generative_predictor_matches_jax(models):
    jm, tm = models
    ids = np.random.default_rng(4).integers(1, VOCAB, (3, 8))
    lens = np.asarray([8, 5, 7])
    jconfig = jinference.Config()
    jconfig.enable_generative_serving(jm, **SERVE)
    try:
        jpred = jinference.create_predictor(jconfig)
        (want,) = jpred.run([ids, lens])
        jpred.engine.close()
    finally:
        jreset_serve_programs()
    (got,) = inference.create_predictor(cpu_config(tm)).run([ids, lens])
    assert got.tolist() == want.tolist()


def test_generative_predictor_handles_api(model):
    pred = inference.create_predictor(cpu_config(model))
    ids = np.random.default_rng(1).integers(1, VOCAB, (2, 8))
    pred.get_input_handle("input_ids").copy_from_cpu(ids)
    pred.get_input_handle("prompt_lens").copy_from_cpu(np.asarray([8, 4]))
    assert pred.run() is True
    out = pred.get_output_handle("tokens")
    assert out.shape() == [2, 3] and out.type() == "torch.int64"
    want0 = _generate(model, ids[:1], 3)[0]
    want1 = _generate(model, ids[1:, :4], 3)[0]
    assert out.copy_to_cpu().tolist() == [want0.tolist(), want1.tolist()]


def test_generative_predictor_lens_not_stale(model):
    pred = inference.create_predictor(cpu_config(
        model, block_size=8, prompt_buckets=[8], num_blocks=32, max_new_tokens=3))
    rng = np.random.default_rng(0)
    ids2 = rng.integers(1, VOCAB, (2, 8))
    pred.run([ids2, np.asarray([5, 6])])
    # a later list-style call WITHOUT lens must not inherit the stale
    # 2-element prompt_lens handle (here the batch is 3)
    ids3 = rng.integers(1, VOCAB, (3, 8))
    (out,) = pred.run([ids3])
    assert out.shape == (3, 3)
    # and an explicitly mismatched lens fails loud
    pred.get_input_handle("prompt_lens").copy_from_cpu(np.asarray([4]))
    pred.get_input_handle("input_ids").copy_from_cpu(ids2)
    with pytest.raises(ValueError, match="batch"):
        pred.run()
    pred.get_input_handle("prompt_lens").copy_from_cpu(np.asarray([0, 9]))
    with pytest.raises(ValueError, match="prompt_lens entries"):
        pred.run()


def test_tensorrt_mkldnn_knobs_deprecation_warn():
    config = inference.Config()
    with pytest.warns(DeprecationWarning):
        config.enable_tensorrt_engine()
    with pytest.warns(DeprecationWarning):
        config.enable_mkldnn()


def test_config_device_toggles_map_onto_the_card():
    config = inference.Config()
    assert config.use_gpu() and config.gpu_device_id() == 0
    config.disable_gpu()
    assert not config.use_gpu()
    config.enable_use_gpu(100, device_id=1)
    assert config.use_gpu() and config.gpu_device_id() == 1
    config.set_model("/m/net.pdmodel", "/m/net.pdparams")
    assert config.model_dir() == "/m/net" and config.prog_file() == "/m/net.stablehlo"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        config.set_model("/m/a.pdmodel", "/m/b.pdparams")
    assert any("differs" in str(w.message) for w in caught)
    assert "memory_optim=True" in config.summary()


def test_predictor_serves_on_its_models_device_only(model):
    config = inference.Config()  # asks for the card
    config.enable_generative_serving(model, **SERVE)
    with pytest.raises(ValueError, match="does not move the model"):
        inference.create_predictor(config)

    class OnTheCard:  # a stand-in whose parameters live on the card
        def parameters(self):
            yield SimpleNamespace(device=torch.device("cuda", 0))

    card = OnTheCard()
    cpu = inference.Config()
    cpu.disable_gpu()
    cpu.enable_generative_serving(card, **SERVE)
    with pytest.raises(ValueError, match="asks for the CPU"):
        inference.create_predictor(cpu)
    assert next(model.parameters()).device.type == "cpu"  # nothing moved


def test_artifact_predictor_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        inference.create_predictor(inference.Config("/m/net"))
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        inference.Predictor(inference.Config("/m/net"))


@pytest.mark.parametrize("memory_optim", [True, False])
def test_memory_optim_and_the_budget(model, memory_optim):
    pt.set_flags({"FLAGS_memory_budget_mb": 3.0})
    config = cpu_config(model, block_size=8, prompt_buckets=[8], max_new_tokens=3)
    config.enable_memory_optim(memory_optim)
    if memory_optim:  # a budget-sized pool needs the memory planner
        with pytest.raises(NotImplementedError, match="queue 1 item 12"):
            inference.create_predictor(config)
    else:
        assert inference.create_predictor(config).engine._pool.num_blocks == 256


def test_predictor_pool_routes_around_unhealthy(model):
    pool = inference.PredictorPool(cpu_config(model), size=2, clone=False)
    a, b = pool.retrieve(0), pool.retrieve(1)
    assert a.engine is not b.engine  # independent replicas
    assert pool.acquire() in (a, b)
    a.engine.begin_drain()  # replica a goes unhealthy
    for _ in range(4):
        assert pool.acquire() is b  # traffic routes around it
    assert pool.healths() == ["draining", "warming"]
    b.engine.fail_clean(RuntimeError("dead too"))
    with pytest.raises(RuntimeError, match="no serviceable"):
        pool.acquire()
    # degraded replicas are last-resort but still serve
    a.engine._draining = False
    a.engine._health = "degraded"
    assert pool.acquire() is a


def test_predictor_pool_round_robins_degraded_fleet(model):
    pool = inference.PredictorPool(cpu_config(model), size=3, clone=False)
    for i in range(3):
        pool.retrieve(i).engine._health = "degraded"
    picks = [pool.acquire() for _ in range(6)]
    assert {id(p) for p in picks} == {id(pool.retrieve(i)) for i in range(3)}
    assert len(pool) == 3


def test_predictor_pool_clone_contract_unchanged(model):
    pool = inference.PredictorPool(cpu_config(model), size=2)  # default: clones
    assert pool.retrieve(0).engine is pool.retrieve(1).engine
    assert pool.retrieve(0).get_input_handle("input_ids") is not \
        pool.retrieve(1).get_input_handle("input_ids")
    with pytest.raises(ValueError, match="size"):
        inference.PredictorPool(cpu_config(model), size=0)


def test_tensor_handles_and_data_types():
    h = inference.Tensor("x", np.float32)
    with pytest.raises(RuntimeError, match="no data"):
        h.copy_to_cpu()
    h.reshape([2, 3])
    assert h.shape() == [2, 3] and h.name() == "x"
    h.copy_from_cpu(np.arange(6, dtype=np.float64).reshape(2, 3))
    assert h.copy_to_cpu().dtype == np.float32 and h.shape() == [2, 3]
    t = torch.ones(4)
    h.share_external_data(t)
    assert h._value is t  # no copy
    assert [inference.get_num_bytes_of_data_type(d) for d in (
        inference.DataType.FLOAT32, inference.DataType.FLOAT16, inference.DataType.INT64,
        inference.DataType.BOOL)] == [4, 2, 8, 1]
    assert "PyTorch" in inference.get_version()
    assert inference.PrecisionType.Bfloat16 == jinference.PrecisionType.Bfloat16
    assert (inference.PlaceType.kCPU, inference.PlaceType.kGPU) == (
        jinference.PlaceType.kCPU, jinference.PlaceType.kGPU)
