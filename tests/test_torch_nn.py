"""``paddle.nn`` of the port against the JAX package's, on the CPU: dropout's
two modes and ``nn.Layer``'s state methods.

Dropout is elementwise, so eval outputs are compared bit for bit; in
training the masks come from different generators, so each package's
output is held to its mode's rule instead.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF

MODES = ["upscale_in_train", "downscale_in_infer"]


def _x():
    return np.random.default_rng(0).standard_normal((4, 33)).astype(np.float32) * 3


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [0.0, 0.25, 0.6])
@pytest.mark.parametrize("api", ["functional", "layer"])
def test_dropout_eval_matches_jax_bitwise(mode, p, api):
    x = _x()
    if api == "functional":
        want = JF.dropout(paddle.to_tensor(x), p=p, training=False, mode=mode).numpy()
        got = TF.dropout(torch.from_numpy(x), p=p, training=False, mode=mode).numpy()
    else:
        want = paddle.nn.Dropout(p, mode=mode).eval()(paddle.to_tensor(x)).numpy()
        got = pt.nn.Dropout(p, mode=mode).eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    if mode == "downscale_in_infer" and p > 0:
        np.testing.assert_array_equal(got, x * np.float32(1 - p))


def test_dropout_eval_downscale_is_the_observed_fault():
    """x = 1..6, p = 0.25: the JAX package gives 0.75 x; the port gave x."""
    x = np.arange(1, 7, dtype=np.float32)
    want = JF.dropout(paddle.to_tensor(x), p=0.25, training=False,
                      mode="downscale_in_infer").numpy()
    np.testing.assert_array_equal(want, [0.75, 1.5, 2.25, 3.0, 3.75, 4.5])
    got = TF.dropout(torch.from_numpy(x), p=0.25, training=False, mode="downscale_in_infer")
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("mode", MODES)
def test_dropout_train_masks_by_mode(mode):
    """downscale_in_infer masks without rescaling: every kept entry is x
    exactly, every other one 0; upscale_in_train divides the kept ones by
    1 - p. The JAX package's output obeys the same rule."""
    p = 0.4
    x = _x() + 10.0  # no zeros: a 0 in the output is a dropped entry
    pt.seed(3)
    layer = pt.nn.Dropout(p, mode=mode)
    layer.train()
    got = layer(torch.from_numpy(x)).numpy()
    jgot = JF.dropout(paddle.to_tensor(x), p=p, training=True, mode=mode).numpy()
    for out in (got, jgot):
        kept = out != 0
        assert 0 < kept.mean() < 1
        scale = np.float32(1 - p) if mode == "upscale_in_train" else None
        want = x / scale if scale is not None else x
        if scale is not None:  # the port divides in torch, the JAX package in XLA
            np.testing.assert_allclose(out[kept], want[kept], rtol=1e-6)
        else:
            assert out[kept].tobytes() == want[kept].tobytes()
    expected = torch.from_numpy(x) / (1 - p) if mode == "upscale_in_train" else torch.from_numpy(x)
    kept = got != 0
    assert got[kept].tobytes() == expected.numpy()[kept].tobytes()


def _linear_pair():
    paddle.seed(0)
    jl = paddle.nn.Linear(4, 3)
    tl = pt.nn.Linear(4, 3, device="cpu")
    return jl, tl


def test_layer_set_state_dict_matches_jax():
    """set_state_dict copies in place and returns (missing, unexpected) as
    the JAX Layer does; numpy values, tensors of another dtype and the
    aliases set_dict / load_dict all load."""
    jl, tl = _linear_pair()
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    sd = {"weight": w, "extra": np.zeros(2, np.float32)}
    assert tl.set_state_dict(sd) == jl.set_state_dict(sd) == (["bias"], ["extra"])
    np.testing.assert_array_equal(tl.weight.detach().numpy(), jl.weight.numpy())

    weight = tl.weight
    ptr = weight.data_ptr()
    tl.set_dict({"weight": torch.from_numpy(w * 2).double(), "bias": np.ones(3)})
    assert tl.weight is weight and weight.data_ptr() == ptr
    assert weight.dtype == torch.float32
    np.testing.assert_array_equal(weight.detach().numpy(), w * 2)
    np.testing.assert_array_equal(tl.bias.detach().numpy(), np.ones(3, np.float32))
    assert tl.load_dict(jl.state_dict()) == ([], [])  # JAX tensors through numpy
    np.testing.assert_array_equal(tl.weight.detach().numpy(), w)


def test_layer_set_state_dict_shape_mismatch_raises_and_loads_nothing():
    jl, tl = _linear_pair()
    before = tl.weight.detach().clone()
    bad = {"weight": np.zeros((3, 4), np.float32), "bias": np.full(3, 7.0, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        jl.set_state_dict(bad)
    with pytest.raises(ValueError, match="weight has shape"):
        tl.set_state_dict(bad)
    assert torch.equal(tl.weight, before) and not bool((tl.bias == 7).any())


def test_port_layers_are_paddle_layers():
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mp
    from paddle_tpu_torch.models import gpt as tgpt

    model = tgpt.GPTForPretraining(tgpt.GPTConfig(vocab_size=32, hidden_size=16, num_layers=1,
                                                  num_heads=2, max_seq_len=16), device="cpu")
    layers = [m for m in model.modules() if not isinstance(m, torch.nn.ModuleList)]
    assert layers and all(isinstance(m, pt.nn.Layer) for m in layers)
    assert any(isinstance(m, mp.ColumnParallelLinear) for m in layers)
    for cls in (pt.nn.Linear, pt.nn.Embedding, pt.nn.Dropout, pt.nn.LayerNorm,
                tgpt.GPTPretrainingCriterion):
        assert issubclass(cls, pt.nn.Layer)
    # torch's state_dict is the one: the names equal the JAX model's
    assert pt.nn.Layer.state_dict is torch.nn.Module.state_dict
