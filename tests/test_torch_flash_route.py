"""Which flash-attention kernel a launch takes: ``sm90_eligible`` and
``tf32x3_eligible``.

The forward, dK/dV and dQ have three kernels each on the card: the sm90
route (wgmma, fed by TMA) for bf16 and fp16 inputs that TMA can read, the
tf32x3 route (mma.sync in 3xTF32, fed by TMA) for f32 inputs that TMA can
read, and the SIMT route (f32 FMAs on the CUDA cores) for every other
input. The eligibility functions decide from the tensors'
metadata alone, so these tests run on the CPU; the card tests
(tests/test_torch_cuda_kernels.py) check that each launch took the route it
names.
"""
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as tfa

DTYPES = [torch.bfloat16, torch.float16]


def _fused_qkv(b, s, h, d, dtype):
    """q, k, v as ``models/gpt.py`` makes them: views of one [b, s, h·3·d]
    projection, split heads-major as [b, s, h, 3, d]."""
    qkv = torch.empty(b, s, 3 * h * d, dtype=dtype)
    return qkv.reshape(b, s, h, 3, d).unbind(dim=3)


def _offset_view(shape, dtype, offset):
    """A contiguous [b, s, h, d] view ``offset`` elements into its storage."""
    n = 1
    for x in shape:
        n *= x
    return torch.empty(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [4, 8])
def test_sm90_takes_the_345m_fused_qkv_views(batch, dtype):
    q, k, v = _fused_qkv(batch, 1024, 16, 64, dtype)
    assert q.stride() == (1024 * 3 * 16 * 64, 3 * 16 * 64, 3 * 64, 1)
    assert (k.data_ptr() - q.data_ptr(), v.data_ptr() - q.data_ptr()) == (128, 256)
    do = torch.empty(batch, 1024, 16, 64, dtype=dtype)
    assert tfa.sm90_eligible((q, k, v))
    assert tfa.sm90_eligible((q, k, v, do))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
def test_sm90_takes_every_multiple_of_16_up_to_128(d, dtype):
    x = torch.empty(2, 100, 3, d, dtype=dtype)
    assert tfa.sm90_eligible((x, x, x, x))


def test_sm90_refuses_float32():
    x = torch.empty(1, 128, 2, 64)
    assert not tfa.sm90_eligible((x, x, x))


@pytest.mark.parametrize("d", [5, 24, 40, 256])
def test_sm90_refuses_a_head_dim_it_has_no_tile_for(d):
    x = torch.empty(1, 128, 2, d, dtype=torch.bfloat16)
    assert not tfa.sm90_eligible((x, x, x))


@pytest.mark.parametrize("strides", [
    (128 * 128 + 4, 128, 64, 1),  # batch
    (128 * 132, 132, 64, 1),  # sequence: rows padded by 4 elements
    (128 * 136, 136, 68, 1),  # head: heads padded by 4 elements
])
def test_sm90_refuses_a_stride_that_is_not_a_multiple_of_8(strides):
    shape = (2, 128, 2, 64)
    x = torch.empty(2 * 128 * 136, dtype=torch.bfloat16).as_strided(shape, strides)
    q = torch.empty(shape, dtype=torch.bfloat16)
    assert tfa.sm90_eligible((q, q, q))
    assert not tfa.sm90_eligible((q, x, q))


def test_sm90_refuses_a_head_dim_stride_other_than_1():
    x = torch.empty(1, 128, 2, 128, dtype=torch.bfloat16)[..., ::2]
    assert x.shape[-1] == 64 and x.stride(-1) == 2
    assert not tfa.sm90_eligible((x, x, x))


def test_sm90_refuses_a_base_two_bytes_off_16_byte_alignment():
    shape = (1, 128, 2, 64)
    q = _offset_view(shape, torch.bfloat16, 0)
    k = _offset_view(shape, torch.bfloat16, 1)
    assert q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 2
    assert tfa.sm90_eligible((q, q, q))
    assert not tfa.sm90_eligible((q, k, q))


def test_sm90_refuses_a_stride_0_do():
    q = torch.empty(2, 128, 2, 64, dtype=torch.bfloat16)
    everywhere = torch.ones((), dtype=torch.bfloat16).expand(q.shape)  # d(sum)/dO
    per_batch = torch.ones(1, 128, 2, 64, dtype=torch.bfloat16).expand(q.shape)
    assert everywhere.stride() == (0, 0, 0, 0) and per_batch.stride(0) == 0
    assert tfa.sm90_eligible((q, q, q, q))
    assert not tfa.sm90_eligible((q, q, q, everywhere))
    assert not tfa.sm90_eligible((q, q, q, per_batch))


def test_sm90_refuses_mixed_dtypes():
    q = torch.empty(1, 128, 2, 64, dtype=torch.bfloat16)
    assert not tfa.sm90_eligible((q, q, q, q.half()))


def test_the_stride_of_a_size_1_dim_is_not_read():
    x = torch.empty(1, 128, 1, 64, dtype=torch.bfloat16).as_strided(
        (1, 128, 1, 64), (3, 64, 5, 1))
    assert tfa.sm90_eligible((x, x, x))


@pytest.mark.parametrize("batch", [1, 8])
def test_tf32x3_takes_the_345m_f32_fused_qkv_views(batch):
    q, k, v = _fused_qkv(batch, 1024, 16, 64, torch.float32)
    assert q.stride() == (1024 * 3 * 16 * 64, 3 * 16 * 64, 3 * 64, 1)
    assert (k.data_ptr() - q.data_ptr(), v.data_ptr() - q.data_ptr()) == (256, 512)
    do = torch.empty(batch, 1024, 16, 64)
    assert tfa.tf32x3_eligible((q, k, v, do))
    assert not tfa.sm90_eligible((q, k, v, do))


@pytest.mark.parametrize("d", [8 * i for i in range(1, 17)])
def test_tf32x3_takes_every_multiple_of_8_up_to_128(d):
    x = torch.empty(2, 100, 3, d)
    assert tfa.tf32x3_eligible((x, x, x, x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_tf32x3_refuses_16_bit_types(dtype):
    x = torch.empty(1, 128, 2, 64, dtype=dtype)
    assert not tfa.tf32x3_eligible((x, x, x, x))


@pytest.mark.parametrize("d", [4, 5, 12, 20, 100, 136, 160, 256])
def test_tf32x3_refuses_a_head_dim_it_has_no_tile_for(d):
    x = torch.empty(1, 128, 2, d)
    assert not tfa.tf32x3_eligible((x, x, x, x))


@pytest.mark.parametrize("strides", [
    (128 * 128 + 2, 128, 64, 1),  # batch
    (128 * 130, 130, 64, 1),  # sequence: rows padded by 2 elements
    (128 * 132, 132, 66, 1),  # head: heads padded by 2 elements
])
def test_tf32x3_refuses_a_stride_that_is_not_a_multiple_of_4(strides):
    shape = (2, 128, 2, 64)
    x = torch.empty(2 * 128 * 136).as_strided(shape, strides)
    q = torch.empty(shape)
    assert tfa.tf32x3_eligible((q, q, q, q))
    assert not tfa.tf32x3_eligible((q, x, q, q))


def test_tf32x3_takes_a_stride_that_is_a_multiple_of_4_but_not_of_8():
    shape = (2, 128, 2, 64)
    x = torch.empty(2 * 128 * 132).as_strided(shape, (128 * 132, 132, 64, 1))
    assert tfa.tf32x3_eligible((x, x, x, x))


def test_tf32x3_refuses_a_head_dim_stride_other_than_1():
    x = torch.empty(1, 128, 2, 128)[..., ::2]
    assert x.shape[-1] == 64 and x.stride(-1) == 2
    assert not tfa.tf32x3_eligible((x, x, x, x))


def test_tf32x3_refuses_a_base_four_bytes_off_16_byte_alignment():
    shape = (1, 128, 2, 64)
    q = _offset_view(shape, torch.float32, 0)
    k = _offset_view(shape, torch.float32, 1)
    assert q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 4
    assert tfa.tf32x3_eligible((q, q, q, q))
    assert not tfa.tf32x3_eligible((q, k, q, q))


def test_tf32x3_refuses_mixed_dtypes():
    q = torch.empty(1, 128, 2, 64)
    assert not tfa.tf32x3_eligible((q, q, q, q.double()))
    assert not tfa.tf32x3_eligible((q, q, q, q.bfloat16()))


WRAPPERS = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dkv, tfa.flash_attention_bwd_dq)


def test_every_route_has_a_counter():
    for fn in WRAPPERS:
        assert set(fn.launches_by_route) == set(tfa.ROUTES) == {"sm90", "tf32x3", "simt"}


class _ReportsCard:
    """A CPU tensor that reports a CUDA device, so a wrapper picks a route
    for it; every other attribute is the tensor's."""

    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _routes_taken(monkeypatch, q, k, v, do):
    """The route each backward wrapper hands its launcher for (q, k, v, dO),
    with the launchers replaced by recorders: nothing is built or launched."""
    taken = {}

    def recorder(name):
        def launch(*args):
            taken[name] = args[-1]
        return launch

    monkeypatch.setattr(tfa, "_bwd_dkv_cuda", recorder("dkv"))
    monkeypatch.setattr(tfa, "_bwd_dq_cuda", recorder("dq"))
    q, k, v, do = (_ReportsCard(t) for t in (q, k, v, do))
    tfa.flash_attention_bwd_dkv(q, k, v, do, None, None, 0.125, True)
    tfa.flash_attention_bwd_dq(q, k, v, do, None, None, 0.125, True)
    return taken


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "sm90"), (torch.float16, "sm90"),
                                         (torch.float32, "tf32x3")])
def test_dq_and_dkv_take_one_route_for_the_345m_fused_qkv_views(monkeypatch, dtype, route):
    q, k, v = _fused_qkv(8, 1024, 16, 64, dtype)
    do = torch.empty(8, 1024, 16, 64, dtype=dtype)
    assert _routes_taken(monkeypatch, q, k, v, do) == {"dkv": route, "dq": route}


def test_dq_and_dkv_take_simt_for_an_f32_head_dim_over_128(monkeypatch):
    q, k, v = _fused_qkv(1, 200, 2, 160, torch.float32)
    do = torch.empty(1, 200, 2, 160)
    assert _routes_taken(monkeypatch, q, k, v, do) == {"dkv": "simt", "dq": "simt"}


def test_dq_and_dkv_take_simt_when_an_f32_do_is_refused(monkeypatch):
    q, k, v = _fused_qkv(2, 128, 2, 64, torch.float32)
    do = torch.ones(()).expand(q.shape)  # stride 0: not TMA's
    assert _routes_taken(monkeypatch, q, k, v, do) == {"dkv": "simt", "dq": "simt"}


def test_a_route_without_that_kernel_raises_before_any_build(monkeypatch):
    def no_build(*args):
        raise AssertionError("nothing may be built")

    monkeypatch.setattr(tfa, "_bind", no_build)
    x = torch.empty(1, 64, 1, 64)
    with pytest.raises(ValueError, match="no kernel on route 'tf32'"):
        tfa._fwd_cuda(x, x, x, 0.125, True, "tf32")
    with pytest.raises(ValueError, match="no kernel on route 'wgmma'"):
        tfa._bwd_dq_cuda(x, x, x, x, torch.empty(1, 1, 64), torch.empty(1, 1, 64), 0.125, True,
                         "wgmma")


def _fwd_route_taken(monkeypatch, q, k, v):
    """The route the forward wrapper hands its launcher for (q, k, v), with
    the launcher replaced by a recorder: nothing is built or launched."""
    taken = []
    monkeypatch.setattr(tfa, "_fwd_cuda", lambda *args: taken.append(args[-1]))
    tfa.flash_attention_fwd(*(_ReportsCard(t) for t in (q, k, v)), 0.125, True)
    (route,) = taken
    return route


@pytest.mark.parametrize("batch", [4, 8])
def test_the_forward_takes_tf32x3_for_the_345m_f32_fused_qkv_views(monkeypatch, batch):
    q, k, v = _fused_qkv(batch, 1024, 16, 64, torch.float32)
    do = torch.empty(batch, 1024, 16, 64)
    assert _fwd_route_taken(monkeypatch, q, k, v) == "tf32x3"
    assert _routes_taken(monkeypatch, q, k, v, do) == {"dkv": "tf32x3", "dq": "tf32x3"}


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_forward_takes_sm90_for_the_345m_16_bit_fused_qkv_views(monkeypatch, dtype):
    q, k, v = _fused_qkv(4, 1024, 16, 64, dtype)
    assert _fwd_route_taken(monkeypatch, q, k, v) == "sm90"


@pytest.mark.parametrize("make", [
    lambda: _fused_qkv(1, 200, 2, 160, torch.float32),  # f32, D > 128
    lambda: _fused_qkv(1, 7, 1, 5, torch.float32),  # f32, D not a multiple of 8
    lambda: _fused_qkv(1, 128, 2, 24, torch.bfloat16),  # bf16, D not a multiple of 16
    lambda: (torch.empty(2, 128, 2, 64),) * 2 + (torch.ones(()).expand(2, 128, 2, 64),),
], ids=["f32-d160", "f32-d5", "bf16-d24", "f32-stride0-v"])
def test_the_forward_takes_simt_for_what_the_tensor_core_routes_refuse(monkeypatch, make):
    q, k, v = make()
    assert not tfa.sm90_eligible((q, k, v)) and not tfa.tf32x3_eligible((q, k, v))
    assert _fwd_route_taken(monkeypatch, q, k, v) == "simt"


def test_dq_and_dkv_take_one_route_when_do_is_refused(monkeypatch):
    q, k, v = _fused_qkv(2, 128, 2, 64, torch.bfloat16)
    do = torch.ones((), dtype=torch.bfloat16).expand(q.shape)  # stride 0: not TMA's
    assert _routes_taken(monkeypatch, q, k, v, do) == {"dkv": "simt", "dq": "simt"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_calls_count_no_launch_on_either_route(dtype):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 2, 16, generator=gen).to(dtype).requires_grad_()
               for _ in range(3))
    before = [(fn.launches, dict(fn.launches_by_route)) for fn in WRAPPERS]
    o, lse = tfa.flash_attention_fwd(q, k, v, 0.25, True)
    do = torch.randn(o.shape, generator=gen).to(dtype)
    delta = tfa.bwd_delta(o, do)
    tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, 0.25, True)
    tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, 0.25, True)
    out = tfa.flash_attention(q, k, v, causal=True)
    torch.autograd.grad(out.float().sum(), (q, k, v))
    after = [(fn.launches, dict(fn.launches_by_route)) for fn in WRAPPERS]
    assert after == before
