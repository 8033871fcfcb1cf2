"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and nvcc: the kernels have no CPU mode. They
skip elsewhere. This file imports neither jax nor paddle_tpu, so it runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerances are tests/test_flash_attention.py's: on O and on lse 2e-5 in f32
and 3e-2 in the 16-bit types; on the gradients 2e-3 in f32 and 3e-2 in the
16-bit types. The backward kernels sum without atomics, so a second backward
on the same input must give bitwise-equal gradients. The fused-update
kernels are held to their plain versions bit for bit, the reference's own
contract for kernel against rule (tests/test_pallas_update.py). The flash
forward, dK/dV and dQ cases check the route each launch took: the sm90
(wgmma) kernels for bf16 and fp16 inputs TMA can read, the tf32x3 (3xTF32
mma.sync) kernels for f32 inputs TMA can read, the SIMT kernels otherwise.
The flash forward sums without atomics too: a second forward is bitwise
equal. The training-path cases capture steps with dropout and recompute
(each replay draws new masks; a replay's recomputations draw its
forwards' masks, held against an eager step drawing from the same
generator states) and run an O1 fp16 step with a GradScaler on the sm90
kernels. A checkpoint restored into a captured step lands in the tensors
the graph reads.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import fused_update as tfu

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2, torch.float16: 3e-2}
GRAD_TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2, torch.float16: 3e-2}
BWD_CASES = [
    ((2, 128, 4, 64), True, torch.float32, False),
    ((1, 128, 2, 32), False, torch.float32, False),
    ((1, 600, 2, 24), True, torch.float32, True),
    ((2, 128, 4, 64), True, torch.bfloat16, True),
    ((2, 128, 4, 64), True, torch.float16, False),
    ((8, 1024, 16, 64), True, torch.bfloat16, True),  # the 345M training step's shape
    ((1, 200, 2, 160), True, torch.float32, False),  # two 128-wide output slices
    ((1, 7, 1, 5), True, torch.float32, False),  # shorter than one tile
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _qkv(shape, dtype, fused, seed):
    """q, k, v on the card; ``fused`` makes them strided views of one
    [b, s, h, 3, d] tensor, the layout GPT's qkv projection gives."""
    rng = np.random.default_rng(seed)
    b, s, h, d = shape
    if fused:
        qkv = torch.from_numpy(rng.standard_normal((b, s, h, 3, d)).astype(np.float32))
        return qkv.to(_card(), dtype).unbind(dim=3)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(_card(), dtype)
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,dtype,fused", [
    ((2, 128, 4, 64), True, torch.float32, False),
    ((1, 128, 2, 32), False, torch.float32, False),
    ((1, 600, 2, 24), True, torch.float32, True),
    ((2, 128, 4, 64), True, torch.bfloat16, True),
    ((2, 128, 4, 64), True, torch.float16, False),
    ((4, 1024, 16, 64), True, torch.float32, True),
    ((1, 200, 2, 160), True, torch.float32, False),  # two 128-wide output slices
    ((1, 7, 1, 5), True, torch.float32, False),  # shorter than one tile
])
def test_flash_fwd_kernel_matches_plain(shape, causal, dtype, fused):
    q, k, v = _qkv(shape, dtype, fused, seed=0)
    scale = shape[-1] ** -0.5
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, scale, causal)
    o_p, lse_p = tfa.fwd_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    assert o.dtype == dtype and tuple(o.shape) == shape and tuple(lse.shape) == shape[:1] + (
        shape[2], shape[1])
    assert (o.float() - o_p.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_p).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_flash_fwd_kernel_refuses_float64():
    q = torch.zeros(1, 8, 1, 8, dtype=torch.float64, device=_card())
    with pytest.raises(TypeError, match="not supported on CUDA"):
        tfa.flash_attention_fwd(q, q, q, 1.0, True)


@pytest.mark.cuda
def test_gpt_forward_launches_the_kernel_once_per_layer():
    card = _card()
    pt.seed(0)
    cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                         max_seq_len=64)
    model = tgpt.GPTForPretraining(cfg, device=card).eval()
    ids = torch.randint(0, 128, (2, 48), device=card)
    with torch.no_grad():
        before = tfa.flash_attention_fwd.launches
        flash = model(ids)
        assert tfa.flash_attention_fwd.launches == before + cfg.num_layers
        pt.set_flags({"FLAGS_use_flash_attention": False})
        try:
            dense = model(ids)
        finally:
            pt.set_flags({"FLAGS_use_flash_attention": True})
    assert tfa.flash_attention_fwd.launches == before + cfg.num_layers
    assert (flash - dense).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,dtype,fused", BWD_CASES)
def test_flash_bwd_kernels_match_plain_and_repeat_bitwise(shape, causal, dtype, fused):
    q, k, v = _qkv(shape, dtype, fused, seed=1)
    rng = np.random.default_rng(2)
    do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(_card(), dtype)
    scale = shape[-1] ** -0.5
    o, lse = tfa.flash_attention_fwd(q, k, v, scale, causal)
    delta = tfa.bwd_delta(o, do)
    before = (tfa.flash_attention_bwd_dkv.launches, tfa.flash_attention_bwd_dq.launches)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dk2, dv2 = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dq2 = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    ref = tfa.bwd_plain(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dkv.launches, tfa.flash_attention_bwd_dq.launches) == (
        before[0] + 2, before[1] + 2)
    for got, again, want in zip((dq, dk, dv), (dq2, dk2, dv2), ref):
        assert got.dtype == dtype and tuple(got.shape) == shape
        assert torch.equal(got, again)
        assert (got.float() - want.float()).abs().max().item() <= GRAD_TOL[dtype]


def _plus(counts, route, n):
    """``counts`` (launches by route) with n more on ``route``."""
    return {r: c + (n if r == route else 0) for r, c in counts.items()}


# The sm90 (wgmma + TMA) route: the main path's shapes with GPT's fused-qkv
# views, a ragged S, a non-causal D = 128 and one tile with D = 16.
SM90_CASES = [
    ((4, 1024, 16, 64), True, True),  # the 345M forward
    ((8, 1024, 16, 64), True, True),  # the 345M training step
    ((2, 1000, 4, 64), True, False),  # ragged S
    ((1, 512, 2, 128), False, False),  # non-causal, D = 128
    ((1, 64, 1, 16), True, False),  # one tile, D = 16
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,causal,fused", SM90_CASES)
def test_sm90_kernels_match_plain_and_repeat_bitwise(shape, causal, fused, dtype):
    q, k, v = _qkv(shape, dtype, fused, seed=4)
    rng = np.random.default_rng(5)
    do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(_card(), dtype)
    scale = shape[-1] ** -0.5
    assert tfa.sm90_eligible((q, k, v)) and tfa.sm90_eligible((q, k, v, do))
    fwd_routes = dict(tfa.flash_attention_fwd.launches_by_route)
    dkv_routes = dict(tfa.flash_attention_bwd_dkv.launches_by_route)
    dq_routes = dict(tfa.flash_attention_bwd_dq.launches_by_route)
    o, lse = tfa.flash_attention_fwd(q, k, v, scale, causal)
    delta = tfa.bwd_delta(o, do)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dk2, dv2 = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dq2 = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    o_p, lse_p = tfa.fwd_plain(q, k, v, scale, causal)
    dq_p, dk_p, dv_p = tfa.bwd_plain(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches_by_route == _plus(fwd_routes, "sm90", 1)
    assert tfa.flash_attention_bwd_dkv.launches_by_route == _plus(dkv_routes, "sm90", 2)
    assert tfa.flash_attention_bwd_dq.launches_by_route == _plus(dq_routes, "sm90", 2)
    assert o.dtype == dtype and tuple(o.shape) == shape
    assert (o.float() - o_p.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_p).abs().max().item() <= TOL[dtype]
    for got, again, want in ((dk, dk2, dk_p), (dv, dv2, dv_p), (dq, dq2, dq_p)):
        assert got.dtype == dtype and tuple(got.shape) == shape
        assert torch.equal(got, again)
        assert (got.float() - want.float()).abs().max().item() <= GRAD_TOL[dtype]


@pytest.mark.cuda
def test_simt_route_takes_what_sm90_refuses():
    """What sm90 refuses (f32, a ragged head dim, a stride that is not a
    multiple of 8) runs on the tf32x3 route, forward and dQ, where that takes
    it (f32 that TMA reads), and on the CUDA cores where it does not (16-bit
    types, f32 with a head dim that is not a multiple of 8 or a stride that
    is not a multiple of 4)."""
    card = _card()
    cases = [  # (x, the route of the forward and the backward)
        (torch.randn(1, 128, 2, 64, device=card), "tf32x3"),  # f32
        (torch.randn(1, 128, 2, 40, device=card).bfloat16(), "simt"),  # D % 16 != 0
        (torch.randn(1, 128, 2, 70, device=card).bfloat16()[..., :64], "simt"),  # h stride 70
        (torch.randn(1, 128, 2, 20, device=card), "simt"),  # f32, D % 8 != 0
        (torch.randn(1, 128, 2, 70, device=card)[..., :64], "simt"),  # f32, h stride 70
    ]
    for x, route in cases:
        assert not tfa.sm90_eligible((x, x, x))
        assert tfa.tf32x3_eligible((x, x, x)) == (route == "tf32x3")
        before = dict(tfa.flash_attention_fwd.launches_by_route)
        o, lse = tfa.flash_attention_fwd(x, x, x, 0.125, True)
        o_p, _ = tfa.fwd_plain(x, x, x, 0.125, True)
        torch.cuda.synchronize()
        assert tfa.flash_attention_fwd.launches_by_route == _plus(before, route, 1)
        assert (o.float() - o_p.float()).abs().max().item() <= TOL[x.dtype]
        assert not tfa.sm90_eligible((x, x, x, x))
        assert tfa.tf32x3_eligible((x, x, x, x)) == (route == "tf32x3")
        delta = tfa.bwd_delta(o, x)
        before = dict(tfa.flash_attention_bwd_dq.launches_by_route)
        dq = tfa.flash_attention_bwd_dq(x, x, x, x, lse, delta, 0.125, True)
        dq_p = tfa.bwd_plain(x, x, x, x, lse, delta, 0.125, True)[0]
        torch.cuda.synchronize()
        assert tfa.flash_attention_bwd_dq.launches_by_route == _plus(before, route, 1)
        assert (dq.float() - dq_p.float()).abs().max().item() <= GRAD_TOL[x.dtype]


# The tf32x3 route (3xTF32 on mma.sync, fed by TMA): GPT's f32 fused-qkv
# views at the 345M training shape and a small one, a ragged S with D = 24,
# D = 128 and a non-causal case. Its error against the f32 plain version is
# expected near 1e-5 (an f32 product's); one above 1e-4 means a dropped split
# term or a wrong reduction-index permutation, though 2e-3 is the tolerance.
TF32_CASES = [
    ((8, 1024, 16, 64), True, True),
    ((2, 256, 4, 64), True, True),
    ((1, 600, 2, 24), True, True),
    ((1, 512, 2, 128), True, False),
    ((1, 128, 2, 32), False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,fused", TF32_CASES)
def test_tf32x3_kernels_match_plain_and_repeat_bitwise(shape, causal, fused):
    q, k, v = _qkv(shape, torch.float32, fused, seed=6)
    rng = np.random.default_rng(7)
    do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(_card())
    scale = shape[-1] ** -0.5
    assert tfa.tf32x3_eligible((q, k, v, do)) and not tfa.sm90_eligible((q, k, v, do))
    o, lse = tfa.fwd_plain(q, k, v, scale, causal)
    delta = tfa.bwd_delta(o, do)
    dkv_routes = dict(tfa.flash_attention_bwd_dkv.launches_by_route)
    dq_routes = dict(tfa.flash_attention_bwd_dq.launches_by_route)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dk2, dv2 = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dq2 = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    ref = tfa.bwd_plain(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_dkv.launches_by_route == _plus(dkv_routes, "tf32x3", 2)
    assert tfa.flash_attention_bwd_dq.launches_by_route == _plus(dq_routes, "tf32x3", 2)
    errs = [(got - want).abs().max().item() for got, want in zip((dq, dk, dv), ref)]
    print(f"tf32x3 {shape} causal={causal}: max|d dQ|={errs[0]:.3e} max|d dK|={errs[1]:.3e} "
          f"max|d dV|={errs[2]:.3e}")
    for got, again, err in zip((dq, dk, dv), (dq2, dk2, dv2), errs):
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, again)
        assert err <= GRAD_TOL[torch.float32]


# The tf32x3 forward (3xTF32 on mma.sync, fed by TMA): GPT's f32 fused-qkv
# views at the 345M forward shape, a ragged S with D = 24, a non-causal
# D = 32 and a causal D = 128. Its error against the f32 plain version reads
# 1.4e-6 to 8.2e-6 on the H100 (the CPU emulation in
# tests/test_torch_flash_tf32.py, which sums in another order, 1e-6 to
# 2e-6); 2e-5 is the tolerance.
TF32_FWD_CASES = [
    ((4, 1024, 16, 64), True, True),
    ((1, 600, 2, 24), True, True),
    ((1, 128, 2, 32), False, False),
    ((1, 512, 2, 128), True, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,fused", TF32_FWD_CASES)
def test_tf32x3_forward_matches_plain_and_repeats_bitwise(shape, causal, fused):
    q, k, v = _qkv(shape, torch.float32, fused, seed=8)
    scale = shape[-1] ** -0.5
    assert tfa.tf32x3_eligible((q, k, v)) and not tfa.sm90_eligible((q, k, v))
    routes = dict(tfa.flash_attention_fwd.launches_by_route)
    o, lse = tfa.flash_attention_fwd(q, k, v, scale, causal)
    assert tfa.flash_attention_fwd.launches_by_route == _plus(routes, "tf32x3", 1)
    o2, lse2 = tfa.flash_attention_fwd(q, k, v, scale, causal)
    assert tfa.flash_attention_fwd.launches_by_route == _plus(routes, "tf32x3", 2)
    o_p, lse_p = tfa.fwd_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    err_o = (o - o_p).abs().max().item()
    err_lse = (lse - lse_p).abs().max().item()
    print(f"tf32x3 forward {shape} causal={causal}: max|d O|={err_o:.3e} "
          f"max|d lse|={err_lse:.3e}")
    assert o.dtype == torch.float32 and tuple(o.shape) == shape
    assert tuple(lse.shape) == (shape[0], shape[2], shape[1])
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert err_o <= TOL[torch.float32] and err_lse <= TOL[torch.float32]


@pytest.mark.cuda
def test_flash_attention_autograd_runs_the_backward_kernels():
    card = _card()
    q, k, v = (x.detach().requires_grad_() for x in _qkv((1, 96, 2, 32), torch.float32,
                                                             False, seed=3))
    before = (tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd_dkv.launches,
              tfa.flash_attention_bwd_dq.launches)
    routes = [dict(fn.launches_by_route) for fn in (
        tfa.flash_attention_fwd, tfa.flash_attention_bwd_dkv, tfa.flash_attention_bwd_dq)]
    out = tfa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad((out * out).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd_dkv.launches,
            tfa.flash_attention_bwd_dq.launches) == tuple(n + 1 for n in before)
    # f32 that TMA reads: the forward and both backward kernels in 3xTF32
    assert tfa.flash_attention_fwd.launches_by_route == _plus(routes[0], "tf32x3", 1)
    assert tfa.flash_attention_bwd_dkv.launches_by_route == _plus(routes[1], "tf32x3", 1)
    assert tfa.flash_attention_bwd_dq.launches_by_route == _plus(routes[2], "tf32x3", 1)
    qc, kc, vc = (x.detach().cpu().requires_grad_() for x in (q, k, v))
    out_c = tfa.flash_attention(qc, kc, vc, causal=True)
    ref = torch.autograd.grad((out_c * out_c).sum(), (qc, kc, vc))
    for g, r in zip(grads, ref):
        assert g.device == card
        assert (g.cpu() - r).abs().max().item() <= GRAD_TOL[torch.float32]


# sizes: one element, ragged, one tile of the TPU kernel, a float4 tail,
# 2^20 + 3 (unaligned tail), and GPT-2 345M's tied word embedding
UPDATE_SIZES = [1, 1000, 1024, 4097, 2 ** 20 + 3, 50304 * 1024]


def _update_inputs(n, seed):
    gen = torch.Generator(device=_card())
    gen.manual_seed(seed)
    p, g, m = (torch.randn(n, generator=gen, device=_card()) for _ in range(3))
    v = torch.rand(n, generator=gen, device=_card())
    return p, g, m, v


def _run_kernel(kind, bufs, lr, hyper, wd, bad):
    """One kernel launch on copies of ``bufs``; returns the copies."""
    p, g, m, v = (b.clone() for b in bufs)
    if kind == "sgd":
        tfu.fused_sgd(p, g, lr, wd=wd, bad=bad)
        return (p,)
    if kind == "momentum":
        tfu.fused_momentum(p, g, m, lr, mu=0.9, nesterov=hyper, wd=wd, bad=bad)
        return p, m
    tfu.fused_adam(p, g, m, v, lr, b1=0.9, b2=0.999, eps=1e-8, wd=wd, bad=bad)
    return p, m, v


def _run_plain(kind, bufs, lr, hyper, wd, bad):
    p, g, m, v = bufs
    if kind == "sgd":
        return (tfu.sgd_plain(p, g, lr, wd=wd, bad=bad),)
    if kind == "momentum":
        return tfu.momentum_plain(p, g, m, lr, mu=0.9, nesterov=hyper, wd=wd, bad=bad)
    return tfu.adam_plain(p, g, m, v, lr, b1=0.9, b2=0.999, eps=1e-8, wd=wd, bad=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("n", UPDATE_SIZES)
@pytest.mark.parametrize("kind,hyper", [("sgd", None), ("momentum", False),
                                        ("momentum", True), ("adam", None)])
def test_fused_update_kernels_equal_plain_bitwise(kind, hyper, n):
    bufs = _update_inputs(n, seed=n % 1000)
    lr = torch.full((), 3e-3, device=_card())
    for wd in (0.0, 0.01):
        for gate in (None, False, True):
            bad = None if gate is None else torch.tensor(gate, device=_card())
            before = tfu.KERNELS[kind].launches
            got = _run_kernel(kind, bufs, lr, hyper, wd, bad)
            want = _run_plain(kind, bufs, lr, hyper, wd, bad)
            torch.cuda.synchronize()
            assert tfu.KERNELS[kind].launches == before + 1
            for a, b in zip(got, want):
                assert torch.equal(a, b), (kind, hyper, n, wd, gate)
            if gate:  # a rescued step leaves p and the state (m or velocity, v) as they were
                for a, i in zip(got, (0, 2, 3)):
                    assert torch.equal(a, bufs[i])
            else:
                assert not torch.equal(got[0], bufs[0])


@pytest.mark.cuda
def test_fused_update_refuses_what_the_kernel_does_not_take():
    p = torch.zeros(8, 128, device=_card())
    assert tfu.supported("adam", p, p, {"moment1": p, "moment2": p})
    assert not tfu.supported("sgd", p.bfloat16(), p.bfloat16(), {})
    assert not tfu.supported("sgd", p.t(), p.t(), {})
    assert not tfu.supported("momentum", p, p, {"velocity": p.t().contiguous().t()})
    lr = torch.zeros((), device=_card())
    with pytest.raises(ValueError, match="contiguous float32"):
        tfu.fused_sgd(p.bfloat16(), p.bfloat16(), lr, wd=0.0)
    with pytest.raises(ValueError, match="one-element"):
        tfu.fused_sgd(p, p.clone(), lr.cpu(), wd=0.0)


@pytest.mark.cuda
def test_adam_step_launches_the_kernel_for_every_parameter():
    card = _card()
    pt.seed(0)
    cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                         max_seq_len=64, dropout=0.0, attn_dropout=0.0)
    model = tgpt.GPTForPretraining(cfg, device=card)
    ref = copy.deepcopy(model)
    ids = torch.randint(0, 128, (2, 65), device=card)
    crit = tgpt.GPTPretrainingCriterion()
    losses = {}
    for name, m, flag in (("on", model, True), ("off", ref, False)):
        opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=m.parameters(),
                                weight_decay=pt.regularizer.L2Decay(0.01),
                                grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
        pt.set_flags({"FLAGS_pallas_fused_update": flag})
        try:
            before = tfu.fused_adam.launches
            losses[name] = []
            for _ in range(2):
                loss = crit(m(ids[:, :-1]), ids[:, 1:])
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses[name].append(loss.item())
            launched = tfu.fused_adam.launches - before
        finally:
            pt.set_flags({"FLAGS_pallas_fused_update": False})
        assert launched == (2 * len(list(m.parameters())) if flag else 0)
    assert losses["on"] == losses["off"]
    for a, b in zip(model.parameters(), ref.parameters()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_serving_engine_replays_cuda_graphs():
    """The serving engine on the card: each prefill and decode signature is
    one CUDA graph, replayed in steady state. Tokens equal the retained and
    eager rungs' and generate()'s; logits within 1e-5 of the eager rung's
    (the graph replays the eager kernels; 1e-5 is test_torch_gpt.py's
    logits tolerance)."""
    from paddle_tpu_torch import profiler, serving
    from paddle_tpu_torch.core import lazy

    card = _card()
    pt.seed(0)
    cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                         max_seq_len=64, dropout=0.0, attn_dropout=0.0, initializer_range=0.2)
    model = tgpt.GPTForPretraining(cfg, device=card).eval()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 128, n) for n in (8, 8, 16, 5, 12)]

    def serve(**flags):
        pt.set_flags(flags)
        try:
            eng = serving.Engine(model, serving.ServingConfig(
                block_size=8, prompt_buckets=[8, 16], num_blocks=32, keep_logits=True))
            assert eng._pool.k[0].device == card
            out = eng.serve(prompts, max_new_tokens=8)
            eng.close()
            return out
        finally:
            pt.set_flags({"FLAGS_serving_capture": True, "FLAGS_serving_capture_donate": True})

    profiler.reset_dispatch_counters()
    lazy.reset_serve_programs()
    try:
        eng = serving.Engine(model, serving.ServingConfig(
            block_size=8, prompt_buckets=[8, 16], num_blocks=32, keep_logits=True))
        eng.serve(prompts, max_new_tokens=8)  # warm: captures every signature
        state = lazy.serve_capture_state()
        assert state["cuda_graphs"] == state["cached_programs"] > 0
        profiler.reset_dispatch_counters()
        captured = eng.serve(prompts, max_new_tokens=8)
        c = profiler.dispatch_counters()
        assert c["serve_capture_builds"] == 0 and c["serve_capture_fallbacks"] == 0
        assert c["serve_capture_replays"] == c["serve_decode_steps"] + c["serve_prefills"] > 0
        eng.close()
        retained = serve(FLAGS_serving_capture_donate=False)
        eager = serve(FLAGS_serving_capture=False)
    finally:
        lazy.reset_serve_programs()
    for p, a, b, e in zip(prompts, captured, retained, eager):
        assert a.ok and b.ok and e.ok
        want = model.generate(np.asarray(p)[None, :], max_new_tokens=8).cpu().numpy()
        assert a.tokens == b.tokens == e.tokens == [int(t) for t in want[0, len(p):]]
        for x, y in zip(a.logits, e.logits):
            np.testing.assert_allclose(x, y, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_serving_engine_batches_continuously_on_card():
    """Continuous batching on the card: requests arrive while others decode,
    into a pool of 12 blocks that holds 6 of them at once, so admissions
    land mid-decode, the decode batch changes size and backpressure queues
    the rest. A first engine is closed, releasing its graphs and their
    memory pool, and a second one captures anew; its second run of the same
    schedule replays only captured graphs, each step's device time comes
    from the engine's CUDA events, and the tokens equal the first engine's
    and the eager rung's on the same schedule."""
    from paddle_tpu_torch import profiler, serving
    from paddle_tpu_torch.core import lazy

    card = _card()
    pt.seed(0)
    cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                         max_seq_len=64, dropout=0.0, attn_dropout=0.0, initializer_range=0.2)
    model = tgpt.GPTForPretraining(cfg, device=card).eval()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 128, n) for n in (8, 5, 8, 3, 8, 6, 8, 7, 4, 8, 2, 8, 8, 6)]
    arrivals = [3, 0, 1, 2, 0, 3, 1, 0, 2, 2]

    def run(eng):
        ids, depth, left, t = [], [], iter(prompts), 0
        while t < len(arrivals) or eng.pending:
            if t < len(arrivals):
                ids += [eng.submit(next(left), max_new_tokens=6) for _ in range(arrivals[t])]
            eng.step()
            depth.append(eng.routing_signals()["queue_depth"])
            t += 1
        eng.run_until_idle()
        return [eng.pop_response(i) for i in ids], depth

    def engine():
        return serving.Engine(model, serving.ServingConfig(
            block_size=8, prompt_buckets=[8], num_blocks=12))

    lazy.reset_serve_programs()
    try:
        first = engine()
        first_out, _ = run(first)
        first.close()
        assert lazy.serve_capture_state()["cuda_graphs"] == 0
        eng = engine()
        run(eng)  # warm: captures every signature of the schedule anew
        assert lazy.serve_capture_state()["cuda_graphs"] > 0
        profiler.reset_dispatch_counters()
        eng.reset_stats()
        captured, depth = run(eng)
        c = profiler.dispatch_counters()
        steps = eng.step_timings()
        eng.close()
        pt.set_flags({"FLAGS_serving_capture": False})
        try:
            eager, _ = run(engine())
        finally:
            pt.set_flags({"FLAGS_serving_capture": True})
    finally:
        lazy.reset_serve_programs()
    kinds = [t.kind for t in steps]
    assert max(depth) > 0  # backpressure fired
    assert len({len(t.request_ids) for t in steps if t.kind == "decode"}) >= 3
    assert "prefill" in kinds[kinds.index("decode"):]  # admitted mid-decode
    assert c["serve_capture_builds"] == c["serve_capture_fallbacks"] == 0
    assert c["serve_capture_replays"] == c["serve_decode_steps"] + c["serve_prefills"] > 0
    assert c["serve_requests_dropped"] == c["serve_block_leaks"] == 0
    assert all(t.device_ms is not None and t.device_ms > 0 for t in steps)
    assert all(r.ok for r in first_out + captured + eager)
    assert ([r.tokens for r in first_out] == [r.tokens for r in captured]
            == [r.tokens for r in eager])


TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64)


class _Rows(torch.nn.Module):
    """GPT decoder layers and a head over float rows: the batch input whose
    gradient ``grad_input_idx`` returns."""

    def __init__(self, card, **cfg):
        super().__init__()
        cfg = tgpt.GPTConfig(**dict(TINY, **cfg))
        self.layers = pt.nn.LayerList([tgpt.GPTDecoderLayer(cfg, device=card)
                                       for _ in range(cfg.num_layers)])
        self.head = pt.nn.Linear(cfg.hidden_size, cfg.vocab_size, device=card)

    def forward(self, rows):
        for layer in self.layers:
            rows = layer(rows)
        return self.head(rows)


def _rows_batch(card, seed=0):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    rows = torch.randn(2, 64, TINY["hidden_size"], generator=gen, device=card)
    labels = torch.randint(0, TINY["vocab_size"], (2, 64), generator=gen, device=card)
    return rows, labels


@pytest.mark.cuda
@pytest.mark.parametrize("recompute", [False, True])
def test_captured_step_draws_new_dropout_masks_per_replay(recompute):
    card = _card()
    crit = tgpt.GPTPretrainingCriterion()
    losses = {}
    for p in (0.1, 0.0):
        pt.seed(0)
        model = _Rows(card, dropout=p, attn_dropout=0.0, use_recompute=recompute)
        opt = pt.optimizer.SGD(learning_rate=0.0, parameters=model.parameters())
        step = pt.jit.compile_train_step(model, lambda lo, lb: crit(lo, lb), opt)
        rows, labels = _rows_batch(card)
        losses[p] = [step(rows, labels).item() for _ in range(pt.jit.WARMUP_STEPS + 3)]
        (entry,) = step._captured.values()
        assert entry.graph is not None
        assert entry.segments == (2 if recompute else 0)
    # lr 0 and one batch: only the masks change the loss, replay by replay
    replays = {p: v[pt.jit.WARMUP_STEPS:] for p, v in losses.items()}
    assert len(set(losses[0.1])) == len(losses[0.1]), losses
    assert len(set(replays[0.0])) == 1, losses


@pytest.mark.cuda
def test_captured_recompute_replays_the_segment_masks():
    """A replay's recomputations draw the masks its forwards drew: the loss
    and the input rows' gradient of one replay equal those of an eager step
    without recompute whose layers draw from the same generator states (the
    segment pairs' forward halves, the port generator for the rest)."""
    card = _card()
    crit = tgpt.GPTPretrainingCriterion()
    pt.seed(0)
    model = _Rows(card, dropout=0.1, attn_dropout=0.0, use_recompute=True)
    eager = copy.deepcopy(model)
    for layer in eager.layers:
        layer.cfg = tgpt.GPTConfig(**dict(TINY, dropout=0.1, attn_dropout=0.0))
    opt = pt.optimizer.SGD(learning_rate=0.0, parameters=model.parameters())
    step = pt.jit.compile_train_step(model, lambda lo, lb: crit(lo, lb), opt,
                                     grad_input_idx=(0,))
    rows, labels = _rows_batch(card, seed=1)
    for _ in range(pt.jit.WARMUP_STEPS + 1):
        step(rows, labels)
    (entry,) = step._captured.values()
    state = pt.get_rng_state()
    loss, (grad,) = step(rows, labels)
    # the same random state, and the pairs seeded from it as the replay seeded them
    pt.set_rng_state(state)
    entry.pairs.reseed()
    gen = pt.core.random.generator(card)
    for layer, (fwd, _) in zip(eager.layers, entry.pairs):
        def forward(*args, _forward=layer.forward, _fwd=fwd, **kwargs):
            with pt.core.random.drawing_from(gen, _fwd):
                return _forward(*args, **kwargs)

        layer.forward = forward
    x = rows.clone().requires_grad_()
    ref = crit(eager(x), labels)
    (ref_grad,) = torch.autograd.grad(ref, [x])
    for layer in eager.layers:
        del layer.forward
    # the same kernels on the same data: equal but for a library matmul that
    # may pick another algorithm inside the graph; a wrong mask moves the
    # gradient of whole rows (~1e-2 here)
    assert abs(loss.item() - ref.item()) <= 1e-5, (loss.item(), ref.item())
    assert (grad - ref_grad).abs().max().item() <= 1e-6 * max(1.0, grad.abs().max().item())
    # a control: the eager step drawing from the port generator alone differs
    pt.set_rng_state(state)
    entry.pairs.reseed()
    other = crit(eager(rows), labels)
    assert abs(other.item() - ref.item()) > 1e-4
    # set_rng_state covers the segments' masks: the replay again gives its loss
    pt.set_rng_state(state)
    again, _ = step(rows, labels)
    assert torch.equal(again, loss)


@pytest.mark.cuda
def test_o1_fp16_step_with_a_scaler_launches_the_fp16_kernels():
    card = _card()
    pt.seed(0)
    model = tgpt.GPTForPretraining(tgpt.GPTConfig(**TINY, dropout=0.1, attn_dropout=0.0),
                                   device=card)
    opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    scaler = pt.amp.GradScaler()
    ids = torch.randint(0, 128, (2, 65), device=card)
    routes = [dict(fn.launches_by_route) for fn in (
        tfa.flash_attention_fwd, tfa.flash_attention_bwd_dkv, tfa.flash_attention_bwd_dq)]
    with pt.amp.auto_cast(level="O1", dtype="float16"):
        loss = tgpt.GPTPretrainingCriterion()(model(ids[:, :-1]), ids[:, 1:])
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()
    torch.cuda.synchronize()
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    for fn, before in zip((tfa.flash_attention_fwd, tfa.flash_attention_bwd_dkv,
                           tfa.flash_attention_bwd_dq), routes):
        assert fn.launches_by_route == _plus(before, "sm90", 2)
    assert opt._step_count == 1 and scaler.state_dict()["good_steps"] == 1


@pytest.mark.cuda
def test_checkpoint_restore_into_a_captured_step_is_in_place(tmp_path):
    """A snapshot loaded into a model whose step is captured lands in the
    tensors the graph reads: every parameter's and optimizer tensor's
    data_ptr() is unchanged, and the next replay gives the loss of the step
    after the saved one (bf16 O2 AdamW, the sm90 kernels)."""
    from paddle_tpu_torch.distributed import checkpoint as dc

    card = _card()
    crit = tgpt.GPTPretrainingCriterion()

    def trainer():
        pt.seed(0)
        model = pt.amp.decorate(tgpt.GPTForPretraining(
            tgpt.GPTConfig(**TINY, dropout=0.0, attn_dropout=0.0), device=card),
            level="O2", dtype="bfloat16")
        opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters())
        return model, opt, pt.jit.compile_train_step(
            model, lambda lo, lb: crit(lo.float(), lb), opt)

    def batch(i):
        gen = torch.Generator(device=card)
        gen.manual_seed(100 + i)
        ids = torch.randint(0, TINY["vocab_size"], (2, 65), generator=gen, device=card)
        return ids[:, :-1], ids[:, 1:]

    steps = pt.jit.WARMUP_STEPS + 3
    model, opt, step = trainer()
    ck = dc.AsyncCheckpointer(str(tmp_path / "ck"))
    losses = []
    for i in range(steps):
        losses.append(step(*batch(i)).item())
        if i == steps - 2:
            ck.save(i, dc.training_state(model, opt))  # overlaps the last replay
    ck.wait()
    (entry,) = step._captured.values()
    assert entry.graph is not None
    state = dc.training_state(model, opt)
    ptrs = {k: v.data_ptr() for k, v in state.items() if isinstance(v, torch.Tensor)}
    assert ck.restore_latest(state) == steps - 2
    dc.restore_training_state(state, optimizer=opt)
    state.refresh()
    assert {k: v.data_ptr() for k, v in state.items() if isinstance(v, torch.Tensor)} == ptrs
    assert sum(v.dtype == torch.bfloat16 for v in state.values()
               if isinstance(v, torch.Tensor)) > len(ptrs) // 2
    # the replay reads the restored state: the last step again, to the bit
    assert step(*batch(steps - 1)).item() == losses[-1]
    assert step._captured[next(iter(step._captured))] is entry
