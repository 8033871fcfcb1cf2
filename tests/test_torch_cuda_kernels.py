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
the graph reads. BERT's projection-major qkv views take the non-causal sm90
kernels as they are; a captured BERT step launches them once per layer, and
the optimizers without a fused kernel replay as their eager steps do. The
tensor surface lives on the card by default, rebinds in place there, runs
backward and ``paddle.grad`` there, and a model step with Tensor inputs is
bitwise the step with torch inputs. A batch norm's running statistics
accumulate in place across a compiled step's graph replays, and a
convolution decorated for O2 runs in bf16. Under lazy dispatch a LeNet
step's segment runs as a forward graph and a backward graph, and a
captured step as one graph holding the fused Adam launches, both bitwise
the per-op steps; a parameter rebound after a capture invalidates it (and
a segment's graphs under lazy dispatch), and
a layer put into eval mode, swapped or given a new attribute between steps
is captured anew, bitwise the per-op steps. A frozen layer keeps its bits
through eager steps and captured ones (``compile_train_step`` and the lazy
whole-step capture), frozen before the first step or between steps.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import bert as tbert
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
    ((32, 128, 8, 32), False, False),  # BASELINE config 5's ERNIE CTR attention
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
    ((32, 128, 8, 32), False, False),  # BASELINE config 5's ERNIE CTR attention
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


def _run_kernel_tele(kind, bufs, lr, hyper, wd, bad):
    """One telemetry-variant launch on copies of ``bufs``; returns the
    copies and the summed rows."""
    p, g, m, v = (b.clone() for b in bufs)
    tele = torch.zeros((tfu.telemetry_blocks(p.device), 3), device=p.device)
    if kind == "sgd":
        tfu.fused_sgd(p, g, lr, wd=wd, bad=bad, tele=tele)
        out = (p,)
    elif kind == "momentum":
        tfu.fused_momentum(p, g, m, lr, mu=0.9, nesterov=hyper, wd=wd, bad=bad, tele=tele)
        out = (p, m)
    else:
        tfu.fused_adam(p, g, m, v, lr, b1=0.9, b2=0.999, eps=1e-8, wd=wd, bad=bad, tele=tele)
        out = (p, m, v)
    return out, tele.sum(0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", UPDATE_SIZES)
@pytest.mark.parametrize("kind,hyper", [("sgd", None), ("momentum", True), ("adam", None)])
def test_fused_update_telemetry_variant_equals_the_kernel_and_repeats(kind, hyper, n):
    """The telemetry variant updates bit for bit as the kernel does; its
    rows are within 1e-5 of float64 sums, and a second launch's rows are
    bitwise the first's."""
    bufs = _update_inputs(n, seed=n % 1000 + 7)
    lr = torch.full((), 3e-3, device=_card())
    for wd in (0.0, 0.01):
        for gate in (None, False, True):
            bad = None if gate is None else torch.tensor(gate, device=_card())
            before = tfu.KERNELS[kind].telemetry_launches
            got, rows = _run_kernel_tele(kind, bufs, lr, hyper, wd, bad)
            again, rows2 = _run_kernel_tele(kind, bufs, lr, hyper, wd, bad)
            want = _run_kernel(kind, bufs, lr, hyper, wd, bad)
            torch.cuda.synchronize()
            assert tfu.KERNELS[kind].telemetry_launches == before + 2
            for a, b in zip(got, want):
                assert torch.equal(a, b), (kind, n, wd, gate)
            assert torch.equal(rows, rows2)
            p, g = bufs[0].double(), bufs[1].double()
            ref = torch.stack([(g * g).sum(), (p * p).sum(),
                               ((got[0].double() - p) ** 2).sum()])
            torch.testing.assert_close(rows.double(), ref, rtol=1e-5, atol=1e-30)
            if gate:
                assert rows[2].item() == 0.0


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


def _bert_qkv(shape, dtype, seed):
    """q, k, v on the card as BERT makes them: views of one [b, s, 3, h, d]
    projection, unbound on axis 2."""
    b, s, h, d = shape
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3, h, d)).astype(np.float32))
    return qkv.to(_card(), dtype).unbind(dim=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(8, 512, 12, 64), (2, 200, 12, 64)])
def test_sm90_noncausal_kernels_on_bert_views(shape, dtype):
    """BERT-base's attention (12 heads of 64, S 512, and a ragged S) on the
    projection-major views, non-causal: forward, dK/dV and dQ on sm90
    against their plain versions, a second backward bitwise equal."""
    q, k, v = _bert_qkv(shape, dtype, seed=6)
    assert not q.is_contiguous() and k.data_ptr() - q.data_ptr() == shape[2] * shape[3] * 2
    rng = np.random.default_rng(7)
    do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(_card(), dtype)
    scale = shape[-1] ** -0.5
    routes = [dict(fn.launches_by_route) for fn in (
        tfa.flash_attention_fwd, tfa.flash_attention_bwd_dkv, tfa.flash_attention_bwd_dq)]
    o, lse = tfa.flash_attention_fwd(q, k, v, scale, False)
    delta = tfa.bwd_delta(o, do)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, False)
    dk2, dv2 = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, False)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, False)
    dq2 = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, False)
    o_p, lse_p = tfa.fwd_plain(q, k, v, scale, False)
    dq_p, dk_p, dv_p = tfa.bwd_plain(q, k, v, do, lse, delta, scale, False)
    torch.cuda.synchronize()
    for fn, before, n in zip((tfa.flash_attention_fwd, tfa.flash_attention_bwd_dkv,
                              tfa.flash_attention_bwd_dq), routes, (1, 2, 2)):
        assert fn.launches_by_route == _plus(before, "sm90", n)
    assert (o.float() - o_p.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_p).abs().max().item() <= TOL[dtype]
    for got, again, want in ((dk, dk2, dk_p), (dv, dv2, dv_p), (dq, dq2, dq_p)):
        assert got.dtype == dtype and tuple(got.shape) == shape
        assert torch.equal(got, again)
        assert (got.float() - want.float()).abs().max().item() <= GRAD_TOL[dtype]


BERT_TINY = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2, max_seq_len=64,
                 dropout=0.0, attn_dropout=0.0)


def _bert_loss(out, packed):
    crit = tbert.BertPretrainingCriterion()
    return crit(out[0].float(), out[1].float(), packed[:, :-1], packed[:, -1])


def _bert_batch(card, seed=0):
    """ids, token types (a second sentence from the middle), packed labels."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    ids = torch.randint(0, BERT_TINY["vocab_size"], (2, 64), generator=gen, device=card)
    types = (torch.arange(64, device=card) >= 32).long().expand(2, -1)
    packed = torch.cat([torch.randint(0, BERT_TINY["vocab_size"], (2, 64), generator=gen,
                                      device=card),
                        torch.randint(0, 2, (2, 1), generator=gen, device=card)], dim=1)
    return ids, types, packed


@pytest.mark.cuda
def test_captured_bert_step_launches_the_noncausal_sm90_kernels():
    """The O2 bf16 BERT step: each eager step launches one sm90 forward, dK/dV
    and dQ per layer; the replays go through the graph and launch none
    through the wrappers; the loss falls."""
    card = _card()
    pt.seed(0)
    model = pt.amp.decorate(tbert.BertForPretraining(tbert.BertConfig(**BERT_TINY), device=card),
                            level="O2", dtype="bfloat16")
    opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = pt.jit.compile_train_step(model, _bert_loss, opt)
    ids, _, packed = _bert_batch(card)
    fns = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dkv, tfa.flash_attention_bwd_dq)
    routes = [dict(fn.launches_by_route) for fn in fns]
    losses = [step(ids, packed).item() for _ in range(pt.jit.WARMUP_STEPS)]
    for fn, before in zip(fns, routes):
        assert fn.launches_by_route == _plus(before, "sm90", 2 * BERT_TINY["num_layers"])
    losses += [step(ids, packed).item() for _ in range(3)]
    (entry,) = step._captured.values()
    assert entry.graph is not None and losses[-1] < losses[0], losses


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars"])
def test_optimizers_without_a_fused_kernel_replay_as_they_step(name):
    """Captured f32 BERT steps against an eager copy stepped with
    ``loss.backward(); opt.step()``: the same kernels on the same data, so
    the losses and parameters agree but for a library matmul choosing
    another algorithm inside the graph. Token types give every parameter a
    gradient: the compiled step would update one without (a zero gradient,
    as the JAX step's), where the eager step() skips it."""
    card = _card()
    kw = {"RMSProp": dict(momentum=0.9, centered=True), "Lars": dict(lars_coeff=0.01)}
    pt.seed(0)
    model = tbert.BertForPretraining(tbert.BertConfig(**BERT_TINY), device=card)
    eager = copy.deepcopy(model)
    make = getattr(pt.optimizer, name)
    opt = make(learning_rate=1e-2, parameters=model.parameters(), **kw.get(name, {}))
    opt_e = make(learning_rate=1e-2, parameters=eager.parameters(), **kw.get(name, {}))
    step = pt.jit.compile_train_step(model, _bert_loss, opt)
    ids, types, packed = _bert_batch(card, seed=1)
    for _ in range(pt.jit.WARMUP_STEPS + 3):
        loss = step(ids, types, packed)
        ref = _bert_loss(eager(ids, types), packed)
        ref.backward()
        opt_e.step()
        opt_e.clear_grad()
        assert abs(loss.item() - ref.item()) <= 1e-5
    assert step._captured and next(iter(step._captured.values())).graph is not None
    for a, b in zip(model.parameters(), eager.parameters()):
        assert (a - b).abs().max().item() <= 1e-5


# -- the tensor surface on the card (slice 13) ----------------------------------
@pytest.mark.cuda
def test_surface_tensors_live_on_the_card_by_default():
    card = _card()
    previous = pt.get_device()
    pt.set_device("gpu")
    try:
        x = pt.to_tensor(np.arange(6.0).reshape(2, 3))
        assert x.place == pt.CUDAPlace(card.index or 0) and x.dtype == pt.float64
        assert pt.to_tensor([1.5]).dtype == pt.float32 and pt.to_tensor([1]).dtype == pt.int64
        assert pt.zeros([2]).place == x.place and pt.rand([3]).place == x.place
        assert pt.arange(4)._value.device.type == "cuda"
        assert x.cpu().place == pt.CPUPlace() and x.cpu().cuda().place == x.place
        np.testing.assert_array_equal(x.astype("bfloat16").astype("float32").numpy(),
                                      x.numpy().astype(np.float32))
    finally:
        pt.set_device(previous)


@pytest.mark.cuda
def test_surface_generator_on_the_card():
    _card()
    previous = pt.get_device()
    pt.set_device("gpu")
    try:
        g = pt.seed(11)
        assert isinstance(g, pt.Generator) and g.generator.device.type == "cuda"
        a = pt.rand([5]).numpy()
        g.manual_seed(11)
        np.testing.assert_array_equal(pt.rand([5]).numpy(), a)
        state = g.get_state()
        b = pt.randn([4]).numpy()
        g.set_state(state)
        np.testing.assert_array_equal(pt.randn([4]).numpy(), b)
    finally:
        pt.set_device(previous)


@pytest.mark.cuda
def test_surface_inplace_rebinds_on_the_card():
    card = _card()
    x = pt.to_tensor(np.ones((2, 3), np.float32), place=pt.CUDAPlace(card.index or 0))
    view = x.reshape([3, 2])
    x.add_(pt.to_tensor(np.ones((2, 3), np.float32), place=x.place))
    x[0, 0] = 7.0
    assert view.tolist() == [[1.0, 1.0]] * 3 and x._inplace_version == 2
    assert x.numpy()[0].tolist() == [7.0, 2.0, 2.0]


@pytest.mark.cuda
def test_surface_backward_and_grad_on_the_card():
    card = _card()
    place = pt.CUDAPlace(card.index or 0)
    x = pt.to_tensor(np.array([1.0, 2.0, 3.0], np.float32), place=place, stop_gradient=False)
    w = torch.ones(3, device=card, requires_grad=True)
    y = (pt.multiply(x, w) * x).sum()
    y.backward(retain_graph=True)
    assert x.grad.tolist() == [2.0, 4.0, 6.0] and x.grad.place == place
    assert w.grad.tolist() == [1.0, 4.0, 9.0]
    (g,) = pt.grad([(x * x * x).sum()], [x], create_graph=True)
    (gg,) = pt.grad([g.sum()], [x])
    assert g.tolist() == [3.0, 12.0, 27.0] and gg.tolist() == [6.0, 12.0, 18.0]
    with pt.no_grad():
        assert (x * 2).stop_gradient
    with pytest.raises(RuntimeError):
        (x * 2).backward()


@pytest.mark.cuda
def test_surface_model_step_equals_the_torch_step_on_the_card():
    card = _card()
    cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                         max_seq_len=64, dropout=0.0, attn_dropout=0.0)
    pt.seed(0)
    model = tgpt.GPTForPretraining(cfg, device=card)
    twin = copy.deepcopy(model)
    crit = tgpt.GPTPretrainingCriterion()
    data = np.random.default_rng(0).integers(0, 128, (2, 65))
    place = pt.CUDAPlace(card.index or 0)
    ids = pt.to_tensor(data[:, :-1], place=place)
    labels = pt.to_tensor(data[:, 1:], place=place)
    losses = []
    for m, x, y in ((model, ids, labels), (twin, ids._value, labels._value)):
        opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=m.parameters())
        run = []
        for _ in range(2):
            loss = crit(m(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            run.append(float(loss))
        losses.append(run)
    assert losses[0] == losses[1]
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), twin.parameters()))


@pytest.mark.cuda
def test_batch_norm_statistics_accumulate_across_graph_replays_in_place():
    """A compiled step over a BatchNorm2D network: every replay writes the
    running statistics into the same buffers, so after N replays they equal
    an eager copy's after the same N steps."""
    card = _card()
    was = pt.get_device()
    pt.set_device(f"gpu:{card.index or 0}")
    try:
        pt.seed(0)
        net = pt.nn.Sequential(pt.nn.Conv2D(3, 8, 3, padding=1), pt.nn.BatchNorm2D(8),
                               pt.nn.ReLU(), pt.nn.AdaptiveAvgPool2D(1), pt.nn.Flatten(),
                               pt.nn.Linear(8, 4))
        twin = copy.deepcopy(net)
        crit = pt.nn.CrossEntropyLoss()
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((16, 3, 8, 8)).astype(np.float32)).to(card)
        y = torch.from_numpy(rng.integers(0, 4, 16)).to(card)
        opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9, parameters=net.parameters())
        step = pt.jit.compile_train_step(net, lambda o, t: crit(o, t), opt)
        bn, bn_twin = net[1], twin[1]
        ptrs = (bn._mean.data_ptr(), bn._variance.data_ptr())
        n = pt.jit.WARMUP_STEPS + 4  # the eager steps, the capture, then replays
        for _ in range(n):
            step(x, y)
        opt_t = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                      parameters=twin.parameters())
        for _ in range(n):
            loss = crit(twin(x), y)
            loss.backward()
            opt_t.step()
            opt_t.clear_grad()
        torch.cuda.synchronize()
        assert (bn._mean.data_ptr(), bn._variance.data_ptr()) == ptrs
        assert step._captured and all(e.graph is not None for e in step._captured.values())
        torch.testing.assert_close(bn._mean, bn_twin._mean, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(bn._variance, bn_twin._variance, rtol=1e-4, atol=1e-5)
        assert not torch.equal(bn._variance, torch.ones_like(bn._variance))
    finally:
        pt.set_device(was)


@pytest.mark.cuda
def test_conv2d_under_o2_runs_in_bf16():
    card = _card()
    was = pt.get_device()
    pt.set_device(f"gpu:{card.index or 0}")
    try:
        conv = pt.amp.decorate(pt.nn.Conv2D(4, 8, 3, padding=1), level="O2", dtype="bfloat16")
        assert conv.weight.dtype == torch.bfloat16
        x = torch.randn(2, 4, 16, 16, device=card)
        out = conv(x)
        assert out.dtype == torch.bfloat16 and out.device.type == "cuda"
        ref = torch.nn.functional.conv2d(x.bfloat16().float(), conv.weight.float(),
                                         conv.bias.float(), padding=1)
        torch.testing.assert_close(out.float(), ref, rtol=3e-2, atol=3e-2)
        with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
            f32 = pt.nn.Conv2D(4, 8, 3, padding=1)
            assert f32(x).dtype == torch.bfloat16  # conv2d is on the O1 white list
    finally:
        pt.set_device(was)


def _lenet_eager(card, regime, steps=5):
    """bench_mnist_eager's LeNet loop (batch 8) on the card in ``regime``:
    its losses, parameters and moments, and the dispatch counters."""
    from paddle_tpu_torch.core import lazy

    lazy.reset_lazy_state()
    pt.set_flags({"FLAGS_eager_lazy_dispatch": regime != "per_op",
                  "FLAGS_eager_step_capture": regime == "captured",
                  "FLAGS_eager_async_compile": False})
    pt.profiler.reset_dispatch_counters()
    pt.seed(0)
    model = pt.vision.models.LeNet()
    opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    loss_fn = pt.nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    x = pt.to_tensor(rng.standard_normal((8, 1, 28, 28)).astype(np.float32))
    y = pt.to_tensor(rng.integers(0, 10, (8,)))
    losses = []
    for _ in range(steps):
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss)
    values = [float(v) for v in losses]  # each step's own value, read after all of them
    state = [p.detach().clone() for p in model.parameters()]
    state += [v.clone() for p in model.parameters() for v in opt._accumulators[id(p)].values()]
    return values, state, dict(pt.profiler.dispatch_counters())


@pytest.mark.cuda
def test_lazy_and_captured_lenet_steps_are_bitwise_per_op_with_fused_adam():
    """Lazy (a forward graph and a backward graph a segment) and captured (one
    graph a step) LeNet steps on the card, the fused Adam kernel inside the
    captured graph: bitwise the per-op steps; the captured graph holds one
    Adam launch per parameter and its replays call no wrapper."""
    from paddle_tpu_torch.core import lazy

    card = _card()
    was = pt.get_device()
    pt.set_device(f"gpu:{card.index or 0}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    pt.set_flags({"FLAGS_pallas_fused_update": True})
    try:
        ref = _lenet_eager(card, "per_op")
        lz = _lenet_eager(card, "lazy")
        before = tfu.fused_adam.launches
        cap = _lenet_eager(card, "captured")
        assert lz[2]["segment_graph_replays"] >= 3, lz[2]
        assert cap[2]["capture_replays"] == 3 and cap[2]["capture_fallbacks"] == 0, cap[2]
        # 2 eager steps and one capture launch through the wrapper; replays do not
        assert tfu.fused_adam.launches - before == 3 * 10
        for got in (lz, cap):
            assert got[0] == ref[0]
            assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
        assert lazy.step_capture_state()["cuda_graphs"] == 1
    finally:
        torch.backends.cudnn.deterministic = deterministic
        pt.set_flags({"FLAGS_pallas_fused_update": False, "FLAGS_eager_lazy_dispatch": False,
                      "FLAGS_eager_step_capture": True, "FLAGS_eager_async_compile": True})
        lazy.reset_lazy_state()
        pt.set_device(was)


@pytest.mark.cuda
def test_captured_step_rebuilds_after_a_parameter_is_rebound():
    """A parameter whose storage is replaced after the capture invalidates
    the captured program (counted) instead of replaying stale addresses;
    the step after rebuilds it."""
    from paddle_tpu_torch.core import lazy

    card = _card()
    was = pt.get_device()
    pt.set_device(f"gpu:{card.index or 0}")
    lazy.reset_lazy_state()
    pt.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_eager_async_compile": False})
    try:
        pt.seed(0)
        model = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(), pt.nn.Linear(16, 4))
        opt = pt.optimizer.Adam(learning_rate=1e-2, parameters=model.parameters())
        loss_fn = pt.nn.CrossEntropyLoss()
        x = pt.to_tensor(np.ones((4, 8), np.float32))
        y = pt.to_tensor(np.zeros((4,), np.int64))

        def step():
            loss = loss_fn(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return float(loss)

        for _ in range(4):
            step()
        assert pt.profiler.dispatch_counters()["capture_replays"] >= 2
        w = model[0].weight
        w.data = w.data.clone()  # new storage: the graph's address is stale
        pt.profiler.reset_dispatch_counters()
        for _ in range(4):
            step()
        c = pt.profiler.dispatch_counters()
        assert c["capture_invalidations"] == 1, dict(c)
        assert c["capture_fallback_reasons"].get("param_rebound") == 1, dict(c)
        assert c["capture_builds"] == 1 and c["capture_replays"] >= 1, dict(c)
    finally:
        pt.set_flags({"FLAGS_eager_lazy_dispatch": False, "FLAGS_eager_async_compile": True})
        lazy.reset_lazy_state()
        pt.set_device(was)


class _ChangingNet(pt.nn.Layer):
    """An MLP whose forward reads batch norm's and dropout's modes, an
    activation sublayer and a plain attribute."""

    def __init__(self, dropout):
        super().__init__()
        self.fc1 = pt.nn.Linear(8, 16)
        self.bn = pt.nn.BatchNorm1D(16)
        self.act = pt.nn.ReLU()
        self.drop = pt.nn.Dropout(dropout)
        self.fc2 = pt.nn.Linear(16, 4)
        self.scale = 1.0

    def forward(self, x):
        return self.fc2(self.drop(self.act(self.bn(self.fc1(x))))) * self.scale


def _changing_run(regime, steps=12):
    """Adam steps of _ChangingNet (dropout 0) on the card in ``regime``:
    batch norm put into eval mode before step 4, the activation swapped and
    the attribute set before step 8. The losses, parameters, BN statistics
    and moments, and each third's counters."""
    from paddle_tpu_torch.core import lazy

    lazy.reset_lazy_state()
    pt.set_flags({"FLAGS_eager_lazy_dispatch": regime != "per_op",
                  "FLAGS_eager_step_capture": regime == "captured"})
    pt.seed(0)
    model = _ChangingNet(0.0)
    opt = pt.optimizer.Adam(learning_rate=1e-2, parameters=model.parameters())
    loss_fn = pt.nn.CrossEntropyLoss()
    rng = np.random.default_rng(3)
    x = pt.to_tensor(rng.standard_normal((6, 8)).astype(np.float32))
    y = pt.to_tensor(rng.integers(0, 4, (6,)))
    losses, counters = [], []
    for i in range(steps):
        if i in (4, 8):
            counters.append(dict(pt.profiler.dispatch_counters()))
            pt.profiler.reset_dispatch_counters()
            if i == 4:
                model.bn.eval()
            else:
                model.act = pt.nn.Tanh()
                model.scale = 0.5
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss)
    counters.append(dict(pt.profiler.dispatch_counters()))
    state = [t.detach().clone() for t in (*model.parameters(), *model.buffers())]
    state += [v.clone() for p in model.parameters() for v in opt._accumulators[id(p)].values()]
    return [float(v) for v in losses], state, counters


@pytest.mark.cuda
def test_lazy_and_captured_steps_follow_layers_changed_between_steps():
    """Batch norm put into eval mode, and then an activation swapped and an
    attribute set, between steps whose segment graphs (lazy) or whole-step
    graph (captured) already exist: the next steps capture anew and every
    step is bitwise the per-op step. A dropout put into eval mode after its
    segment's graphs were captured stops dropping."""
    from paddle_tpu_torch.core import lazy

    card = _card()
    was = pt.get_device()
    pt.set_device(f"gpu:{card.index or 0}")
    try:
        ref = _changing_run("per_op")
        for regime in ("lazy", "captured"):
            got = _changing_run(regime)
            assert got[0] == ref[0], regime
            assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1])), regime
            for c in got[2]:
                if regime == "lazy":
                    assert c["segment_graph_replays"] >= 2, c
                else:
                    assert c["capture_replays"] >= 1, c
        # dropout: graphs captured in training, then eval mode
        lazy.reset_lazy_state()
        pt.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_eager_step_capture": False})
        pt.seed(0)
        model = _ChangingNet(0.5)
        x = pt.to_tensor(np.ones((6, 8), np.float32))
        for _ in range(3):
            model(x).sum().backward()
        assert pt.profiler.dispatch_counters()["segment_graph_replays"] >= 1
        model.drop.eval()
        lazy_out = [model(x).numpy() for _ in range(2)]
        pt.set_flags({"FLAGS_eager_lazy_dispatch": False})
        eager_out = model(x).numpy()
        assert np.array_equal(lazy_out[0], eager_out) and np.array_equal(lazy_out[1], eager_out)
    finally:
        pt.set_flags({"FLAGS_eager_lazy_dispatch": False, "FLAGS_eager_step_capture": True})
        lazy.reset_lazy_state()
        pt.set_device(was)


@pytest.mark.cuda
def test_segment_graphs_rebuild_after_a_parameter_is_rebound():
    """Under lazy dispatch (no whole-step capture) a parameter whose storage
    is replaced after its segment's graphs were captured drops those graphs
    (counted) instead of replaying stale addresses; every step equals the
    per-op step of a model rebound the same way."""
    from paddle_tpu_torch.core import lazy

    card = _card()
    was = pt.get_device()
    pt.set_device(f"gpu:{card.index or 0}")

    def run(lazy_on):
        lazy.reset_lazy_state()
        pt.set_flags({"FLAGS_eager_lazy_dispatch": lazy_on, "FLAGS_eager_step_capture": False})
        pt.seed(0)
        model = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(), pt.nn.Linear(16, 4))
        opt = pt.optimizer.SGD(learning_rate=1e-2, parameters=model.parameters())
        x = pt.to_tensor(np.ones((4, 8), np.float32))
        losses = []
        for i in range(6):
            if i == 3:
                w = model[0].weight
                w.data = w.data.clone()
                pt.profiler.reset_dispatch_counters()
            loss = model(x).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        return losses, [p.detach().clone() for p in model.parameters()], dict(
            pt.profiler.dispatch_counters())

    try:
        ref = run(False)
        got = run(True)
        assert got[0] == ref[0]
        assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
        c = got[2]
        assert c["segment_graph_invalidations"] == 1 and c["segment_graph_replays"] == 3, c
    finally:
        pt.set_flags({"FLAGS_eager_lazy_dispatch": False, "FLAGS_eager_step_capture": True})
        lazy.reset_lazy_state()
        pt.set_device(was)


def _frozen_steps(card, regime, freeze_at):
    """An MLP's Adam steps on the card in ``regime`` (``per_op``, ``captured``
    under lazy dispatch, or ``compiled`` through ``compile_train_step``) with
    its first layer frozen before step ``freeze_at``: the first layer's
    weights before and after, every parameter, the counters."""
    from paddle_tpu_torch.core import lazy

    lazy.reset_lazy_state()
    pt.set_flags({"FLAGS_eager_lazy_dispatch": regime == "captured",
                  "FLAGS_eager_step_capture": True, "FLAGS_pallas_fused_update": True})
    pt.profiler.reset_dispatch_counters()
    pt.seed(0)
    model = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.Tanh(), pt.nn.Linear(16, 4))
    opt = pt.optimizer.Adam(learning_rate=1e-2, parameters=model.parameters())
    rng = np.random.default_rng(0)
    x = pt.to_tensor(rng.standard_normal((4, 8)).astype(np.float32))
    y = pt.to_tensor(rng.standard_normal((4, 4)).astype(np.float32))
    if freeze_at == 0:
        model[0].weight.stop_gradient = True
        model[0].bias.trainable = False
    compiled = (pt.jit.compile_train_step(model, pt.nn.functional.mse_loss, opt)
                if regime == "compiled" else None)
    frozen = None
    for i in range(8):
        if i == freeze_at:
            if i:
                model[0].weight.stop_gradient = True
                model[0].bias.trainable = False
            frozen = [model[0].weight.detach().clone(), model[0].bias.detach().clone()]
        if compiled is not None:
            compiled(x, y)
            continue
        loss = pt.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    torch.cuda.synchronize()
    after = [model[0].weight.detach().clone(), model[0].bias.detach().clone()]
    # parameters, then the optimizer's states (a frozen parameter has none)
    state = [p.detach().clone() for p in model.parameters()]
    state += [(i, k, v.clone()) for i, p in enumerate(model.parameters())
              for k, v in sorted(opt._accumulators.get(id(p), {}).items())]
    return frozen, after, state, dict(pt.profiler.dispatch_counters())


@pytest.mark.cuda
@pytest.mark.parametrize("freeze_at", [0, 4])
def test_a_frozen_layer_keeps_its_bits_through_eager_and_captured_steps(freeze_at):
    from paddle_tpu_torch.core import lazy

    card = _card()
    was = pt.get_device()
    pt.set_device(f"gpu:{card.index or 0}")
    try:
        ref = _frozen_steps(card, "per_op", freeze_at)
        cap = _frozen_steps(card, "captured", freeze_at)
        for frozen, after, _, _ in (ref, cap):
            assert all(torch.equal(a, b) for a, b in zip(frozen, after))
        assert len(cap[2]) == len(ref[2])
        for a, b in zip(cap[2], ref[2]):
            if isinstance(a, tuple):
                assert a[:2] == b[:2] and torch.equal(a[2], b[2])
            else:
                assert torch.equal(a, b)
        assert cap[3]["capture_replays"] >= 2, cap[3]
        if freeze_at == 0:  # frozen before the step is built: left out of it
            frozen, after, _, _ = _frozen_steps(card, "compiled", 0)
            assert all(torch.equal(a, b) for a, b in zip(frozen, after))
    finally:
        pt.set_flags({"FLAGS_pallas_fused_update": False, "FLAGS_eager_lazy_dispatch": False,
                      "FLAGS_eager_step_capture": True})
        lazy.reset_lazy_state()
        pt.set_device(was)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(96, 40), (40, 96), (3, 70, 50)])
def test_svd_based_linalg_on_the_card_matches_the_cpu(shape):
    """The SVD-based ``paddle.linalg`` functions run cuSOLVER's ``gesvd`` on
    the card (wide matrices through their transpose): within 1e-4 of the
    port on the CPU, and U S Vh gives the matrix back."""
    card = _card()
    rng = np.random.default_rng(3)
    a = rng.standard_normal(shape).astype(np.float32)
    L = pt.linalg
    got = {}
    for place in (f"gpu:{card.index or 0}", "cpu"):
        x = pt.to_tensor(a, place=place)
        u, s, vh = L.svd(x)
        recon = (u.numpy() * s.numpy()[..., None, :]) @ vh.numpy()
        np.testing.assert_allclose(recon, a, atol=1e-4 * np.abs(a).max())
        got[place] = [s.numpy(), L.pinv(x).numpy(), L.cond(x).numpy(),
                      L.matrix_rank(x).numpy()]
    for c, g in zip(got["cpu"], got[f"gpu:{card.index or 0}"]):
        np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-4 * np.abs(c).max())


# BASELINE config 5 at a small width: the ERNIE CTR step (head dim 32, f32)
# as one captured graph holding the tf32x3 kernels, its row gradients
# against eager autograd's, and the host parts of the parameter-server path
# on a card: SparseEmbedding's block, and forked DataLoader workers after
# CUDA is up.
ERNIE_SMALL = dict(vocab_size=300, hidden=64, layers=2, heads=2, seq_len=64, slots=4,
                   sparse_dim=8)


@pytest.mark.cuda
def test_ernie_ctr_step_is_one_graph_of_tf32x3_launches_with_eager_row_grads():
    _card()
    from paddle_tpu_torch.examples import ernie_ctr as ec

    cfg = ec.ErnieCtrConfig(**ERNIE_SMALL)
    table, model, step = ec.build(cfg)
    eager = copy.deepcopy(model)
    opt_e = pt.optimizer.Adam(learning_rate=1e-3, parameters=eager.parameters())
    bce = pt.nn.BCEWithLogitsLoss()
    rng = np.random.default_rng(0)
    for i in range(pt.jit.WARMUP_STEPS + 3):
        slot_ids, tokens, labels = ec.synthetic_batch(cfg, 8, rng)
        flat = slot_ids.reshape(-1)
        rows = table.pull(flat).reshape(8, cfg.slots, cfg.sparse_dim)
        tok, lab = pt.to_tensor(tokens), pt.to_tensor(labels)
        before = tfa.flash_attention_fwd.launches_by_route["tf32x3"]
        loss, (g,) = step(pt.to_tensor(rows), tok, lab)
        launched = tfa.flash_attention_fwd.launches_by_route["tf32x3"] - before
        assert launched == (cfg.layers if i <= pt.jit.WARMUP_STEPS else 0)
        x = pt.to_tensor(rows, stop_gradient=False)
        ref = bce(eager(x, tok), lab)
        ref.backward()
        opt_e.step()
        opt_e.clear_grad()
        size = x.grad._value.abs().max().item()
        assert (g._value - x.grad._value).abs().max().item() <= 1e-6 * size
        assert abs(float(loss) - float(ref)) <= 1e-5
        table.push(flat, g.numpy().reshape(-1, cfg.sparse_dim))
    (entry,) = step._captured.values()
    assert entry.graph is not None


@pytest.mark.cuda
def test_sparse_embedding_uploads_to_the_card_and_pushes_as_on_the_cpu():
    _card()
    from paddle_tpu_torch.distributed.ps import MemorySparseTable, SparseEmbedding

    def run(device):
        previous = pt.get_device()
        pt.set_device(device)
        try:
            table = MemorySparseTable(8, shard_num=2, optimizer="adagrad", learning_rate=0.05,
                                      init_range=0.05, seed=1)
            emb = SparseEmbedding([100, 8], table=table)
            ids = pt.to_tensor(np.array([[1, 2, 2], [3, 1, 4]]))
            rows = emb(ids)
            ((rows * rows).sum()).backward()
            return rows._value.device.type, table.pull(np.arange(1, 5), create=False)
        finally:
            pt.set_device(previous)

    dev_card, card = run("gpu:0")
    dev_cpu, cpu = run("cpu")
    assert (dev_card, dev_cpu) == ("cuda", "cpu")
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_dataloader_workers_fork_after_cuda_is_up():
    card = _card()
    from paddle_tpu_torch.io import DataLoader, Dataset

    torch.zeros(1, device=card)  # CUDA initialised in the parent

    class Images(Dataset):
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return np.full((32, 32, 3), i % 251, np.uint8), np.int64(i)

    multi = list(DataLoader(Images(), batch_size=8, num_workers=4))
    single = list(DataLoader(Images(), batch_size=8))
    assert len(multi) == len(single) == 8
    for m, s in zip(multi, single):
        for a, b in zip(m, s):
            assert a._value.device.type == "cuda" and torch.equal(a._value, b._value)



def _small_gpt(card, recompute=False, seed=0):
    pt.seed(seed)
    cfg = tgpt.GPTConfig(vocab_size=256, hidden_size=128, num_layers=4, num_heads=2,
                         max_seq_len=128, dropout=0.0, attn_dropout=0.0,
                         use_recompute=recompute)
    model = tgpt.GPTForPretraining(cfg, device=card)
    crit = tgpt.GPTPretrainingCriterion(cfg)
    opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                             weight_decay=0.01)
    return model, crit, opt


@pytest.mark.cuda
def test_remat_planned_compiled_step_is_bitwise_the_unplanned_on_the_card():
    """A remat plan at a budget between the unplanned and the uniform peaks:
    feasible, its compiled step (warm-ups and the captured graph) bitwise
    the unplanned one, one more flash forward per recomputed layer."""
    card = _card()
    gen = torch.Generator(device=card).manual_seed(0)
    ids = torch.randint(0, 256, (4, 129), generator=gen, device=card)
    x, y = ids[:, :-1], ids[:, 1:]

    def run(step, n=4):
        return [float(step(x, y)) for _ in range(n)]

    m0, c0, o0 = _small_gpt(card)
    s0 = pt.jit.compile_train_step(m0, c0, o0)
    base = run(s0)
    mu, cu, ou = _small_gpt(card, recompute=True)
    su = pt.jit.compile_train_step(mu, cu, ou)
    run(su, 3)  # the third step's capture is the recorded one
    budget = (s0.memory_plan().peak_bytes + su.memory_plan().peak_bytes) / 2 / 2**20
    plan = s0.plan_remat(budget_mb=budget)
    assert plan.has_cuts and plan.feasible, plan.summary()
    m1, c1, o1 = _small_gpt(card)
    s1 = pt.jit.compile_train_step(m1, c1, o1, memory_plan=plan)
    before = tfa.flash_attention_fwd.launches
    s1(x, y)
    layers = sum(1 for u in plan.remat_units if ".layers." in u[2])
    assert tfa.flash_attention_fwd.launches - before == 4 + layers
    assert [base[0]] + run(s1, 3) == base
    assert all(torch.equal(a, b) for a, b in zip(m0.parameters(), m1.parameters()))


@pytest.mark.cuda
def test_captured_step_is_certified_and_offload_parks_on_the_card():
    """Under FLAGS_check_programs=2 a lazily captured step is certified
    before its first replay; with the Adam moments parked on the host its
    losses stay bitwise, and memory_allocated between steps is lower by the
    parked bytes."""
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.optimizer import offload

    card = _card()
    was = pt.get_device()
    pt.set_device(f"gpu:{card.index or 0}")
    pt.set_flags({"FLAGS_pallas_fused_update": True, "FLAGS_eager_lazy_dispatch": True,
                  "FLAGS_check_programs": 2})
    losses = {}
    try:
        for use in (False, True):
            lazy.reset_lazy_state()
            pt.profiler.reset_dispatch_counters()
            pt.seed(0)
            model = pt.nn.Sequential(pt.nn.Linear(256, 512), pt.nn.ReLU(), pt.nn.Linear(512, 8))
            opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
            if use:
                sched = offload.enable(opt, overhead_pct=1e9, min_bytes=1024)
            x = pt.to_tensor(np.random.default_rng(0).standard_normal((32, 256)).astype(
                np.float32))
            y = pt.to_tensor(np.random.default_rng(1).integers(0, 8, (32,)))
            got = []
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for _ in range(6):
                    loss = pt.nn.CrossEntropyLoss()(model(x), y)
                    loss.backward()
                    opt.step()
                    opt.clear_grad()
                    got.append(float(loss))
            losses[use] = got
            c = pt.profiler.dispatch_counters()
            assert c["capture_equivalence_certified"] >= 1 and c["capture_replays"] >= 1, dict(c)
            if use:
                torch.cuda.synchronize()
                between = torch.cuda.memory_allocated()
                parked = sched.parked_bytes()
                sched.sync()
                assert parked > 0 and torch.cuda.memory_allocated() - between == parked
                offload.disable(opt)
        assert losses[True] == losses[False]
    finally:
        pt.set_flags({"FLAGS_pallas_fused_update": False, "FLAGS_eager_lazy_dispatch": False,
                      "FLAGS_check_programs": 0})
        lazy.reset_lazy_state()
        pt.set_device(was)


@pytest.mark.cuda
def test_engine_pool_sized_by_the_planner_on_the_card():
    """With num_blocks 0 and a budget, the engine's pool is the planner's
    ``(budget - overhead) // block_bytes``; a budget below the overhead
    raises."""
    from paddle_tpu_torch import serving

    card = _card()
    pt.seed(0)
    model = tgpt.GPTForPretraining(tgpt.GPTConfig(vocab_size=256, hidden_size=128,
                                                  num_layers=2, num_heads=2, max_seq_len=256,
                                                  dropout=0.0, attn_dropout=0.0),
                                   device=card).eval()
    eng = serving.Engine(model, serving.ServingConfig(block_size=16, prompt_buckets=[32],
                                                      num_blocks=0, memory_budget_mb=256.0))
    plan = eng._pool_plan
    assert eng._pool.num_blocks == (256 * 2**20 - plan.overhead_bytes) // plan.block_bytes
    out = eng.serve([[1, 2, 3], [4, 5]], max_new_tokens=4)
    assert all(r.status == "ok" for r in out)
    eng.close()
    with pytest.raises(ValueError, match="no room"):
        serving.Engine(model, serving.ServingConfig(block_size=16, prompt_buckets=[32],
                                                    num_blocks=0, memory_budget_mb=0.01))


@pytest.mark.cuda
def test_default_engine_pool_sized_from_the_free_memory_on_the_card():
    """With no num_blocks and no budget, the pool is sized from the card's
    free memory less the headroom; it serves, and half the headroom can be
    allocated beside it."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.analysis import memory as mem

    card = _card()
    pt.seed(0)
    model = tgpt.GPTForPretraining(tgpt.GPTConfig(vocab_size=256, hidden_size=128,
                                                  num_layers=2, num_heads=2, max_seq_len=256,
                                                  dropout=0.0, attn_dropout=0.0),
                                   device=card).eval()
    eng = serving.Engine(model, serving.ServingConfig(block_size=16, prompt_buckets=[32]))
    plan = eng._pool_plan
    assert plan.budget_bytes is not None and eng._pool.num_blocks > 256
    out = eng.serve([[1, 2, 3], [4, 5]], max_new_tokens=4)
    assert all(r.status == "ok" for r in out)
    total = torch.cuda.get_device_properties(card).total_memory
    extra = torch.ones(int(mem.DETECTED_HEADROOM * total / 2), dtype=torch.uint8, device=card)
    assert int(extra[0]) == 1 and int(extra[-1]) == 1
    del extra
    eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("nprocs,backend", [(1, "nccl"), (2, "gloo")])
def test_collectives_of_card_tensors(tmp_path, nprocs, backend):
    """NCCL at world size 1, and two ranks sharing the card over gloo: the
    collectives of card tensors through ``paddle.distributed.spawn`` (the
    ranks are fresh processes: the test's own keeps its CUDA context)."""
    import json

    from tests import torch_dist_cases

    _card()
    pt.distributed.spawn(torch_dist_cases.card_collectives, (str(tmp_path),), nprocs=nprocs,
                         gpus=",".join(["0"] * nprocs), backend=backend)
    xs = [np.arange(4 * nprocs, dtype=np.float32) + 100 * r for r in range(nprocs)]
    total = np.sum(xs, axis=0)
    for r in range(nprocs):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["backend"] == backend and got["device"].startswith("cuda")
        np.testing.assert_array_equal(got["all_reduce"], total)
        np.testing.assert_array_equal(got["all_gather"], np.stack(xs))
        np.testing.assert_array_equal(got["reduce_scatter"], np.split(total, nprocs)[r])
        np.testing.assert_array_equal(
            got["alltoall_single"],
            np.concatenate([np.split(xs[i], nprocs)[r] for i in range(nprocs)]))
