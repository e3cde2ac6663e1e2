"""The port's fused BN + ReLU + pool (ssdx_torch.ops.bn_relu_pool) against the
JAX package's ``bn_relu_pool``: its Pallas passes in interpret mode and its
XLA path, on the inputs and the loss of tests/test_fused_bn_pool.py (the loss
weighs ``mean`` and ``var``, so their cotangents are exercised).

In float32 the pooled map and the statistics must agree within 1e-5 and each
gradient within 1e-5 of its largest magnitude: the two packages sum the
statistics and the BN reductions in different orders.  The bfloat16 case has
its own limits, stated there.  The CUDA kernels run only on the card;
chip_smoke.py holds them against this plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssdx.ops.fused_bn_pool import bn_relu_pool as jax_brp
from ssdx_torch.ops import bn_relu_pool as brp


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(1, 0.2, C).astype(np.float32),
            rng.normal(0, 0.2, C).astype(np.float32))


def _loss_np(C):
    return np.arange(C, dtype=np.float32), 0.5


def _jax_side(x, gamma, beta, ceil, tie_split, backend, dtype=jnp.float32):
    C = x.shape[-1]
    args = (jnp.asarray(x).astype(dtype), jnp.asarray(gamma), jnp.asarray(beta))

    def f(a):
        p, mean, var = jax_brp(*a, 1e-5, ceil, tie_split, backend)
        loss = (jnp.sum(p.astype(jnp.float32) ** 2)
                + jnp.sum(mean * jnp.arange(C, dtype=mean.dtype)) + jnp.sum(var * 0.5))
        return loss, (p, mean, var)

    (_, outs), grads = jax.value_and_grad(f, has_aux=True)(args)
    to_np = lambda t: np.asarray(t.astype(jnp.float32))
    return [to_np(o) for o in outs], [to_np(g) for g in grads]


def _torch_side(fn, x, gamma, beta, ceil, tie_split, dtype=torch.float32):
    C = x.shape[-1]
    xt = torch.as_tensor(x).to(dtype).requires_grad_()
    gt, bt = torch.as_tensor(gamma).requires_grad_(), torch.as_tensor(beta).requires_grad_()
    p, mean, var = fn(xt, gt, bt, 1e-5, ceil, tie_split)
    loss = (p.float() ** 2).sum() + (mean * torch.arange(C, dtype=mean.dtype)).sum() \
        + (var * 0.5).sum()
    loss.backward()
    return ([t.detach().float().numpy() for t in (p, mean, var)],
            [t.grad.float().numpy() for t in (xt, gt, bt)])


def _check(got, ref, atol_out, rtol_grad):
    for name, g, r in zip(("p", "mean", "var"), got[0], ref[0]):
        assert g.shape == r.shape, name
        assert np.abs(g - r).max() <= atol_out, (name, np.abs(g - r).max())
    for name, g, r in zip(("dx", "dgamma", "dbeta"), got[1], ref[1]):
        assert g.shape == r.shape, name
        err, scale = np.abs(g - r).max(), np.abs(r).max() + 1e-6
        assert err <= rtol_grad * scale, (name, err, scale)


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
def test_matches_jax_f32(backend):
    x, gamma, beta = _inputs((2, 12, 16, 64))
    ref = _jax_side(x, gamma, beta, False, True, backend)
    got = _torch_side(brp.bn_relu_pool_ref, x, gamma, beta, False, True)
    _check(got, ref, 1e-5, 1e-5)


def test_odd_ceil_matches_jax_xla():
    x, gamma, beta = _inputs((2, 7, 9, 8), seed=1)
    ref = _jax_side(x, gamma, beta, True, True, "xla")
    got = _torch_side(brp.bn_relu_pool_ref, x, gamma, beta, True, True)
    assert got[0][0].shape == (2, 4, 5, 8)
    _check(got, ref, 1e-5, 1e-5)


def test_tie_case_matches_jax():
    """All-equal windows: every position takes a quarter of the cotangent.
    beta = 1 keeps the BN output (= beta) positive."""
    x = np.ones((1, 2, 16, 64), np.float32)
    gamma, beta = np.ones(64, np.float32), np.ones(64, np.float32)
    ref = _jax_side(x, gamma, beta, False, True, "pallas_interpret")
    got = _torch_side(brp.bn_relu_pool_ref, x, gamma, beta, False, True)
    _check(got, ref, 1e-5, 1e-5)
    assert np.ptp(got[1][0], axis=(0, 1, 2)).max() < 1e-6  # uniform within each channel


def test_no_tie_split_matches_jax_xla():
    """Quantised input makes real ties; with tie_split off each tied maximum
    takes the whole cotangent."""
    x, gamma, beta = _inputs((2, 8, 8, 16), seed=3)
    x = np.round(x * 2) / 2
    ref = _jax_side(x, gamma, beta, False, False, "xla")
    got = _torch_side(brp.bn_relu_pool_ref, x, gamma, beta, False, False)
    _check(got, ref, 1e-5, 1e-5)
    split = _torch_side(brp.bn_relu_pool_ref, x, gamma, beta, False, True)
    assert np.abs(split[1][0] - got[1][0]).max() > 1e-3  # the flag changes the routing


def test_bf16_matches_jax_pallas():
    """bfloat16 input.  Both normalize in float32 and round p once, so p may
    differ by one bfloat16 step (2^-7 relative) where a statistic's last
    bit moves the value across a rounding boundary; dx is rounded to bfloat16
    on both sides: 2^-7 of its largest magnitude; the float32 reductions
    within 1e-4."""
    x, gamma, beta = _inputs((2, 12, 16, 64), seed=4)
    ref = _jax_side(x, gamma, beta, False, True, "pallas_interpret", jnp.bfloat16)
    got = _torch_side(brp.bn_relu_pool_ref, x, gamma, beta, False, True, torch.bfloat16)
    assert np.abs(got[0][0] - ref[0][0]).max() <= 2.0 ** -7 * np.abs(ref[0][0]).max()
    for i in (1, 2):
        assert np.abs(got[0][i] - ref[0][i]).max() <= 1e-5
    assert np.abs(got[1][0] - ref[1][0]).max() <= 2.0 ** -7 * np.abs(ref[1][0]).max()
    for i in (1, 2):
        assert np.abs(got[1][i] - ref[1][i]).max() <= 1e-4 * np.abs(ref[1][i]).max()


@pytest.mark.parametrize("ceil", [False, True])
def test_matches_torch_autograd_of_the_unfused_composition(ceil):
    """F.batch_norm + relu + amax over the windows, differentiated by
    autograd (amax splits ties evenly, relu'(0) = 0): an independent oracle,
    also for floor mode on odd extents, which the JAX function does not take."""
    x, gamma, beta = _inputs((2, 7, 9, 8), seed=5)
    got = _torch_side(brp.bn_relu_pool_ref, x, gamma, beta, ceil, True)

    def unfused(xt, gt, bt, eps, ceil, tie_split):
        xc = xt.permute(0, 3, 1, 2)
        mean = xc.mean((0, 2, 3))
        var = (xc * xc).mean((0, 2, 3)) - mean * mean
        y = F.relu(F.batch_norm(xc, None, None, gt, bt, training=True, eps=eps))
        y = y.permute(0, 2, 3, 1)
        from ssdx_torch.ops.pool import windows
        return windows(y, ceil, float("-inf")).amax((2, 4)), mean, var

    ref = _torch_side(unfused, x, gamma, beta, ceil, True)
    _check(got, ref, 1e-5, 1e-5)


def test_relu_boundary_takes_no_gradient():
    """A window whose maximum is exactly 0 after the ReLU routes nothing:
    gamma = 0 and beta = 0 make every y zero."""
    x, _, _ = _inputs((1, 4, 4, 8), seed=6)
    xt = torch.as_tensor(x).requires_grad_()
    gamma = torch.zeros(8, requires_grad=True)
    beta = torch.zeros(8, requires_grad=True)
    p, _, _ = brp.bn_relu_pool_ref(xt, gamma, beta)
    p.sum().backward()
    assert float(p.detach().abs().max()) == 0.0
    assert float(xt.grad.abs().max()) == 0.0 and float(beta.grad.abs().max()) == 0.0


def test_wrapper_on_cpu_takes_the_plain_route_and_gradcheck():
    before = (brp.launches, brp.launches_bwd)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(2, 3, 4, 8))).requires_grad_()
    gamma = torch.as_tensor(rng.normal(1, 0.2, 8)).requires_grad_()
    beta = torch.as_tensor(rng.normal(0, 0.2, 8)).requires_grad_()
    for ceil in (False, True):
        fn = lambda a, g, b: brp.bn_relu_pool(a, g, b, 1e-5, ceil, True)
        assert torch.autograd.gradcheck(fn, (x, gamma, beta), eps=1e-6, atol=1e-5)
    assert (brp.launches, brp.launches_bwd) == before  # no kernel on a CPU tensor
    p, mean, var = brp.bn_relu_pool(x, gamma, beta)
    p.sum().backward()  # missing cotangents of mean and var count as zeros
    assert torch.isfinite(x.grad).all() and mean.dtype == var.dtype == torch.float64


def test_wrapper_refuses_what_the_kernels_do_not_take():
    g = torch.ones(8)
    with pytest.raises(ValueError, match="gamma, beta"):
        brp.bn_relu_pool(torch.zeros((1, 4, 4, 8)), torch.ones(4), torch.ones(4))
    with pytest.raises(ValueError, match="unsupported device"):
        brp.bn_relu_pool(torch.zeros((1, 4, 4, 8), device="meta"), g.to("meta"), g.to("meta"))
    with pytest.raises(ValueError, match="share a device"):
        brp.bn_relu_pool(torch.zeros((1, 4, 4, 8), device="meta"), g, g)
