"""The port's 2x2 max pool (ssdx_torch.ops.pool) against the JAX package's
``max_pool_2x2`` with its Pallas backward in interpret mode, on the shapes of
tests/test_pallas_pool.py.

The forward is a maximum and must be equal.  The backward must be equal
(atol 0) on tie-free input, where both give each window's cotangent to one
position, and on the all-ones tie case, where both split it four ways.  The
CUDA kernels run only on the card; chip_smoke.py holds them against this
plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdx.ops.pallas_pool import max_pool_2x2 as jax_pool
from ssdx_torch.ops import pool

SHAPES = [(2, 12, 16, 64), (1, 8, 16, 128), (2, 10, 300, 64), (1, 7, 9, 8)]


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_equals_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ref = np.asarray(jax_pool(jnp.asarray(x), True))
    got = pool.max_pool_2x2_ref(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(2, 12, 32, 64), (1, 7, 9, 8)])
def test_backward_equals_jax_no_ties(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=(shape[0], shape[1] // 2, shape[2] // 2, shape[3])).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jax_pool(t, True), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.as_tensor(x).requires_grad_()
    pool.max_pool_2x2_ref(xt).backward(torch.as_tensor(g))
    np.testing.assert_allclose(xt.grad.numpy(), ref, atol=0, rtol=0)


def test_tie_split_equals_jax():
    x = np.ones((1, 2, 16, 64), np.float32)
    g = np.full((1, 1, 8, 64), 4.0, np.float32)
    _, vjp = jax.vjp(lambda t: jax_pool(t, True), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.as_tensor(x).requires_grad_()
    pool.max_pool_2x2_ref(xt).backward(torch.as_tensor(g))
    np.testing.assert_array_equal(xt.grad.numpy(), ref)
    np.testing.assert_array_equal(np.unique(xt.grad.numpy()), [1.0])


def test_partial_ties_against_a_numpy_loop():
    """Windows with three, two and one maximal positions, negative maxima
    included (the pool has no ReLU: a negative maximum still takes gradient),
    in bfloat16: the share g / cnt is rounded once."""
    t = np.array([[1.0, 1.0, 2.0, 0.5, -1.0, -3.0],
                  [0.5, 1.0, 0.5, 2.0, -1.0, -2.0],
                  [3.0, 0.0, 0.0, 0.0, 0.7, 0.2],
                  [0.0, 0.1, 0.0, 0.0, 0.1, 0.3],
                  [9.0, 9.0, 9.0, 9.0, 9.0, 9.0]], np.float32)  # odd row: no window
    dp = np.array([[7.0, 4.0, 5.0], [7.0, 8.0, 9.0]], np.float32)
    want = np.zeros_like(t)
    for P in range(2):
        for Q in range(3):
            win = t[2 * P:2 * P + 2, 2 * Q:2 * Q + 2]
            hit = win == win.max()
            want[2 * P:2 * P + 2, 2 * Q:2 * Q + 2] = hit * dp[P, Q] / hit.sum()
    y = torch.as_tensor(t)[None, :, :, None].repeat(1, 1, 1, 8).to(torch.bfloat16).requires_grad_()
    g = torch.as_tensor(dp)[None, :, :, None].repeat(1, 1, 1, 8).to(torch.bfloat16)
    pool.max_pool_2x2_ref(y).backward(g)
    want_bf = torch.as_tensor(want).to(torch.bfloat16)
    assert torch.equal(y.grad[0, :, :, 3], want_bf)
    assert want[4].sum() == 0 and float(want_bf[0, 0]) == float(torch.tensor(7 / 3).bfloat16())


def test_wrapper_runs_plain_version_on_cpu_and_gradcheck():
    before = (pool.launches, pool.launches_fwd)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(1, 5, 6, 8))).requires_grad_()
    assert x.dtype == torch.float64
    assert torch.autograd.gradcheck(pool.max_pool_2x2, (x,), eps=1e-6, atol=1e-5)
    assert (pool.launches, pool.launches_fwd) == before  # no kernel on a CPU tensor
    torch.testing.assert_close(pool.max_pool_2x2(x), pool.max_pool_2x2_ref(x), rtol=0, atol=0)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="unsupported device"):
        pool.max_pool_2x2(torch.zeros((1, 4, 4, 8), device="meta"))
    for bad, msg in ((torch.zeros((1, 4, 4, 12)), "C % 8"),
                     (torch.zeros((1, 4, 4, 8), dtype=torch.float16), "bfloat16 or float32"),
                     (torch.zeros((4, 4, 8)), r"\[B,H,W,C\]")):
        with pytest.raises(ValueError, match=msg):
            pool.check_nhwc("max_pool_2x2", bad)
