"""The train-mode stem's plain version (ssdx_torch.ops.stem_train) against the
JAX package's Pallas kernel, run in interpret mode on the CPU, in float32.

Inputs are those of tests/test_stem_train.py (B=1).  The forward and the
four batch statistics must agree within 5e-5 of the largest magnitude, and
every nonzero gradient within 1e-4 of its largest magnitude: the two sum
the convolutions and the statistics in different orders.  dx, db1 and db2
are exact zeros on both sides.  The CUDA kernels run only on the card;
chip_smoke.py holds them against this plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdx.ops.pallas_stem_train import stem_train as jax_stem_train
from ssdx_torch.ops import stem_train as st

NAMES = ("dx", "dw1", "db1", "dg1", "dbe1", "dw2", "db2", "dg2", "dbe2")


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (1, 300, 300, 3)).astype(np.float32)
    args = (
        rng.normal(0, 0.1, (3, 3, 3, 64)).astype(np.float32),
        rng.normal(0, 0.1, 64).astype(np.float32),
        rng.normal(1, 0.1, 64).astype(np.float32),
        rng.normal(0, 0.1, 64).astype(np.float32),
        rng.normal(0, 0.1, (3, 3, 64, 64)).astype(np.float32),
        rng.normal(0, 0.1, 64).astype(np.float32),
        rng.normal(1, 0.1, 64).astype(np.float32),
        rng.normal(0, 0.1, 64).astype(np.float32),
    )
    return x, args


def _oihw(a):
    return np.ascontiguousarray(a.transpose(3, 2, 0, 1)) if a.ndim == 4 else a


@pytest.fixture(scope="module")
def jax_side():
    """Outputs and gradients of sum(p^2) through the Pallas kernel (slow in
    interpret mode, so computed once)."""
    x, args = _inputs()
    xj, aj = jnp.asarray(x), tuple(jnp.asarray(a) for a in args)
    run = lambda xi, a: jax_stem_train(xi, *a, 1e-5, True, jnp.float32)
    outs = run(xj, aj)
    grads = jax.grad(lambda xi, a: jnp.sum(run(xi, a)[0] ** 2), argnums=(0, 1))(xj, aj)
    dx, dargs = grads
    grads = [np.asarray(dx)] + [_oihw(np.asarray(g)) for g in dargs]
    return [np.asarray(o) for o in outs], grads


@pytest.fixture(scope="module")
def torch_side():
    x, args = _inputs()
    xt = torch.as_tensor(x).requires_grad_()
    ps = [torch.as_tensor(_oihw(a)).requires_grad_() for a in args]
    outs = st.stem_train_ref(xt, *ps, dtype=torch.float32)
    (outs[0] ** 2).sum().backward()
    return [o.detach().numpy() for o in outs], [xt.grad.numpy()] + [p.grad.numpy() for p in ps]


def _rel_to_max(got, ref):
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))


@pytest.mark.parametrize("i,name", list(enumerate(("p", "mean1", "var1", "mean2", "var2"))))
def test_plain_forward_matches_pallas_f32(jax_side, torch_side, i, name):
    ref, got = jax_side[0][i], torch_side[0][i]
    assert got.shape == ref.shape
    assert _rel_to_max(got, ref) < 5e-5, (name, _rel_to_max(got, ref))


@pytest.mark.parametrize("i,name", list(enumerate(NAMES)))
def test_plain_grads_match_pallas_f32(jax_side, torch_side, i, name):
    ref, got = jax_side[1][i], torch_side[1][i]
    assert got.shape == ref.shape, name
    if name in ("dx", "db1", "db2"):
        assert np.abs(got).max() == 0.0 and np.abs(ref).max() == 0.0, name
        return
    assert _rel_to_max(got, ref) < 1e-4, (name, _rel_to_max(got, ref))


def test_pool_routing_splits_ties_evenly():
    """Hand-made windows: three tied positive maxima, two, a single one, and
    an all-zero window (no gradient), against a numpy loop."""
    t = np.array([[1.0, 1.0, 2.0, 0.5, 0.0, 0.0],
                  [0.5, 1.0, 0.5, 2.0, 0.0, 0.0],
                  [3.0, 0.0, 0.0, 0.0, 0.7, 0.2],
                  [0.0, 0.1, 0.0, 0.0, 0.1, 0.3]], np.float32)
    dp = np.array([[6.0, 4.0, 5.0], [7.0, 8.0, 9.0]], np.float32)
    want = np.zeros_like(t)
    for P in range(2):
        for Q in range(3):
            win = t[2 * P:2 * P + 2, 2 * Q:2 * Q + 2]
            m = win.max()
            if m > 0:
                hit = win == m
                want[2 * P:2 * P + 2, 2 * Q:2 * Q + 2] = hit * dp[P, Q] / hit.sum()
    got = st.pool_routing_ref(torch.as_tensor(t)[None, None], torch.as_tensor(dp)[None, None])
    np.testing.assert_array_equal(got[0, 0].numpy(), want)
    assert want[0, 0] == want[0, 1] == want[1, 1] == 2.0  # 6 split three ways
    assert want[2:, 0:2].sum() == 7.0 and not want[2:, 2:4].any()


def test_wrapper_runs_plain_version_on_cpu():
    x, args = _inputs()
    ps = [torch.as_tensor(_oihw(a)) for a in args]
    before = st.launches
    got = st.stem_train(torch.as_tensor(x), *ps, dtype=torch.float32)
    assert st.launches == before  # no kernel on a CPU tensor
    ref = st.stem_train_ref(torch.as_tensor(x), *ps, dtype=torch.float32)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    x, args = _inputs()
    ps = [torch.as_tensor(_oihw(a)).to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        st.stem_train(torch.as_tensor(x).to("meta"), *ps)
