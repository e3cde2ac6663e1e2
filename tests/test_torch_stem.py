"""The stem's plain version (ssdx_torch.ops.stem) against the JAX package's
Pallas stem kernel, run in interpret mode on the CPU, in float32.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against this plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdx.ops.pallas_stem import stem_conv_pool as jax_stem
from ssdx_torch.ops import stem


@pytest.fixture(scope="module")
def stem_data():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (1, 300, 300, 3)).astype(np.float32)
    w1 = rng.normal(0, 0.15, (3, 3, 3, 64)).astype(np.float32)
    b1 = rng.normal(0, 0.3, (64,)).astype(np.float32)
    w2 = rng.normal(0, 0.08, (3, 3, 64, 64)).astype(np.float32)
    b2 = rng.normal(0, 0.3, (64,)).astype(np.float32)
    return x, w1, b1, w2, b2


def _torch_args(x, w1, b1, w2, b2):
    oihw = lambda w: torch.as_tensor(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    return (torch.as_tensor(x), oihw(w1), torch.as_tensor(b1), oihw(w2),
            torch.as_tensor(b2))


def test_plain_stem_matches_pallas_f32(stem_data):
    x, w1, b1, w2, b2 = stem_data
    params = {
        "ConvBNRelu_0": {"Conv_0": {"kernel": w1, "bias": b1}},
        "ConvBNRelu_1": {"Conv_0": {"kernel": w2, "bias": b2}},
    }
    ref = np.asarray(jax_stem(jnp.asarray(x), params, interpret=True,
                              compute_dtype=jnp.float32))
    got = stem.stem_conv_pool_ref(*_torch_args(*stem_data), dtype=torch.float32).numpy()
    assert got.shape == ref.shape == (1, 150, 150, 64)
    # Same tolerance as tests/test_pallas_stem.py: the Pallas kernel sums the
    # taps in another order, so a conv1_1 pre-activation on the ReLU knife
    # edge can flip under f32 rounding and propagate ~1e-3.
    err = np.abs(got - ref)
    assert float(np.quantile(err, 0.9999)) < 1e-4, float(np.quantile(err, 0.9999))
    assert float(err.max()) < 5e-3, float(err.max())


def test_wrapper_runs_plain_version_on_cpu(stem_data):
    args = _torch_args(*stem_data)
    before = stem.launches
    got = stem.stem_conv_pool(*args, dtype=torch.float32)
    assert stem.launches == before  # no kernel on a CPU tensor
    torch.testing.assert_close(got, stem.stem_conv_pool_ref(*args, dtype=torch.float32),
                               rtol=0, atol=0)


def test_wrapper_refuses_other_devices(stem_data):
    args = [a.to("meta") for a in _torch_args(*stem_data)]
    with pytest.raises(ValueError, match="unsupported device"):
        stem.stem_conv_pool(*args)
