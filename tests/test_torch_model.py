"""ssdx_torch.model.SSD300 against ssdx.model.SSD300 (CPU, f32, random weights).

Tolerance: max abs error <= 1e-3 * max|ref|, because XLA:CPU and oneDNN sum
the convolutions in different orders.
"""
import numpy as np
import pytest
import torch

from ssdx.export import fold_batchnorm as jax_fold
from ssdx.model import SSD300 as JaxSSD300
from ssdx_torch import resolve_device
from ssdx_torch.export import fold_batchnorm
from ssdx_torch.model import SSD300, backbone_channels, init_variables
from ssdx_torch.weights import state_dict_from_jax, variables_from_torch
from torch_parity import flatten, random_variables

WM = 0.25


@pytest.fixture(scope="module")
def variables():
    return random_variables(WM, seed=1)


@pytest.mark.parametrize("stem_input", [False, True])
@pytest.mark.parametrize("fold_bn", [False, True])
def test_forward_matches_jax(variables, fold_bn, stem_input):
    rng = np.random.default_rng(5)
    c_stem = backbone_channels(WM)[1][1]
    shape = (2, 150, 150, c_stem) if stem_input else (2, 300, 300, 3)
    x = rng.normal(0, 1, shape).astype(np.float32)

    jv = jax_fold(variables) if fold_bn else variables
    ref_loc, ref_cls = JaxSSD300(num_classes=6, width_mult=WM, fold_bn=fold_bn,
                                 stem_input=stem_input).apply(jv, x)
    tv = fold_batchnorm(variables) if fold_bn else variables
    model = SSD300(6, fold_bn=fold_bn, stem_input=stem_input, width_mult=WM)
    model.load_state_dict(state_dict_from_jax(tv, fold_bn))
    with torch.inference_mode():
        loc, cls = model.eval()(torch.as_tensor(x))

    assert loc.shape == (2, 8732, 4) and cls.shape == (2, 8732, 6)
    assert loc.dtype == cls.dtype == torch.float32
    for got, ref in ((loc, ref_loc), (cls, ref_cls)):
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max()
        assert err <= 1e-3 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_train_forward_matches_jax(variables):
    """forward(train=True): batch-statistics BN with flax's biased variance,
    and the running statistics updated as 0.9 * old + 0.1 * batch.  At B=2
    the BN layers see 50 (5x5 maps) to 180,000 values per channel, so an
    unbiased variance would be up to 2 % larger and move a running variance
    by more than the limit.  Outputs within 1e-3 of their max, statistics
    within 1e-4 of theirs."""
    x = np.random.default_rng(6).normal(0, 1, (2, 300, 300, 3)).astype(np.float32)
    (ref_loc, ref_cls), mutated = JaxSSD300(num_classes=6, width_mult=WM).apply(
        variables, x, train=True, mutable=["batch_stats"])
    model = SSD300(6, width_mult=WM)
    model.load_state_dict(state_dict_from_jax(variables, False))
    with torch.no_grad():
        loc, cls = model(torch.as_tensor(x), train=True)
    for got, ref in ((loc, ref_loc), (cls, ref_cls)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()
    ref_stats = flatten(mutated["batch_stats"])
    got_stats = flatten(variables_from_torch(model)["batch_stats"])
    assert sorted(ref_stats) == sorted(got_stats)
    for k, ref in ref_stats.items():
        err = np.abs(got_stats[k] - ref).max() / np.abs(ref).max()
        assert err < 1e-4, (k, err)


def test_init_variables_tree_matches_jax_layout():
    """The port's random init has the JAX tree's keys and shapes."""
    ref = flatten(random_variables(WM))
    got = flatten(init_variables(6, seed=0, width_mult=WM))
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    k = got["/params/ConvBNRelu_7/Conv_0/kernel"]
    assert np.abs(k).max() <= 2.0 * np.sqrt(2.0 / (9 * k.shape[-1])) / 0.87962566103423978


def test_resolve_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
