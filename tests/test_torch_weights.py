"""ssdx_torch.weights and ssdx_torch.export against the JAX package."""
import numpy as np
import pytest

from ssdx.export import fold_batchnorm as jax_fold
from ssdx.train.checkpoint import load_params as jax_load_params
from ssdx.train.checkpoint import save_params
from ssdx_torch.export import fold_batchnorm
from ssdx_torch.model import SSD300
from ssdx_torch.weights import load_params, state_dict_from_jax
from torch_parity import DEMO_WEIGHTS, flatten, random_variables


@pytest.mark.parametrize("fmt", ["npz", "pickle"])
def test_load_params_matches_jax(fmt, tmp_path):
    if fmt == "npz":
        path = DEMO_WEIGHTS
    else:
        v = random_variables(0.125)
        path = save_params(v["params"], v["batch_stats"], tmp_path / "w.weights")
    ref, got = flatten(jax_load_params(path)), flatten(load_params(path))
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if fmt == "npz":
        assert len(ref) == 150


def test_fold_batchnorm_matches_jax():
    v = random_variables(0.25, seed=3)
    ref = flatten(jax_fold(v))
    got = flatten(fold_batchnorm(v))
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("fold_bn", [False, True])
def test_state_dict_loads_strict(fold_bn):
    v = random_variables(0.25, seed=4)
    tree = fold_batchnorm(v) if fold_bn else v
    model = SSD300(6, fold_bn=fold_bn, width_mult=0.25)
    sd = state_dict_from_jax(tree, fold_bn)
    model.load_state_dict(sd)  # strict: every key and shape matches
    k = np.asarray(tree["params"]["ConvBNRelu_13"]["Conv_0"]["kernel"])  # conv6, HWIO
    np.testing.assert_array_equal(sd["layers.13.conv.weight"].numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))
    head = sd["heads.0.weight"]  # box channels first, then class channels
    np.testing.assert_array_equal(
        head[:16].numpy(), np.transpose(v["params"]["box_head_0"]["kernel"], (3, 2, 0, 1)))
    assert head.shape[0] == 4 * (4 + 6)


def test_state_dict_refuses_unfolded_tree():
    with pytest.raises(ValueError):
        state_dict_from_jax(random_variables(0.125), fold_bn=True)
