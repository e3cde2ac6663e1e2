"""The small functions of ported modules that had no counterpart, each
against its JAX-package twin on the same numpy inputs: ``nms.nms_mask``,
``train.checkpoint.save_params_npz`` / ``load_params`` (the float16 bundle
crossing between the packages both ways), ``DetectionDataset.show_with_box``,
``ops.stem.stem_available``, ``ops.stem_train.stem_train_reference_params``
and ``__version__``.
"""
import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd
import pytest
import torch

import ssdx
import ssdx_torch
from ssdx.data.dataset import DetectionDataset as JaxDataset
from ssdx.nms import nms_mask as jax_nms_mask
from ssdx.ops.pallas_stem import stem_available as jax_stem_available
from ssdx.ops.pallas_stem_train import stem_train_reference_params as jax_stem_params
from ssdx.train import checkpoint as jax_ckpt
from ssdx_torch.data.dataset import DetectionDataset
from ssdx_torch.export import fold_batchnorm
from ssdx_torch.model import SSD300
from ssdx_torch.nms import nms_mask
from ssdx_torch.ops.stem import stem_available
from ssdx_torch.ops.stem_train import stem_train_reference_params
from ssdx_torch.train import checkpoint as ckpt
from ssdx_torch.weights import state_dict_from_jax, variables_from_torch

from torch_parity import flatten, random_variables


def test_version_matches_jax():
    assert ssdx_torch.__version__ == ssdx.__version__ == "0.1.0"


def _candidates(seed, n=120):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(20, 280, (8, 2))
    c = centres[rng.integers(0, 8, n)] + rng.normal(0, 12, (n, 2))
    wh = rng.uniform(10, 60, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    valid = rng.random(n) < 0.9
    labels = rng.integers(0, 5, n).astype(np.int32)
    return boxes, scores, valid, labels


@pytest.mark.parametrize("with_labels", [False, True])
@pytest.mark.parametrize("seed,thresh", [(0, 0.3), (1, 0.5), (2, 0.0), (3, -0.2)])
def test_nms_mask_matches_jax(seed, thresh, with_labels):
    boxes, scores, valid, labels = _candidates(seed)
    lab = labels if with_labels else None
    want = np.asarray(jax_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                                   thresh, None if lab is None else jnp.asarray(lab)))
    got = nms_mask(torch.as_tensor(boxes), torch.as_tensor(scores), torch.as_tensor(valid),
                   thresh, None if lab is None else torch.as_tensor(lab))
    assert got.shape == (len(scores),) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()


def _assert_bundle(blob, variables):
    got, src = flatten(blob), flatten(variables)
    assert sorted(got) == sorted(src)
    for k, v in got.items():
        assert v.dtype == np.float32, k
        np.testing.assert_array_equal(v.astype(np.float16), src[k].astype(np.float16), err_msg=k)
        np.testing.assert_array_equal(v, src[k].astype(np.float16).astype(np.float32), err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_bundle_crosses_between_packages(writer, tmp_path):
    v = random_variables(0.25, seed=4)
    path = tmp_path / "w.npz"
    if writer == "port":
        # the port writes what its own model holds: torch tensors from the bridge
        model = SSD300(6, width_mult=0.25)
        model.load_state_dict(state_dict_from_jax(v, False))
        v = variables_from_torch(model)
        ckpt.save_params_npz(v["params"], v["batch_stats"], path)
        blob = jax_ckpt.load_params(path)
    else:
        jax_ckpt.save_params_npz(v["params"], v["batch_stats"], path)
        blob = ckpt.load_params(path)
    assert path.read_bytes()[:2] == b"PK"
    _assert_bundle(blob, v)
    # both readers give the same arrays from the same file
    _assert_bundle(ckpt.load_params(path), flatten_back(flatten(jax_ckpt.load_params(path))))


def flatten_back(flat):
    out = {}
    for key, val in flat.items():
        node = out
        parts = key.strip("/").split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def test_save_params_npz_takes_tensors(tmp_path):
    params = {"a": {"kernel": torch.linspace(-1, 1, 12).reshape(3, 4)}}
    stats = {"a": {"mean": torch.ones(4)}}
    path = ckpt.save_params_npz(params, stats, tmp_path / "t.weights")
    blob = jax_ckpt.load_params(path)
    np.testing.assert_array_equal(blob["params"]["a"]["kernel"],
                                  params["a"]["kernel"].numpy().astype(np.float16).astype(np.float32))
    assert blob["batch_stats"]["a"]["mean"].tolist() == [1.0] * 4


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("show_with_box")
    rng = np.random.default_rng(9)
    rows = []
    for i in range(3):
        cv2.imwrite(str(d / f"s{i}.jpg"), rng.integers(0, 255, (64, 80, 3), np.uint8))
        for k in range(i + 1):
            rows.append(dict(filename=f"s{i}.jpg", width=80, height=64,
                             **{"class": ["car", "truck"][k % 2]},
                             xmin=4 + 10 * k, ymin=6, xmax=40 + 10 * k, ymax=50))
    pd.DataFrame(rows).to_csv(d / "ann.csv", index=False)
    return d


def _pixels(fig):
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return out


@pytest.mark.parametrize("index", [0, 2])
def test_show_with_box_matches_jax(tiny_dir, index):
    pred = {"boxes": np.array([[10, 10, 200, 250]], np.float32), "labels": np.array([1])}
    kw = dict(label=True, pred_dict=pred, pred_label=True)
    ours = DetectionDataset(tiny_dir).show_with_box(index, **kw)
    theirs = JaxDataset(tiny_dir).show_with_box(index, **kw)
    assert len(ours.axes[0].patches) == len(theirs.axes[0].patches) == index + 2
    assert [t.get_text() for t in ours.axes[0].texts] == [t.get_text() for t in theirs.axes[0].texts]
    np.testing.assert_array_equal(_pixels(ours), _pixels(theirs))
    with pytest.raises(ValueError, match="Index should be between 0 and 3"):
        DetectionDataset(tiny_dir).show_with_box(-1)


@pytest.mark.parametrize("fold", [False, True])
def test_stem_available_matches_jax(fold):
    v = random_variables(0.25, seed=5)
    jv = fold_batchnorm(v) if fold else v
    model = SSD300(6, width_mult=0.25, fold_bn=fold)
    model.load_state_dict(state_dict_from_jax(jv, fold))
    assert stem_available(model.state_dict()) == jax_stem_available(jv["params"]) is True
    assert stem_available(dict(model.named_parameters())) is True
    partial_sd = {k: t for k, t in model.state_dict().items() if not k.startswith("layers.1.")}
    partial_tree = {k: t for k, t in jv["params"].items() if k != "ConvBNRelu_1"}
    assert stem_available(partial_sd) == jax_stem_available(partial_tree) is False
    assert stem_available(None) == jax_stem_available(None) is False


def test_stem_train_reference_params_match_jax_through_the_bridge():
    v = random_variables(1.0, seed=6)
    model = SSD300(6)
    model.load_state_dict(state_dict_from_jax(v, False))
    ours = stem_train_reference_params(dict(model.named_parameters()))
    theirs = jax_stem_params(v["params"])
    assert len(ours) == len(theirs) == 8
    assert all(t.requires_grad for t in ours)
    for i, (o, t) in enumerate(zip(ours, theirs)):
        o = o.detach().numpy()
        if o.ndim == 4:  # OIHW -> HWIO, the bridge's kernel layout
            o = o.transpose(2, 3, 1, 0)
        np.testing.assert_array_equal(o, np.asarray(t), err_msg=str(i))
    assert [tuple(t.shape) for t in ours] == [(64, 3, 3, 3), (64,), (64,), (64,),
                                              (64, 64, 3, 3), (64,), (64,), (64,)]
    # the state dict names the same tensors
    sd_params = stem_train_reference_params(model.state_dict())
    assert all(torch.equal(a.detach(), b) for a, b in zip(ours, sd_params))
