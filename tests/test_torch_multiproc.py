"""Two ranks equal one process on the global batch (CPU, f32, gloo).

One spawn of two worker processes (tests/torch_dist.py) at
``width_mult=0.25``; each test reads what the ranks wrote.

* Train step, 2 + 2 images: the reported loss equals the one-process
  4-image step's within 1e-5 relative, the first update equals it within
  2e-2 L2-relative for every parameter but the conv biases under a BN (the
  limit and the exclusion of tests/test_torch_train_step.py: those biases'
  gradient is rounding noise), the running statistics within 1e-4 of their
  largest magnitude, and the two ranks end bit-identical.  The JAX package's
  step on the same batch is held to the same loss within 1e-4.
* Eval step with a wrap-padded tail: global losses within 1e-5, each rank's
  detections equal to its rows of the one-process result.
* Loader: each rank decodes its half of every global batch, the halves
  together are the one-process batches (eval and train, the augmentation
  included), the count is the global one, and the epoch order equals the JAX
  loader's.
* ``Detector(mesh=)``: forward on 8 and on an uneven 5 images within
  ``atol=2e-4`` of one process, predictions with equal labels (the limits of
  tests/test_mesh_inference.py).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as D
from ssdx import priors as JP
from ssdx.data.dataset import DetectionDataset as JaxDataset
from ssdx.data.pipeline import DetectionLoader as JaxLoader
from ssdx.model import SSD300 as JaxSSD300
from ssdx.train import schedule as JS
from ssdx.train import step as JT
from ssdx_torch import priors as P
from ssdx_torch.api import Detector
from ssdx_torch.data.dataset import DetectionDataset
from ssdx_torch.data.pipeline import DetectionLoader
from ssdx_torch.train.step import Batch, make_eval_step, make_train_step
from ssdx_torch.weights import variables_from_torch
from torch_parity import flatten, random_variables

PRI = P.create_priors()
PRI_XYXY = P.priors_xyxy(PRI)


def _toy_dir(d):
    import cv2
    import pandas as pd

    d.mkdir()
    rng = np.random.default_rng(5)
    rows = []
    for i in range(17):  # an odd count: the eval tail is wrap-padded
        name = f"m{i:02d}.jpg"
        cv2.imwrite(str(d / name), rng.integers(0, 255, (64, 64, 3), np.uint8))
        rows.append(dict(filename=name, width=64, height=64,
                         **{"class": ["car", "truck"][i % 2]},
                         xmin=4, ymin=4, xmax=40, ymax=40))
    pd.DataFrame(rows).to_csv(d / "ann.csv", index=False)
    return d


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("multiproc")
    variables = random_variables(D.WM, seed=3)
    (d / "variables.pkl").write_bytes(pickle.dumps(variables))
    _toy_dir(d / "toy")
    jobs = ["train_step", "loader", "detector"]
    D.run_ranks(jobs, d)
    return variables, d, [{j: D.load(d, j, r) for j in jobs} for r in range(2)]


@pytest.fixture(scope="module")
def one_process(ranks):
    variables = ranks[0]
    state = D._state(variables, None)
    batch = Batch(*D.train_arrays())
    ev = make_eval_step(state.model, PRI, PRI_XYXY, **D.EVAL_KW)
    em, det = ev(state, batch, D.IMG_VALID)
    step = make_train_step(state.model, PRI, PRI_XYXY, iou_thresh=0.4, fused_stem=False)
    state, m = step(state, batch)
    return ({k: float(v) for k, v in m.items()}, {k: float(v) for k, v in em.items()},
            [t.numpy() for t in det], flatten(variables_from_torch(state.model)))


def test_two_rank_train_step_equals_one_process(ranks, one_process):
    variables, _, (r0, r1) = ranks
    m, _, _, after = one_process
    p0 = flatten(variables)
    for r in (r0, r1):
        for k, v in m.items():
            np.testing.assert_allclose(r["train_step"]["metrics"][k], v, rtol=1e-5, err_msg=k)
    got = r0["train_step"]["variables"]
    assert sorted(got) == sorted(after)
    checked = 0
    for k, ref in after.items():
        np.testing.assert_array_equal(got[k], r1["train_step"]["variables"][k], err_msg=k)
        layer = k.split("/")[2]
        if k.startswith("/batch_stats"):
            assert np.abs(got[k] - ref).max() <= 1e-4 * np.abs(ref).max(), k
        elif not (k.endswith("Conv_0/bias") and f"/params/{layer}/BatchNorm_0/scale" in after):
            du_ref, du_got = ref - p0[k], got[k] - p0[k]
            rel = np.linalg.norm(du_ref - du_got) / max(np.linalg.norm(du_ref), 1e-12)
            assert rel < 2e-2, (k, rel)
            checked += 1
    assert checked > 80


def test_two_rank_loss_equals_jax(ranks):
    variables, _, (r0, _) = ranks
    tx, _ = JS.build_optimizer(**D.OPT)
    jpri = jnp.asarray(JP.create_priors())
    jstep = JT.make_train_step(JaxSSD300(num_classes=6, width_mult=D.WM), tx, jpri,
                               jnp.asarray(JP.priors_xyxy(np.asarray(jpri))), iou_thresh=0.4,
                               fused_stem=False)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                           opt_state=tx.init(params))
    _, jm = jstep(jstate, JT.Batch(*(jnp.asarray(t) for t in D.train_arrays())))
    for k in ("loss", "loss_loc", "loss_conf"):
        np.testing.assert_allclose(r0["train_step"]["metrics"][k], float(jm[k]), rtol=1e-4,
                                   err_msg=k)


def test_two_rank_eval_step_equals_one_process(ranks, one_process):
    _, _, rs = ranks
    _, em, det, _ = one_process
    for r in rs:
        for k, v in em.items():
            np.testing.assert_allclose(r["train_step"]["eval_metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
    boxes, scores, labels, valid = (np.concatenate([r["train_step"]["det"][i] for r in rs])
                                    for i in range(4))
    assert valid.sum() > 0
    np.testing.assert_array_equal(valid, det[3])
    np.testing.assert_array_equal(labels[valid], det[2][valid])
    np.testing.assert_allclose(scores[valid], det[1][valid], rtol=0, atol=1e-5)
    np.testing.assert_allclose(boxes[valid], det[0][valid], rtol=0, atol=1e-2)


@pytest.mark.parametrize("train", [False, True])
def test_two_rank_loader_halves_make_the_global_batches(ranks, train):
    _, d, rs = ranks
    ds = DetectionDataset(d / "toy")
    ref = DetectionLoader(ds, D.GLOBAL_BATCH, train=train, device="cpu", **D.LOADER_KW)
    want = [D.loader_record(item) for item in ref]
    n = len(want)
    assert n == (17 // 8 if train else 3) == rs[0]["loader"][train]["len"]
    for r in rs:
        got = r["loader"][train]
        assert len(got["batches"]) == n
        assert got["decoded"] == n * D.GLOBAL_BATCH // 2  # its half and no more
    assert ref.stats["decoded"] == n * D.GLOBAL_BATCH
    for i, w in enumerate(want):
        halves = [r["loader"][train]["batches"][i] for r in rs]
        assert all(h["count"] == w["count"] for h in halves)  # the global count
        assert all(len(h["sums"]) == D.GLOBAL_BATCH // 2 for h in halves)
        for k in ("sums", "labels", "boxes", "valid"):
            both = np.concatenate([h[k] for h in halves])
            if k in ("labels", "valid"):
                np.testing.assert_array_equal(both, w[k], err_msg=k)
            else:  # the same per-image arithmetic on a batch of 4 and of 8
                np.testing.assert_allclose(both, w[k], rtol=1e-5, atol=1e-6, err_msg=k)
    if not train:
        assert want[-1]["count"] == 1  # 17 = 8 + 8 + 1


def test_epoch_order_equals_the_jax_loader(ranks):
    _, d, _ = ranks
    kw = dict(D.LOADER_KW, bootstrap=True)
    port = DetectionLoader(DetectionDataset(d / "toy"), 8, train=True, device="cpu", **kw)
    ref = JaxLoader(JaxDataset(d / "toy"), 8, train=True, **kw)
    for epoch in range(3):
        port._epoch = ref._epoch = epoch
        np.testing.assert_array_equal(port._epoch_indices(), ref._epoch_indices())
    assert [p.name for p in port.dataset.paths] == [p.name for p in ref.dataset.paths]


def test_two_rank_detector_equals_one_process(ranks):
    variables, _, rs = ranks
    single = Detector(D.CLASSES, variables=variables, width_mult=D.WM, device="cpu")
    loc8, cls8 = single.forward(D.images(8))
    loc5, cls5 = single.forward(D.images(5, seed=2))
    preds = single.predict(D.images(8, seed=1), score_thresh=0.1, nms_thresh=0.5)
    for r in rs:
        got = r["detector"]
        assert got["loc5"].shape == (5, 8732, 4) and got["cls5"].shape == (5, 8732, 6)
        for k, w in (("loc8", loc8), ("cls8", cls8), ("loc5", loc5), ("cls5", cls5)):
            np.testing.assert_allclose(got[k], w.numpy(), atol=2e-4, err_msg=k)
        assert len(got["preds"]) == 8
        for a, b in zip(preds, got["preds"]):
            np.testing.assert_array_equal(a["labels"], b["labels"])
            np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4)
            np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-2)
    for k in ("loc8", "loc5"):
        np.testing.assert_array_equal(rs[0]["detector"][k], rs[1]["detector"][k])


def test_loader_needs_a_mesh_and_a_batch_that_divides():
    class _FakeDS:
        def __len__(self):
            return 4

        def max_boxes_per_image(self):
            return 1

        def native_size(self):
            return (64, 64)

    kw = dict(train=False, source_size=64, max_boxes=1, device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        DetectionLoader(_FakeDS(), 7, process_count=2, process_index=0, mesh=object(), **kw)
    with pytest.raises(ValueError, match="requires a mesh"):
        DetectionLoader(_FakeDS(), 8, process_count=2, process_index=0, **kw)
